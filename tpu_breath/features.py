"""The batched wav -> (9-channel spectrogram stack, scalar vector) graph.

This is the batched replacement for the reference's per-file librosa worker
(reference src/precompute/process.py:25-108): instead of 5,000 sequential
per-clip python calls, a whole shard of waveforms flows through one jitted
XLA graph of batched matmul-DFTs, filterbank products and scans, producing the
exact npz feature schema (channel recipes, z-scoring and min-value padding
semantics included).

Channel order at the model boundary is alphabetical, matching the reference
Dataset's sorted-key stacking (src/dataset.py:24-26):
chroma, gammatone, lpc, mel, mel_delta, mel_delta2, mfcc, mod_spec, tempogram.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from tpu_breath.config import FeatureSpec, DEFAULT_FEATURES
from tpu_breath.ops import spectral, cepstral, chroma as chroma_ops
from tpu_breath.ops import cqt as cqt_ops
from tpu_breath.ops import lpc as lpc_ops
from tpu_breath.ops import dd as dd_ops
from tpu_breath.ops import rhythm, scalars as scalar_ops


def _zn(x):
    return spectral.znorm(x, axes=(-2, -1))


def _zn_rows(x):
    return spectral.znorm(x, axes=(-1,))


def _pads(x, spec: FeatureSpec):
    return spectral.pad_freq_min(spectral.pad_time_min(x, spec.t_fixed),
                                 spec.n_mels)


def extract_features(y: jax.Array,
                     spec: FeatureSpec = DEFAULT_FEATURES
                     ) -> tuple[jax.Array, jax.Array]:
    """y[..., 16000] float32 -> (features[..., 9, 128, 63], scalars[..., 36]).

    Jit-friendly; vmap/shard over the leading batch axes as needed.
    """
    sr, hop, n_fft = spec.sr, spec.hop_length, spec.n_fft

    # --- mel + deltas (reference process.py:32-41)
    mel_spec = spectral.melspectrogram(y, sr, n_fft=n_fft, hop_length=hop,
                                       n_mels=spec.n_mels, fmax=spec.fmax)
    mel_db = spectral.power_to_db(mel_spec, ref_max=True)
    mel_d1 = cepstral.delta(mel_db, order=1)
    mel_d2 = cepstral.delta(mel_db, order=2)
    mel_c = _pads(_zn(mel_db), spec)
    d1_c = _pads(_zn(mel_d1), spec)
    d2_c = _pads(_zn(mel_d2), spec)

    # --- mfcc stack (process.py:43-49): 40 + delta + delta2 = 120 rows,
    # per-row z-score, min-padded 120 -> 128
    mf = cepstral.mfcc(y, sr, spec.n_mfcc, hop, n_fft)
    mf_all = jnp.concatenate(
        [mf, cepstral.delta(mf, order=1), cepstral.delta(mf, order=2)], axis=-2)
    mfcc_c = _pads(_zn_rows(mf_all), spec)

    # --- shared 2048-point spectrograms: the onset-strength mel, the scalar
    # descriptors' mel/|STFT|, and the CENS tuning estimate all reuse the
    # same transforms — compute once
    re2, im2 = spectral.stft_ri(y, 2048, hop)  # [..., T, F] time-major
    p2048 = re2 * re2 + im2 * im2
    stft2048_mag = jnp.sqrt(p2048).swapaxes(-1, -2)
    fb2048 = jnp.asarray(spectral.mel_matrix(sr, 2048, spec.n_mels))
    mel2048_power = jnp.matmul(p2048, fb2048.T,
                               precision=spectral.MM_PRECISION
                               ).swapaxes(-1, -2)

    # --- chroma_stft + chroma_cens stack (process.py:51-57)
    # Round-once-from-quasi-f64 |STFT|: the chroma tuning estimate's near-tied
    # histogram argmax flips on single-ulp |S| noise (PARITY.md, flip_hunt),
    # so this S matches the oracle's f32(|STFT_f64|) to ~1e-7 absolute. It
    # also feeds the gammatone filterbank and the scalar descriptors below —
    # one dd DFT replaces both the plain f32 512-DFT and the gammatone's
    # separate dd pass.
    stft512 = spectral.stft_mag_cr(y, n_fft, hop)
    ch = chroma_ops.chroma_stft(stft512, sr)
    cens = cqt_ops.chroma_cens(y, sr, hop, spec.cqt_fmin,
                               bins_per_octave=spec.cqt_bins_per_octave,
                               n_octaves=spec.cqt_n_octaves,
                               win_len_smooth=spec.cens_win_len_smooth,
                               stft2048_mag=stft2048_mag)
    chroma_all = jnp.concatenate([ch, cens], axis=-2)
    chroma_c = _pads(_zn_rows(chroma_all), spec)

    # --- "gammatone" = 64-band mel filterbank on |STFT| + log1p
    # (methods.py:136-140; discrepancy D9). This channel's z-score divides by
    # a std of ~0.005 on quiet clips, amplifying rounding ~200x past the 1e-3
    # parity budget, so every stage runs at double-float accuracy: the DFT
    # and filterbank product through the compensated GEMM (ops/dd.matmul_dd)
    # and log1p through dd.log1p_cr (a native f32 log1p ~100 ulp off was the
    # dominant term: 2.3e-5 pre-norm -> 5.5e-3 post-norm).
    gt_fb = jnp.asarray(spectral.mel_matrix(sr, n_fft, spec.n_gammatone))
    with jax.named_scope("gammatone_dd"):
        gt = dd_ops.log1p_cr(dd_ops.matmul_dd(stft512.swapaxes(-1, -2),
                                              gt_fb.T).swapaxes(-1, -2))
    gt_c = _pads(_zn(gt), spec)

    # --- Burg LPC (methods.py:116-134): [12, 98], z-normed then truncated
    lpc = lpc_ops.lpc_features(y, spec.n_lpc, sr)
    lpc_c = _pads(_zn(lpc), spec)

    # --- 2-D DCT modulation spectrum (methods.py:142-143)
    mod = cepstral.mod_spec(mel_db, n_keep=40)
    mod_c = _pads(_zn(mod), spec)

    # --- tempogram (process.py:74-78): [384, 63], z-normed, truncated to 128
    onset = rhythm.onset_strength(y, sr, hop, mel_power=mel2048_power)
    tempo = rhythm.tempogram(onset, spec.tempogram_win_length)
    tempo_c = _pads(_zn(tempo), spec)

    # --- scalars (methods.py:48-114), reusing the shared spectrograms
    scalars = scalar_ops.extract_scalars(y, sr, hop, n_fft, spec.n_mels,
                                         stft512_mag=stft512,
                                         stft2048_mag=stft2048_mag,
                                         mel2048_power=mel2048_power)

    # alphabetical stacking (reference src/dataset.py:24-26)
    by_name = {
        "mel": mel_c, "mfcc": mfcc_c, "chroma": chroma_c,
        "mel_delta": d1_c, "mel_delta2": d2_c, "gammatone": gt_c,
        "lpc": lpc_c, "mod_spec": mod_c, "tempogram": tempo_c,
    }
    feats = jnp.stack([by_name[k] for k in spec.channel_order], axis=-3)
    return feats, scalars


_extract_jit = jax.jit(extract_features, static_argnums=(1,))


@functools.partial(jax.jit, static_argnums=(1,))
def _extract_scan_jit(wav_chunks, spec):
    """wav_chunks[C, chunk, L] -> ([C, chunk, ...], [C, chunk, S]) in ONE
    dispatch: lax.scan compiles the chunk body once and iterates it on
    device, so the per-chunk launch overhead is paid once per dataset
    instead of once per chunk."""
    def body(carry, x):
        return carry, extract_features(x, spec)

    _, out = jax.lax.scan(body, None, wav_chunks)
    return out


def _chunked(wavs: np.ndarray, chunk: int) -> tuple[np.ndarray, int]:
    """Pad to a whole number of chunks (single compiled shape)."""
    n = wavs.shape[0]
    n_chunks = -(-n // chunk)
    if n_chunks * chunk != n:
        wavs = np.pad(wavs, ((0, n_chunks * chunk - n), (0, 0)))
    return wavs.reshape(n_chunks, chunk, wavs.shape[-1]), n_chunks


def extract_features_batched(wavs: np.ndarray,
                             spec: FeatureSpec = DEFAULT_FEATURES,
                             chunk: int = 128,
                             scan: bool | None = None,
                             mesh=None
                             ) -> tuple[np.ndarray, np.ndarray]:
    """Host convenience: run the jitted graph over a large array of clips in
    device-sized chunks (the CQT frame expansion is ~6.3 MB/clip, so chunking
    bounds peak device memory). Returns numpy (features, scalars).

    scan=True iterates the chunk body with lax.scan inside one jit (one
    device dispatch for the whole dataset); scan=False (the default)
    dispatches one jit call per chunk, asynchronously. The layouts are
    numerically identical (tests/test_batched_extract.py); the dispatch
    layout stays the default because per-chunk dispatch overhead is already
    amortized by async dispatch with one final sync, while the scan layout
    pays a fresh whole-dataset compile per batch geometry.

    mesh: a 1-D jax.sharding.Mesh data-parallelizes extraction — each
    dispatch covers mesh.size * chunk clips with the batch axis sharded over
    the mesh's data axis. Extraction is per-clip math (every reduction is
    over a clip's own axes), so XLA partitions the graph with ZERO
    collectives. Feature channels are bit-identical to mesh=None; the scalar
    descriptors can differ by ~1 ulp because the partitioned module may fuse
    their long clip-axis reductions differently
    (tests/test_batched_extract.py). This is the scaling story for the
    reference's precompute stage (SURVEY.md §5: the analogue of scaling
    sequence length here is scaling the batched feature graph across the
    mesh; reference hot loop src/precompute/process.py:25-108)."""
    n = wavs.shape[0]
    if scan is None:
        scan = False
    if mesh is not None:
        if scan:
            raise ValueError("scan=True with mesh is unsupported — the scan "
                             "layout's win is per-dispatch overhead, which "
                             "the mesh path already amortizes over "
                             "mesh.size chunks per dispatch")
        return _extract_sharded(wavs, spec, chunk, mesh)
    if scan:
        wav_chunks, _ = _chunked(wavs, chunk)
        f, s = _extract_scan_jit(jnp.asarray(wav_chunks), spec)
        feats_out = np.asarray(f).reshape(-1, *f.shape[2:])[:n]
        scal_out = np.asarray(s).reshape(-1, s.shape[-1])[:n]
        return feats_out, scal_out
    feats_out = np.empty((n, spec.n_channels, spec.n_mels, spec.t_fixed),
                         np.float32)
    scal_out = np.empty((n, spec.n_scalars), np.float32)
    # dispatch every chunk asynchronously; materialize on host at the end
    pending = []
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        x = wavs[lo:hi]
        if hi - lo < chunk:  # keep a single compiled shape
            x = np.pad(x, ((0, chunk - (hi - lo)), (0, 0)))
        pending.append((lo, hi, _extract_jit(jnp.asarray(x), spec)))
    from tpu_breath.utils import display
    for lo, hi, (f, s) in display.progress_bar(pending, "extract"):
        feats_out[lo:hi] = np.asarray(f)[: hi - lo]
        scal_out[lo:hi] = np.asarray(s)[: hi - lo]
    return feats_out, scal_out


def _extract_sharded(wavs: np.ndarray, spec: FeatureSpec, chunk: int,
                     mesh) -> tuple[np.ndarray, np.ndarray]:
    """Data-parallel extraction over a device mesh: per dispatch, a
    [mesh.size * chunk, 16000] super-chunk is placed batch-sharded and the
    jitted graph partitions onto every device (see extract_features_batched).

    Multi-process runs: every host decodes the full dataset (decode is ~2 s
    for 5,000 clips), each contributes only the contiguous row block its
    addressable devices own via jax.make_array_from_process_local_data (the
    same host-sharded input path the streaming trainer uses, data/loader.py),
    and results are re-materialized on every host with
    multihost_utils.process_allgather so all processes return the full
    feature arrays (tests/test_multiprocess.py runs this branch for real)."""
    import jax
    from tpu_breath.parallel import mesh as mesh_lib

    sharding = mesh_lib.data_sharding(mesh)
    fn = jax.jit(lambda y: extract_features(y, spec),
                 in_shardings=sharding, out_shardings=(sharding, sharding))

    n = wavs.shape[0]
    super_chunk = chunk * mesh.size
    pcount = jax.process_count()
    if pcount > 1 and mesh.size % pcount:
        raise ValueError(f"mesh size {mesh.size} must be a multiple of the "
                         f"process count {pcount}")

    def _place(x: np.ndarray):
        if pcount > 1:
            # jax.devices() orders devices process-contiguously, so process p
            # owns the p-th contiguous row block of the batch-sharded array;
            # make_array_from_process_local_data validates the layout.
            rpp = super_chunk // pcount
            pidx = jax.process_index()
            return jax.make_array_from_process_local_data(
                sharding, np.ascontiguousarray(x[pidx * rpp:(pidx + 1) * rpp]),
                x.shape)
        return jax.device_put(x, sharding)

    def _fetch(a) -> np.ndarray:
        if pcount > 1:
            from jax.experimental import multihost_utils
            return np.asarray(multihost_utils.process_allgather(a, tiled=True))
        return np.asarray(a)

    feats_out = np.empty((n, spec.n_channels, spec.n_mels, spec.t_fixed),
                         np.float32)
    scal_out = np.empty((n, spec.n_scalars), np.float32)
    pending = []
    for lo in range(0, n, super_chunk):
        hi = min(lo + super_chunk, n)
        x = wavs[lo:hi]
        if hi - lo < super_chunk:  # keep one compiled (per-device) shape
            x = np.pad(x, ((0, super_chunk - (hi - lo)), (0, 0)))
        pending.append((lo, hi, fn(_place(x))))
    from tpu_breath.utils import display
    for lo, hi, (f, s) in display.progress_bar(pending, "extract[mesh]"):
        feats_out[lo:hi] = _fetch(f)[: hi - lo]
        scal_out[lo:hi] = _fetch(s)[: hi - lo]
    return feats_out, scal_out
