"""Frozen configuration for the breathing-phase framework.

The reference scatters its constants across modules (see
reference src/precompute/core.py:9-17, src/precompute/process.py:12-23,
src/precompute/methods.py:10-22 and train_model kwargs in src/train.py:14-34).
Here everything lives in frozen dataclasses so the feature spec, model spec and
training spec cannot drift apart (fixes discrepancies D2/D3/D5 of SURVEY.md §2.5).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """The 9-channel spectrogram stack + scalar descriptor schema.

    Mirrors reference src/precompute/process.py:12-23 (constants) and
    src/precompute/process.py:93-103 (the .npz schema contract).
    """

    sr: int = 16_000
    duration: float = 1.0
    n_mels: int = 128
    n_mfcc: int = 40
    hop_length: int = 256
    n_fft: int = 512
    fmax: float = 4500.0
    n_gammatone: int = 64
    n_lpc: int = 12
    # CQT / CENS parameters (librosa chroma_cens defaults; reference
    # src/precompute/process.py:53 calls chroma_cens with its defaults).
    cqt_bins_per_octave: int = 36
    cqt_n_octaves: int = 7
    cqt_fmin: float = 32.703195662574764  # note C1
    cens_win_len_smooth: int = 41
    # Tempogram (librosa defaults; reference src/precompute/process.py:74-78).
    tempogram_win_length: int = 384

    @property
    def expected_len(self) -> int:
        return int(self.sr * self.duration)

    @property
    def t_fixed(self) -> int:
        """Number of STFT frames: reference src/precompute/process.py:30."""
        return self.expected_len // self.hop_length + 1

    @property
    def n_cqt_bins(self) -> int:
        return self.cqt_bins_per_octave * self.cqt_n_octaves

    # Channel names in the on-disk npz schema, and the alphabetical order the
    # Dataset stacks them in (reference src/dataset.py:24-26 sorts keys).
    npz_keys: Tuple[str, ...] = (
        "mel", "mfcc", "chroma", "mel_delta", "mel_delta2",
        "gammatone", "lpc", "mod_spec", "tempogram",
    )

    @property
    def channel_order(self) -> Tuple[str, ...]:
        return tuple(sorted(self.npz_keys))

    @property
    def n_channels(self) -> int:
        return len(self.npz_keys)

    # True scalar dimensionality produced by the descriptor extractor. The
    # reference *computes* 36 scalars (src/precompute/methods.py:48-114) but
    # *declares* 39 in its model defaults (src/model.py:6) — discrepancy D2.
    # We derive the dim from the extractor, never hardcode it at model level.
    n_scalars: int = 36


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    """Architecture selection + hyperparameters (reference src/model.py:5-202)."""

    arch: str = "cnn8"  # {"cnn8", "vgg"}
    in_channels: int = 9
    num_scalar_features: int = 36
    dropout_rate: float = 0.3  # CNN8 default; VGG uses 0.2 (src/model.py:93)
    # bf16 activations with f32 params/stats are the analogue of the
    # reference's CUDA AMP (src/train.py:53,92).
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    """Training hyperparameters (reference src/train.py:14-34, src/scripts.py:19-46)."""

    num_epochs: int = 30
    base_lr: float = 1e-3
    weight_decay: float = 1e-4
    batch_size: int = 512
    eval_batch_size: int = 1024
    patience: int = 15
    min_delta: float = 1e-4
    monitor: str = "val_acc"
    restore_best_weights: bool = True
    use_cutmix: bool = True
    use_mixup: bool = True
    cutmix_prob: float = 0.5
    mixup_prob: float = 0.5
    cutmix_alpha: float = 1.0
    mixup_alpha: float = 0.2
    warmup_epochs: int = 5
    grad_clip_norm: float = 1.0
    # warmup fraction of total steps for the LR schedule (src/train.py:42)
    warmup_frac: float = 0.05
    lr_start_factor: float = 0.1
    lr_eta_min: float = 1e-6
    seed: int = 0
    # Evaluate the full val split by default. The reference silently drops the
    # val tail via drop_last=True (discrepancy D7, src/utils/dataloaders.py:42);
    # set True to reproduce that exact behavior.
    parity_drop_last_eval: bool = False
    # Run each epoch's train steps as ONE lax.scan dispatch instead of
    # per-step async dispatch (loop.make_epoch_runner). Step semantics are
    # identical; choose by measured wall time on the target backend.
    epoch_scan: bool = False


# Orchestrator-level hyperparameters for the two flagship models, matching
# reference src/scripts.py:19-34 (CNN8) and src/scripts.py:38-46 (VGG —
# which deliberately falls back to train_model defaults; discrepancy D5).
CNN8_TRAIN = TrainCfg(
    num_epochs=100, base_lr=4e-4, patience=25,
    cutmix_prob=0.6, mixup_prob=0.4, warmup_epochs=4,
)
VGG_TRAIN = TrainCfg(num_epochs=140, patience=55)


@dataclasses.dataclass(frozen=True)
class Paths:
    """One coherent path layout. The reference's precompute writes
    input/precomputed/ while training reads ./data/precomputed_features
    (discrepancy D3, src/precompute/core.py:13-17 vs src/scripts.py:10-12);
    here a single root governs both stages.
    """

    root: str = "input"
    out_root: str = "."

    @property
    def train_csv(self) -> str:
        return os.path.join(self.root, "train.csv")

    @property
    def test_csv(self) -> str:
        return os.path.join(self.root, "test.csv")

    @property
    def train_audio_dir(self) -> str:
        return os.path.join(self.root, "train")

    @property
    def test_audio_dir(self) -> str:
        return os.path.join(self.root, "test")

    @property
    def precomputed_dir(self) -> str:
        return os.path.join(self.root, "precomputed")

    @property
    def feature_cache(self) -> str:
        """Flat binary feature cache (fast path; supplements npz parity mode)."""
        return os.path.join(self.root, "feature_cache")

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.out_root, "checkpoints")

    @property
    def submission_dir(self) -> str:
        return os.path.join(self.out_root, "submissions")


DEFAULT_FEATURES = FeatureSpec()

# Version stamp for the numeric output of the feature stack. The flat feature
# cache (data/dataset.py FeatureStore) records this at save time and a
# mismatch invalidates the cache, so a cache written before a numeric change
# can never be silently mixed with post-change fused training (the
# fused-vs-cached desync class fixed in round 4 by ops/scalars.py
# _row_sum_stable). Bump on ANY commit that changes extract_features output.
FEATURE_NUMERIC_VERSION = "r4-row-sum-stable-1"
