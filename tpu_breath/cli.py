"""CLI orchestration: precompute | train | predict | e2e.

The L4/L5 layers of the reference collapsed into one coherent entry point
(reference main.py:6-26 and src/scripts.py:8-70), with back-compat for the
reference's bare `python main.py [--precompute]` invocation. One path layout
serves both stages (fixing discrepancy D3).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

from tpu_breath.config import (FeatureSpec, Paths, TrainCfg, CNN8_TRAIN,
                               VGG_TRAIN, DEFAULT_FEATURES)
from tpu_breath.data import dataset as ds
from tpu_breath.data import wav as wav_io
from tpu_breath.utils import compile_cache, display


def _build_feature_store(paths: Paths, spec: FeatureSpec,
                         write_npz: bool = False,
                         chunk: int = 128,
                         scan: bool = False,
                         mesh=None, profile_dir: str | None = None
                         ) -> ds.FeatureStore:
    """wav -> batched device feature graph -> FeatureStore (train rows first,
    then test). With profile_dir, the extraction runs under a jax.profiler
    trace written there."""
    from tpu_breath.features import extract_features_batched

    train, test = ds.load_tables(paths)
    ids = train["ID"] + test["ID"]
    wav_paths = (
        [os.path.join(paths.train_audio_dir, ds.train_wav_name(i))
         for i in train["ID"]]
        + [os.path.join(paths.test_audio_dir, ds.test_wav_name(i))
           for i in test["ID"]])

    display.print_start(f"decoding {len(wav_paths)} wavs")
    t0 = time.time()
    errors: list = []
    wavs = wav_io.load_wav_batch(wav_paths, spec.expected_len, errors=errors)
    for path, msg in errors:
        display.print_error(f"{path}: {msg}")
    display.print_info(
        f"decoded in {time.time() - t0:.1f}s "
        f"({len(wav_paths) - len(errors)} ok, {len(errors)} failed)")

    display.print_start("extracting features on device")
    t0 = time.time()
    with _trace(profile_dir):
        feats, scals = extract_features_batched(wavs, spec, chunk=chunk,
                                                scan=scan, mesh=mesh)
    dt = time.time() - t0
    display.print_success(
        f"{len(ids)} clips in {dt:.1f}s ({len(ids) / dt:.1f} clips/s)")

    store = ds.FeatureStore(ids, feats, scals)
    import jax
    if jax.process_index() == 0:  # every process holds the full store;
        store.save_cache(paths.feature_cache)  # only one writes it
        if write_npz:
            display.print_start(
                f"writing npz parity files to {paths.precomputed_dir}")
            store.save_npz(paths.precomputed_dir, spec)
    return store


@contextlib.contextmanager
def _trace(profile_dir: str | None):
    """jax.profiler trace of the block into profile_dir (no-op without a
    directory). A profiler failure fails the run."""
    if not profile_dir:
        yield
        return
    import jax
    with jax.profiler.trace(profile_dir):
        yield
    display.print_success(f"profiler trace written to {profile_dir}")


def _load_or_build_store(paths: Paths, spec: FeatureSpec) -> ds.FeatureStore:
    if ds.FeatureStore.cache_exists(paths.feature_cache):
        display.print_info(f"feature cache hit: {paths.feature_cache}")
        return ds.FeatureStore.load_cache(paths.feature_cache, mmap=False)
    return _build_feature_store(paths, spec)


def cmd_precompute(args) -> None:
    paths = Paths(root=args.root, out_root=args.out_root)
    mesh = _resolve_mesh(getattr(args, "mesh", "off"))
    _build_feature_store(paths, DEFAULT_FEATURES, write_npz=args.npz,
                         chunk=args.chunk, scan=getattr(args, "scan", False),
                         mesh=mesh, profile_dir=getattr(args, "profile", None))


def _prepare_splits(paths: Paths, spec: FeatureSpec, npz_dir: str | None = None):
    train, test = ds.load_tables(paths)
    if npz_dir:
        # interop: consume a reference-produced per-clip .npz directory
        # (schema auto-discovery, src/dataset.py:17-31 semantics)
        display.print_info(f"loading reference-schema npz from {npz_dir}")
        store = ds.FeatureStore.load_npz(npz_dir, train["ID"] + test["ID"],
                                         spec)
    else:
        store = _load_or_build_store(paths, spec)
    tr_rows, va_rows = ds.split_train_val(train)
    tr = store.subset(tr_rows["ID"])
    va = store.subset(va_rows["ID"])
    te = store.subset(test["ID"])
    y_tr = ds.labels_from_targets(tr_rows["Target"])
    y_va = ds.labels_from_targets(va_rows["Target"])
    return tr, va, te, y_tr, y_va


def _train_one(arch: str, cfg: TrainCfg, tr, va, y_tr, y_va, paths: Paths,
               mesh=None, resume: bool = False, fused_wavs=None,
               f32: bool = False):
    from tpu_breath.models import registry
    from tpu_breath.train import loop

    kwargs = {}
    if f32:
        import jax.numpy as jnp
        kwargs["dtype"] = jnp.float32
    model = registry.build(arch, num_scalar_features=va.scalars.shape[1],
                           **kwargs)
    mode = "fused wav->train" if fused_wavs is not None else "cached features"
    display.print_start(f"training {arch} ({cfg.num_epochs} epochs, "
                        f"lr {cfg.base_lr}, batch {cfg.batch_size}, {mode})")
    save_dir = os.path.join(paths.ckpt_dir, arch)
    if fused_wavs is not None:
        train_store, fused_spec = (fused_wavs, None), DEFAULT_FEATURES
    else:
        train_store, fused_spec = (tr.features, tr.scalars), None
    result = loop.fit(model, train_store, (va.features, va.scalars),
                      y_tr, y_va, cfg, save_dir=save_dir, mesh=mesh,
                      resume=resume, fused_spec=fused_spec)
    display.print_success(f"{arch} best val acc {result.best_val_acc:.4f} "
                          f"@ {result.best_ckpt_path}")
    # persist history for observability (primary process only under multi-host)
    import jax
    if jax.process_index() == 0:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "history.jsonl"), "w") as f:
            for row in result.history:
                f.write(json.dumps(row) + "\n")
    return result


def _resolve_mesh(mesh_arg: str):
    """'auto' -> DP mesh over all devices when >1 (multi-host aware via
    jax.distributed), 'off'/'1' -> single-device resident path, an int N ->
    mesh over the first N devices."""
    if mesh_arg == "off":
        return None
    from tpu_breath.parallel import mesh as mesh_lib
    import jax
    mesh_lib.initialize_distributed()
    n = jax.device_count() if mesh_arg == "auto" else int(mesh_arg)
    if n <= 1:
        return None
    if n > jax.device_count():
        raise ValueError(f"--mesh {n} but only {jax.device_count()} devices")
    mesh = mesh_lib.make_mesh(jax.devices()[:n])
    display.print_info(f"data-parallel mesh: {n} devices "
                       f"({jax.process_count()} process(es))")
    return mesh


def cmd_train(args) -> None:
    paths = Paths(root=args.root, out_root=args.out_root)
    spec = DEFAULT_FEATURES
    mesh = _resolve_mesh(getattr(args, "mesh", "auto"))
    tr, va, te, y_tr, y_va = _prepare_splits(
        paths, spec, npz_dir=getattr(args, "from_npz", None))
    fused_wavs = None
    if getattr(args, "fused", False):
        display.print_info("fused mode: training directly from waveforms")
        wav_paths = [os.path.join(paths.train_audio_dir, ds.train_wav_name(i))
                     for i in tr.ids]
        fused_wavs = wav_io.load_wav_batch(wav_paths, spec.expected_len)
    archs = args.archs.split(",")
    cfgs = {"cnn8": CNN8_TRAIN, "vgg": VGG_TRAIN}
    results = {}
    with _trace(getattr(args, "profile", None)):
        for arch in archs:
            results[arch] = _train_one(
                arch, _train_cfg(cfgs.get(arch, TrainCfg()), args), tr, va,
                y_tr, y_va, paths, mesh=mesh, resume=args.resume,
                fused_wavs=fused_wavs, f32=getattr(args, "f32", False))
    if args.predict:
        _predict(results, te, paths)


def _train_cfg(cfg: TrainCfg, args) -> TrainCfg:
    """The architecture's config with the command line's overrides."""
    overrides = {}
    if args.epochs:
        overrides["num_epochs"] = args.epochs
    if getattr(args, "seed", None) is not None:
        overrides["seed"] = args.seed
    if getattr(args, "batch_size", None):
        overrides["batch_size"] = args.batch_size
        overrides["eval_batch_size"] = 2 * args.batch_size
    if getattr(args, "epoch_scan", False):
        overrides["epoch_scan"] = True
    return type(cfg)(**{**cfg.__dict__, **overrides}) if overrides else cfg


def _predict(results, te, paths: Paths) -> None:
    from tpu_breath import ensemble

    ckpts = [r.best_ckpt_path for r in results.values()]
    archs = list(results.keys())
    scores = [r.best_val_acc for r in results.values()]
    probs = ensemble.weighted_ensemble(ckpts, archs, scores, te.features,
                                       te.scalars, te.scalars.shape[1])
    out = os.path.join(paths.submission_dir, "submission.csv")
    table = ensemble.write_submission(te.ids, probs, out)
    display.print_success(f"submission written: {out}")
    for row in list(zip(*table.values()))[:10]:
        print(",".join(row))


def _load_ensemble_ckpts(paths: Paths, archs: list):
    from tpu_breath.train import checkpoint as ckpt_lib

    ckpts, scores = [], []
    for arch in archs:
        path = ckpt_lib.latest_checkpoint(os.path.join(paths.ckpt_dir, arch))
        if path is None:
            raise FileNotFoundError(f"no checkpoint for {arch}")
        meta = ckpt_lib.load_metadata(path)
        ckpts.append(path)
        scores.append(meta["val_acc"])
    return ckpts, scores


def cmd_predict(args) -> None:
    from tpu_breath import ensemble

    paths = Paths(root=args.root, out_root=args.out_root)
    spec = DEFAULT_FEATURES
    archs = args.archs.split(",")
    wav_files = getattr(args, "from_wav", None)
    if wav_files:
        # cache-free single-shot inference: wav file(s) -> one jitted
        # wav->features->ensemble graph -> label. Replaces the reference's
        # per-clip librosa loop + torch ensemble (src/precompute/process.py:25
        # + src/utils/ensemble.py:49) with one device graph.
        ckpts, scores = _load_ensemble_ckpts(paths, archs)
        errors: list = []
        wavs = wav_io.load_wav_batch(wav_files, spec.expected_len,
                                     errors=errors)
        for path, msg in errors:
            display.print_error(f"{path}: {msg}")
        probs = ensemble.serve_from_wav(ckpts, archs, scores, wavs, spec)
        for path, p in zip(wav_files, probs):
            label = "E" if p > 0.5 else "I"
            print(f"{path}\t{label}\t{p:.4f}")
        out = os.path.join(paths.submission_dir, "from_wav_predictions.csv")
        ensemble.write_submission(wav_files, probs, out)
        display.print_success(f"predictions written: {out}")
        return
    _, _, te, _, _ = _prepare_splits(
        paths, spec, npz_dir=getattr(args, "from_npz", None))
    ckpts, scores = _load_ensemble_ckpts(paths, archs)
    probs = ensemble.weighted_ensemble(ckpts, archs, scores, te.features,
                                       te.scalars, te.scalars.shape[1])
    out = os.path.join(paths.submission_dir, "submission.csv")
    ensemble.write_submission(te.ids, probs, out)
    display.print_success(f"submission written: {out}")


def cmd_e2e(args) -> None:
    args.predict = True
    cmd_train(args)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu_breath")
    # reference back-compat flag (main.py:8)
    p.add_argument("--precompute", action="store_true",
                   help="legacy flag: run the precompute stage")
    sub = p.add_subparsers(dest="cmd")

    def common(sp):
        sp.add_argument("--root", default="input")
        sp.add_argument("--out-root", dest="out_root", default=".")

    sp = sub.add_parser("precompute")
    common(sp)
    sp.add_argument("--npz", action="store_true",
                    help="also write reference-schema .npz files")
    sp.add_argument("--chunk", type=int, default=128)
    sp.add_argument("--profile", default=None, metavar="DIR",
                    help="write a jax.profiler trace of the extraction to DIR")
    sp.add_argument("--scan", action="store_true",
                    help="extract via ONE lax.scan dispatch over chunk "
                         "bodies (pays a per-dataset-geometry compile)")
    sp.add_argument("--mesh", default="off", metavar="auto|off|N",
                    help="data-parallel extraction: shard each dispatch's "
                         "batch over a device mesh (mesh.size x chunk clips "
                         "per dispatch, zero collectives)")
    sp.set_defaults(fn=cmd_precompute)

    for name, fn in (("train", cmd_train), ("e2e", cmd_e2e)):
        sp = sub.add_parser(name)
        common(sp)
        sp.add_argument("--archs", default="cnn8,vgg")
        sp.add_argument("--epochs", type=int, default=0,
                        help="override epoch count (smoke runs)")
        sp.add_argument("--predict", action="store_true")
        sp.add_argument("--resume", action="store_true")
        sp.add_argument("--fused", action="store_true",
                        help="train directly from waveforms: the feature "
                             "graph runs inside the jitted train step")
        sp.add_argument("--profile", default=None, metavar="DIR",
                        help="write a jax.profiler trace of the run to DIR")
        sp.add_argument("--seed", type=int, default=None,
                        help="PRNG seed override (init/augment/shuffle)")
        sp.add_argument("--batch-size", dest="batch_size", type=int,
                        default=0, help="override the train batch size "
                                        "(eval batch follows at 2x)")
        sp.add_argument("--f32", action="store_true",
                        help="float32 activations instead of bfloat16 "
                             "(debugging / bit-level layout comparisons)")
        sp.add_argument("--epoch-scan", dest="epoch_scan",
                        action="store_true",
                        help="run each epoch as ONE lax.scan dispatch "
                             "instead of per-step async dispatch")
        sp.add_argument("--mesh", default="auto", metavar="auto|off|N",
                        help="data-parallel mesh: 'auto' uses all devices "
                             "when >1 (host-sharded streamed input), 'off' "
                             "forces the single-device resident path, N "
                             "uses the first N devices")
        sp.add_argument("--from-npz", dest="from_npz", default=None,
                        metavar="DIR",
                        help="consume a reference-produced per-clip .npz "
                             "feature directory instead of the device "
                             "feature graph")
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("predict")
    common(sp)
    sp.add_argument("--archs", default="cnn8,vgg")
    sp.add_argument("--from-npz", dest="from_npz", default=None, metavar="DIR")
    sp.add_argument("--from-wav", dest="from_wav", nargs="+", default=None,
                    metavar="FILE",
                    help="classify wav file(s) directly — no feature cache: "
                         "one jitted wav->features->ensemble graph")
    sp.set_defaults(fn=cmd_predict)
    return p


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    compile_cache.configure()
    if args.cmd is None:
        # reference behavior: bare run = train+predict; --precompute flag
        ns = argparse.Namespace(root="input", out_root=".", npz=False,
                                chunk=128, archs="cnn8,vgg", epochs=0,
                                predict=True, resume=False, mesh="auto")
        if args.precompute:
            cmd_precompute(ns)
        else:
            cmd_train(ns)
        return
    args.fn(args)
