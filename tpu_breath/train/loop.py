"""The jitted training engine: AdamW + warmup-cosine + grad clipping + BCE,
on-device CutMix/MixUp, early stopping on val accuracy, best-checkpoint
selection — the JAX rebuild of reference src/train.py:14-173.

Key design differences from the reference (all deliberate):
- The whole feature set lives on device; a step is a gather by index, so
  there are no DataLoader workers or H2D copies in the epoch loop
  (vs src/train.py:69-70).
- The step (augment -> forward -> loss -> backward -> clip -> AdamW -> LR) is
  ONE donated jit graph; epoch boundaries and early stopping are the only
  host-side control flow.
- PRNG is keyed and explicit (vs the reference's global np.random /
  torch.randperm), so runs are reproducible and data-parallel safe.
- bf16 activations + f32 params/stats replace CUDA AMP; no GradScaler is
  needed because bf16 keeps f32's exponent range (vs src/train.py:53,96-100).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
import optax

from tpu_breath.config import TrainCfg
from tpu_breath.augment import Batch, apply_augmentation
from tpu_breath.train.schedule import warmup_cosine
from tpu_breath.train import metrics as metrics_mod
from tpu_breath.parallel import mesh as mesh_lib


class TrainState(NamedTuple):
    params: Any
    batch_stats: Any
    opt_state: Any
    step: jax.Array


@dataclasses.dataclass
class FitResult:
    best_val_acc: float
    best_ckpt_path: str | None
    best_state: TrainState
    history: list[dict]


def bce_with_logits(logits: jax.Array, labels: jax.Array) -> jax.Array:
    """Mean binary cross-entropy on logits (torch BCEWithLogitsLoss)."""
    z, y = logits.astype(jnp.float32), labels.astype(jnp.float32)
    return jnp.mean(jnp.maximum(z, 0) - z * y + jnp.log1p(jnp.exp(-jnp.abs(z))))


def create_state(model, rng, cfg: TrainCfg, steps_per_epoch: int
                 ) -> tuple[TrainState, optax.GradientTransformation, Callable]:
    variables = model.init(rng)
    schedule = warmup_cosine(cfg.base_lr, steps_per_epoch * cfg.num_epochs,
                             cfg.warmup_frac, cfg.lr_start_factor,
                             cfg.lr_eta_min)
    tx = optax.chain(
        optax.clip_by_global_norm(cfg.grad_clip_norm),
        optax.adamw(schedule, b1=0.9, b2=0.999, eps=1e-8,
                    weight_decay=cfg.weight_decay),
    )
    params = variables["params"]
    state = TrainState(params=params,
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    return state, tx, schedule


def make_train_step(model, tx, cfg: TrainCfg, mesh=None, fused_spec=None,
                    fused_chunk: int = 128):
    """Returns jitted step(state, data, idx, key, use_aug) -> (state, stats).
    `data` is the full on-device dataset tuple; `idx` the batch indices.

    fused_spec: when a FeatureSpec is given, the step consumes raw waveforms
    instead of precomputed features — wav[idx] -> feature graph -> augment ->
    forward/backward runs as ONE jitted graph with no host npz round-trip
    (BASELINE.json config #5). The feature sub-graph is lax.map'ed over
    fused_chunk-sized slices to bound the CQT frame expansion's working set.
    """
    return jax.jit(_make_step_core(model, tx, cfg, mesh, fused_spec,
                                   fused_chunk), donate_argnums=(0,))


def make_epoch_runner(model, tx, cfg: TrainCfg, mesh=None, fused_spec=None,
                      fused_chunk: int = 128):
    """One jitted lax.scan over ALL of an epoch's steps, so an epoch is a
    single dispatch: runner(state, feats, scals, labels, idx[S, B], keys[S],
    use_aug) -> (state, {loss[S], acc[S]}). Semantics are identical to S
    calls of the single step (same per-step PRNG keys, same LR schedule
    stepping).

    Not the default: fit() dispatches steps asynchronously and syncs once
    per epoch, which hides dispatch latency without this graph. XLA:CPU's
    compile of a scanned full-size conv training step is pathological
    (>10 min vs 15 s unscanned)."""
    core = _make_step_core(model, tx, cfg, mesh, fused_spec, fused_chunk)

    def epoch_fn(state, feats, scals, labels, idx_mat, keys, use_aug):
        def body(st, x):
            idx, key = x
            st, stats = core(st, feats, scals, labels, idx, key, use_aug)
            return st, stats

        return lax.scan(body, state, (idx_mat, keys))

    return jax.jit(epoch_fn, donate_argnums=(0,))


def make_train_step_batched(model, tx, cfg: TrainCfg, mesh=None,
                            fused_spec=None, fused_chunk: int = 128):
    """Step that consumes the batch arrays directly (the streamed-input path:
    host -> device_put with batch sharding -> step), vs make_train_step's
    gather-by-index from a resident dataset. Semantics are identical."""
    return jax.jit(_make_batch_core(model, tx, cfg, mesh, fused_spec,
                                    fused_chunk), donate_argnums=(0,))


def _maybe_fused_features(batch: Batch, fused_spec, fused_chunk: int) -> Batch:
    """In fused mode batch.features carries raw waveforms; run the feature
    graph (chunked to bound the CQT frame expansion's working set)."""
    if fused_spec is None:
        return batch
    from tpu_breath.features import extract_features
    wav_batch = batch.features
    b = wav_batch.shape[0]
    if b > fused_chunk and b % fused_chunk == 0:
        chunks = wav_batch.reshape(b // fused_chunk, fused_chunk, -1)
        f, s = jax.lax.map(lambda w: extract_features(w, fused_spec), chunks)
        bf, bs = f.reshape(b, *f.shape[2:]), s.reshape(b, *s.shape[2:])
    else:
        bf, bs = extract_features(wav_batch, fused_spec)
    return Batch(bf, bs, batch.labels)


def _make_step_core(model, tx, cfg: TrainCfg, mesh=None, fused_spec=None,
                    fused_chunk: int = 128):
    core = _make_batch_core(model, tx, cfg, mesh, fused_spec, fused_chunk)

    def step_fn(state: TrainState, feats, scals, labels, idx, key, use_aug):
        if fused_spec is not None:
            batch = Batch(feats[idx], None, labels[idx])
        else:
            batch = Batch(feats[idx], scals[idx], labels[idx])
        return core(state, batch, key, use_aug)

    return step_fn


def _make_batch_core(model, tx, cfg: TrainCfg, mesh=None, fused_spec=None,
                     fused_chunk: int = 128):

    def step_fn(state: TrainState, batch: Batch, key, use_aug):
        batch = _maybe_fused_features(batch, fused_spec, fused_chunk)
        if mesh is not None:
            batch = mesh_lib.shard_batch(batch, mesh)
        original_labels = batch.labels
        kaug, kdrop = jax.random.split(key)
        batch = apply_augmentation(kaug, batch, use_aug,
                                   cfg.cutmix_prob, cfg.mixup_prob,
                                   cfg.cutmix_alpha, cfg.mixup_alpha)

        def loss_fn(params):
            out, stats = model.apply(
                {"params": params, "batch_stats": state.batch_stats},
                batch.features, batch.scalars, train=True, key=kdrop)
            return bce_with_logits(out, batch.labels), (out, stats)

        (loss, (logits, batch_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        new_state = TrainState(params=params, batch_stats=batch_stats,
                               opt_state=opt_state, step=state.step + 1)
        # train accuracy vs ORIGINAL labels, reference src/train.py:103-111
        preds = (logits > 0.0).astype(jnp.float32)
        acc = jnp.mean(preds == original_labels)
        return new_state, {"loss": loss, "acc": acc}

    return step_fn


def make_eval_step(model, mesh=None):
    def eval_fn(state: TrainState, feats, scals, idx):
        batch_f, batch_s = feats[idx], scals[idx]
        if mesh is not None:
            sh = mesh_lib.data_sharding(mesh)
            batch_f = jax.lax.with_sharding_constraint(batch_f, sh)
            batch_s = jax.lax.with_sharding_constraint(batch_s, sh)
        logits, _ = model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            batch_f, batch_s)
        return logits.astype(jnp.float32)

    if mesh is not None:
        # replicate the logits so every process can materialize them on host
        # (a batch-sharded output is not addressable cross-process)
        return jax.jit(eval_fn, out_shardings=mesh_lib.replicated(mesh))
    return jax.jit(eval_fn)


def evaluate(eval_step, state, feats, scals, labels_np: np.ndarray,
             batch_size: int, drop_last: bool = False) -> dict:
    n = len(labels_np)
    n_use = (n // batch_size) * batch_size if drop_last else n
    logits_all = np.empty(n_use, np.float32)
    for lo in range(0, n_use, batch_size):
        hi = min(lo + batch_size, n_use)
        idx = np.arange(lo, hi)
        if hi - lo < batch_size:  # pad to keep one compiled shape
            idx = np.concatenate([idx, np.full(batch_size - (hi - lo), hi - 1)])
        out = np.asarray(eval_step(state, feats, scals, jnp.asarray(idx)))
        logits_all[lo:hi] = out[: hi - lo]
    labels = labels_np[:n_use]
    probs = 1.0 / (1.0 + np.exp(-logits_all))
    loss = float(np.mean(np.maximum(logits_all, 0) - logits_all * labels
                         + np.log1p(np.exp(-np.abs(logits_all)))))
    m = metrics_mod.binary_metrics(probs, labels)
    m["loss"] = loss
    # probability range, mirrored from reference print_validation_accuracy
    # (src/utils/display.py:13-15)
    m["prob_min"] = float(probs.min()) if n_use else 0.0
    m["prob_max"] = float(probs.max()) if n_use else 0.0
    return m


def fit(model, train_store, val_store, train_labels, val_labels,
        cfg: TrainCfg, save_dir: str | None = None, mesh=None,
        log_fn=print, resume: bool = False, fused_spec=None) -> FitResult:
    """Full training run with early stopping and best-checkpoint persistence.

    train_store/val_store: (features [N,C,H,W], scalars [N,S]) numpy arrays.
    fused mode (fused_spec set): train_store is (wavs [N,16000], None) and the
    feature graph runs inside the train step; val_store stays precomputed.
    """
    from tpu_breath.train import checkpoint as ckpt_lib

    rng = jax.random.PRNGKey(cfg.seed)
    n_train = len(train_labels)
    steps_per_epoch = n_train // cfg.batch_size  # drop_last, src/dataloaders.py:30
    if steps_per_epoch == 0:
        raise ValueError("batch_size larger than the training split")

    # Input layout: single-device keeps the whole dataset resident on device
    # and a step gathers by index (no per-step host-to-device copy). Under a
    # mesh, input is HOST-resident and streamed: each process holds only its
    # example shard (loader.host_shard) and prefetched batches are device_put
    # with the mesh's batch sharding (loader.stream_batches) — on a pod no
    # host ever materializes the full dataset. With one process the batch
    # schedule is identical to the resident path (same permutation source),
    # so histories match across layouts (mod f32 reduction order).
    streaming = mesh is not None
    if streaming:
        from tpu_breath.data import loader as loader_mod
        n_proc = jax.process_count()
        if cfg.batch_size % mesh.size:
            raise ValueError(
                f"batch_size ({cfg.batch_size}) must be a multiple of the "
                f"mesh size ({mesh.size})")
        if cfg.batch_size % n_proc:
            raise ValueError(
                f"batch_size ({cfg.batch_size}) must be a multiple of the "
                f"process count ({n_proc})")
        shard = loader_mod.host_shard(n_train)
        feats_host = np.asarray(train_store[0])[shard]
        scals_host = (np.zeros((len(feats_host), 0), np.float32)
                      if fused_spec is not None
                      else np.asarray(train_store[1])[shard])
        labels_host = np.asarray(train_labels, np.float32)[shard]
        local_batch = cfg.batch_size // n_proc
        # Every process must execute the SAME number of collective steps or
        # the SPMD program desyncs: host_shard's ceil split gives the last
        # process the smallest shard, so the step count is the global
        # minimum, and stream_batches caps each process at that count.
        per_host = -(-n_train // n_proc)
        min_shard = n_train - (n_proc - 1) * per_host
        steps_per_epoch = min_shard // local_batch
        if steps_per_epoch < 1:
            # the single-device check above ran on the pre-shard count; the
            # smallest shard can still be under one local batch (or empty)
            raise ValueError(
                f"streaming layout needs one full batch on every process: "
                f"smallest host shard has {max(min_shard, 0)} of {n_train} "
                f"examples vs per-process batch {local_batch} "
                f"({n_proc} processes)")
        data_sharding = mesh_lib.data_sharding(mesh)
    else:
        feats_tr = jnp.asarray(train_store[0])
        labels_tr = jnp.asarray(train_labels)
        scals_tr = (jnp.zeros((n_train, 0), jnp.float32)
                    if fused_spec is not None
                    else jnp.asarray(train_store[1]))
    if mesh is not None:
        # val set stays replicated (its length rarely divides the mesh);
        # make_eval_step's sharding constraint shards each gathered batch.
        # make_array_from_process_local_data instead of a plain device_put:
        # under multi-process, device_put(replicated) runs an assert_equal
        # across processes that FAILS on any NaN element (NaN != NaN) — and
        # NaN features are a parity-faithful possibility (a constant CENS
        # row on a degenerate clip z-scores to 0/0, exactly as librosa
        # would). Every process holds the identical full store by
        # construction (cli._load_or_build_store), so assembling from
        # process-local data is equivalent and assert-free.
        rep = mesh_lib.replicated(mesh)
        feats_va = jax.make_array_from_process_local_data(
            rep, np.asarray(val_store[0]))
        scals_va = jax.make_array_from_process_local_data(
            rep, np.asarray(val_store[1]))
    else:
        feats_va = jnp.asarray(val_store[0])
        scals_va = jnp.asarray(val_store[1])

    rng, init_rng = jax.random.split(rng)
    state, tx, schedule = create_state(model, init_rng, cfg, steps_per_epoch)
    epoch_runner = None
    if streaming:
        state = jax.device_put(state, mesh_lib.replicated(mesh))
        train_step = make_train_step_batched(model, tx, cfg, mesh,
                                             fused_spec=fused_spec)
    elif cfg.epoch_scan:
        epoch_runner = make_epoch_runner(model, tx, cfg, mesh,
                                         fused_spec=fused_spec)
        train_step = None
    else:
        train_step = make_train_step(model, tx, cfg, mesh,
                                     fused_spec=fused_spec)
    eval_step = make_eval_step(model, mesh)

    # Resume is FAITHFUL: per-epoch randomness is derived statelessly from
    # (seed, epoch) below, and the best checkpoint's metadata restores the
    # early-stop bookkeeping exactly as it stood when that checkpoint was
    # written (best save => counter 0, best metrics = that epoch's). Replaying
    # any epochs after the checkpoint is deterministic, so a resumed run's
    # history equals the uninterrupted run's (tests/test_train.py).
    start_epoch = 0
    best_val_acc, best_val_loss = 0.0, float("inf")
    best_state, best_ckpt = state, None
    if resume and save_dir and ckpt_lib.latest_checkpoint(save_dir):
        state, start_epoch = ckpt_lib.restore_latest(save_dir, state)
        best_ckpt = ckpt_lib.latest_checkpoint(save_dir)
        meta = ckpt_lib.load_metadata(best_ckpt)
        best_val_acc = float(meta.get("val_acc", 0.0))
        best_val_loss = float(meta.get("val_loss", float("inf")))
        best_state = state
        log_fn(f"resumed from epoch {start_epoch} "
               f"(best val acc {best_val_acc:.4f})")
    early_stop = 0
    history: list[dict] = []

    for epoch in range(start_epoch, cfg.num_epochs):
        t0 = time.time()
        use_aug = jnp.asarray(epoch >= cfg.warmup_epochs)
        # stateless per-epoch streams (resume-faithful; reference analogue is
        # the stateful global np.random / torch RNG, src/train.py:72-89)
        keys = jax.random.split(jax.random.fold_in(rng, epoch),
                                steps_per_epoch)
        perm_rng = np.random.default_rng([cfg.seed + 1, epoch])
        # Dispatch every step asynchronously and fetch the whole epoch's stats
        # with ONE host sync at the end, so the host never waits on a step.
        pending = []
        if streaming:
            stream = loader_mod.stream_batches(
                (feats_host, scals_host, labels_host), local_batch, perm_rng,
                depth=2, sharding=data_sharding,
                max_batches=steps_per_epoch)
            for s, (bf, bs, by) in enumerate(stream):
                batch = Batch(bf, bs if fused_spec is None else None, by)
                state, stats = train_step(state, batch, keys[s], use_aug)
                pending.append(stats)
        elif epoch_runner is not None:
            perm = perm_rng.permutation(n_train)
            idx_mat = jnp.asarray(
                perm[: steps_per_epoch * cfg.batch_size].reshape(
                    steps_per_epoch, cfg.batch_size))
            state, scan_stats = epoch_runner(state, feats_tr, scals_tr,
                                             labels_tr, idx_mat, keys,
                                             use_aug)
            pending.append(scan_stats)  # arrays of shape [steps_per_epoch]
        else:
            perm = perm_rng.permutation(n_train)
            for s in range(steps_per_epoch):
                idx = jnp.asarray(
                    perm[s * cfg.batch_size:(s + 1) * cfg.batch_size])
                state, stats = train_step(state, feats_tr, scals_tr,
                                          labels_tr, idx, keys[s], use_aug)
                pending.append(stats)
        stats = jax.device_get(pending)
        train_loss = float(np.mean([st["loss"] for st in stats]))
        train_acc = float(np.mean([st["acc"] for st in stats]))

        val = evaluate(eval_step, state, feats_va, scals_va, val_labels,
                       cfg.eval_batch_size,
                       drop_last=cfg.parity_drop_last_eval)
        row = {"epoch": epoch + 1, "train_loss": train_loss,
               "train_acc": train_acc, "val_loss": val["loss"],
               "val_acc": val["acc"], "val_auc": val["auc"],
               "val_f1": val["f1"], "val_precision": val["precision"],
               "val_recall": val["recall"],
               "lr": float(schedule(state.step)),
               "sec": time.time() - t0}
        history.append(row)
        log_fn(f"[Epoch {epoch + 1:03d}] aug={'ON' if epoch >= cfg.warmup_epochs else 'OFF'} "
               f"train loss {train_loss:.4f} acc {train_acc:.4f} | "
               f"val loss {val['loss']:.4f} acc {val['acc']:.4f} "
               f"auc {val['auc']:.4f} f1 {val['f1']:.4f} "
               f"p∈[{val['prob_min']:.3f},{val['prob_max']:.3f}] "
               f"lr {row['lr']:.2e} ({row['sec']:.1f}s)")

        metric = val["acc"] if cfg.monitor == "val_acc" else -val["loss"]
        best_metric = best_val_acc if cfg.monitor == "val_acc" else -best_val_loss
        if metric - best_metric > cfg.min_delta:
            best_val_acc, best_val_loss = val["acc"], val["loss"]
            # snapshot to host: the live state's buffers are donated into the
            # next train step and would be deleted under our feet
            best_state = jax.device_get(state)
            early_stop = 0
            if save_dir:
                best_ckpt = ckpt_lib.save(save_dir, state, epoch + 1,
                                          {"val_acc": val["acc"],
                                           "val_loss": val["loss"]})
        else:
            early_stop += 1
            if early_stop >= cfg.patience:
                log_fn(f"early stopping at epoch {epoch + 1} "
                       f"(best val acc {best_val_acc:.4f})")
                break

    if cfg.restore_best_weights:
        state = best_state
    return FitResult(best_val_acc=best_val_acc, best_ckpt_path=best_ckpt,
                     best_state=state, history=history)
