"""Checkpointing with true resume.

The reference only *saves* on improvement (torch.save of model/opt/sched
state, src/train.py:152-164) and cannot resume a training run; here the full
TrainState (params, batch_stats, optimizer state, step) goes to one .npz
keyed by each leaf's pytree path, and restore_latest() continues an
interrupted run.

Layout: <save_dir>/best_epochNNN/state.npz, then metadata.json. The metadata
is written LAST, so a directory without it is a save that was interrupted.
"""
from __future__ import annotations

import json
import os
import re

import jax
import numpy as np

_STATE = "state.npz"


def _dir(save_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(save_dir), f"best_epoch{epoch:03d}")


def save(save_dir: str, state, epoch: int, metadata: dict) -> str:
    """Write state + metadata. Under several processes every process calls
    this with the same path; the state is replicated, so only process 0
    writes."""
    path = _dir(save_dir, epoch)
    host_state = jax.device_get(state)
    if jax.process_index() == 0:
        os.makedirs(path, exist_ok=True)
        leaves = jax.tree_util.tree_flatten_with_path(host_state)[0]
        np.savez(os.path.join(path, _STATE),
                 **{jax.tree_util.keystr(k): np.asarray(v) for k, v in leaves})
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump({"epoch": epoch,
                       **{k: float(v) for k, v in metadata.items()}}, f)
    return path


def latest_checkpoint(save_dir: str) -> str | None:
    if not os.path.isdir(save_dir):
        return None
    best = None
    for name in os.listdir(save_dir):
        m = re.fullmatch(r"best_epoch(\d+)", name)
        if not m:
            continue
        # metadata.json is written LAST in save(): a directory without it is
        # a save interrupted mid-write — skip it so resume/predict fall back
        # to the newest INTACT checkpoint instead of crashing on a partial
        if not os.path.exists(os.path.join(save_dir, name, "metadata.json")):
            continue
        if best is None or int(m.group(1)) > best[0]:
            best = (int(m.group(1)), os.path.join(save_dir, name))
    return best[1] if best else None


def restore(path: str, target_state):
    """Restore a TrainState with target_state's structure; every leaf must
    match its target's shape and dtype."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(target_state)
    out = []
    with np.load(os.path.join(path, _STATE)) as data:
        for key, like in leaves:
            name = jax.tree_util.keystr(key)
            v = data[name]
            if v.shape != like.shape or v.dtype != like.dtype:
                raise ValueError(
                    f"{path}: {name} is {v.dtype}{list(v.shape)}, expected "
                    f"{like.dtype}{list(like.shape)}")
            out.append(v)
    return jax.tree_util.tree_unflatten(treedef, out)


def restore_latest(save_dir: str, target_state):
    path = latest_checkpoint(save_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoint under {save_dir}")
    return restore(path, target_state), int(load_metadata(path)["epoch"])


def load_metadata(path: str) -> dict:
    with open(os.path.join(path, "metadata.json")) as f:
        return json.load(f)
