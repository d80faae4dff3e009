"""On-device CutMix / MixUp as pure functions of a PRNG key.

Runs *inside* the jitted train step (no host RNG, no data-loader involvement) —
the JAX counterpart of reference src/augmentation.py:5-45 plus the
inline branch logic of src/train.py:76-89. Two reference quirks are preserved
deliberately (documented as discrepancy D6 in SURVEY.md §2.5):
- CutMix mixes spectrograms + labels but leaves the scalar vector alone.
- MixUp (the inlined version train.py:82-89) mixes features, scalars and
  labels with the same lambda.
The returned labels are the mixed ones; training accuracy is measured against
the original labels, as the reference does (src/train.py:103-111).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class Batch(NamedTuple):
    features: jax.Array  # [B, C, H, W]
    scalars: jax.Array   # [B, S]
    labels: jax.Array    # [B] float


def cutmix(key: jax.Array, batch: Batch, alpha: float) -> Batch:
    """Random box from a permuted batch pasted into each clip; lambda
    recomputed from the realized integer box (src/augmentation.py:9-33)."""
    kperm, klam, kcx, kcy = jax.random.split(key, 4)
    b, _, h, w = batch.features.shape
    indices = jax.random.permutation(kperm, b)
    lam = jax.random.beta(klam, alpha, alpha)
    cut_rat = jnp.sqrt(1.0 - lam)
    cut_w = (w * cut_rat).astype(jnp.int32)
    cut_h = (h * cut_rat).astype(jnp.int32)
    cx = jax.random.randint(kcx, (), 0, w)
    cy = jax.random.randint(kcy, (), 0, h)
    bbx1 = jnp.clip(cx - cut_w // 2, 0, w)
    bby1 = jnp.clip(cy - cut_h // 2, 0, h)
    bbx2 = jnp.clip(cx + cut_w // 2, 0, w)
    bby2 = jnp.clip(cy + cut_h // 2, 0, h)
    row = jnp.arange(h)[:, None]
    col = jnp.arange(w)[None, :]
    box = ((row >= bby1) & (row < bby2) & (col >= bbx1) & (col < bbx2))
    mixed = jnp.where(box[None, None], batch.features[indices], batch.features)
    lam_adj = 1.0 - ((bbx2 - bbx1) * (bby2 - bby1)).astype(jnp.float32) / (w * h)
    labels = lam_adj * batch.labels + (1.0 - lam_adj) * batch.labels[indices]
    return Batch(mixed, batch.scalars, labels)


def mixup(key: jax.Array, batch: Batch, alpha: float) -> Batch:
    """Convex combination of features, scalars and labels (src/train.py:82-89)."""
    kperm, klam = jax.random.split(key)
    b = batch.features.shape[0]
    indices = jax.random.permutation(kperm, b)
    lam = jax.random.beta(klam, alpha, alpha)
    feats = lam * batch.features + (1 - lam) * batch.features[indices]
    scals = lam * batch.scalars + (1 - lam) * batch.scalars[indices]
    labels = lam * batch.labels + (1 - lam) * batch.labels[indices]
    return Batch(feats, scals, labels)


def apply_augmentation(key: jax.Array, batch: Batch, use_aug: jax.Array,
                       cutmix_prob: float, mixup_prob: float,
                       cutmix_alpha: float, mixup_alpha: float) -> Batch:
    """The reference's per-step branch (src/train.py:76-89): draw r~U[0,1);
    r < cutmix_prob -> CutMix, r < cutmix_prob+mixup_prob -> MixUp, else
    passthrough. use_aug gates the whole thing (epoch >= warmup_epochs)."""
    kr, kaug = jax.random.split(key)
    r = jax.random.uniform(kr, ())
    branch = jnp.where(r < cutmix_prob, 0, jnp.where(r < cutmix_prob + mixup_prob, 1, 2))
    branch = jnp.where(use_aug, branch, 2)
    return lax.switch(
        branch,
        [lambda k, bt: cutmix(k, bt, cutmix_alpha),
         lambda k, bt: mixup(k, bt, mixup_alpha),
         lambda k, bt: bt],
        kaug, batch)
