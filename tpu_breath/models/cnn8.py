"""CNN8: 8-conv audio classifier with a scalar-descriptor side branch.

Capability-parity rebuild of reference src/model.py:5-89 (~2.43M params):
conv widths 32-64-128-128-256x4 with Conv->ReLU->BN, MaxPool after convs 2
and 4, channel dropout after conv 4, global average pooling; scalar MLP
S->64->64; classifier (256+64)->256->128->1. Plain JAX, NHWC, bf16 (see
models/layers.py for the layout + mixed-precision conventions).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from tpu_breath.models import layers as L

# (width, max-pool after, channel dropout after) per conv block
_CONVS = ((32, False, False), (64, True, False),
          (128, False, False), (128, True, True),
          (256, False, False), (256, False, False),
          (256, False, False), (256, False, False))


@dataclasses.dataclass(frozen=True)
class CNN8:
    num_scalar_features: int = 36
    dropout_rate: float = 0.3
    dtype: Any = jnp.bfloat16
    in_channels: int = 9

    def init(self, key) -> dict:
        keys = iter(jax.random.split(key, len(_CONVS) + 5))
        params = {"convs": [], "scalar_mlp": [], "head": []}
        stats = {"convs": [], "scalar_mlp": [], "head": []}
        c_in = self.in_channels
        for width, _, _ in _CONVS:
            p, s = L.conv_block_init(next(keys), c_in, width)
            params["convs"].append(p)
            stats["convs"].append(s)
            c_in = width
        for name, dims in (("scalar_mlp", ((self.num_scalar_features, 64),
                                           (64, 64))),
                           ("head", ((c_in + 64, 256), (256, 128)))):
            for d_in, d_out in dims:
                p, s = L.mlp_block_init(next(keys), d_in, d_out)
                params[name].append(p)
                stats[name].append(s)
        params["out"] = L.dense_init(next(keys), 128, 1)
        return {"params": params, "batch_stats": stats}

    def apply(self, variables: dict, features, scalars, train: bool = False,
              key=None) -> tuple[jax.Array, dict]:
        """features [B, C, H, W] (reference layout), scalars [B, S] ->
        (logits [B] float32, batch_stats). `key` drives dropout in train
        mode."""
        p, st, dt = variables["params"], variables["batch_stats"], self.dtype
        new = {"convs": [], "scalar_mlp": [], "head": []}
        drop = (lambda i: None) if key is None else \
            (lambda i: jax.random.fold_in(key, i))
        x = jnp.transpose(features, (0, 2, 3, 1)).astype(dt)  # NHWC
        for i, (_, pool, channel_drop) in enumerate(_CONVS):
            x, s = L.conv_block(p["convs"][i], st["convs"][i], x, train,
                                order="relu_bn", dtype=dt)
            new["convs"].append(s)
            if pool:
                x = L.max_pool_2x2(x)
            if channel_drop:
                x = L.dropout(drop(0), x, self.dropout_rate, train,
                              broadcast_dims=(1, 2))
        x = L.global_avg_pool(x)

        s_in = scalars.astype(dt)
        for i, rate in enumerate((self.dropout_rate, 0.0)):
            s_in, s = L.mlp_block(p["scalar_mlp"][i], st["scalar_mlp"][i],
                                  s_in, train, drop(1 + i), order="relu_bn",
                                  rate=rate, dtype=dt)
            new["scalar_mlp"].append(s)

        z = jnp.concatenate([x, s_in], axis=-1)
        for i, rate in enumerate((self.dropout_rate, 0.0)):
            z, s = L.mlp_block(p["head"][i], st["head"][i], z, train,
                               drop(3 + i), order="relu_bn", rate=rate,
                               dtype=dt)
            new["head"].append(s)
        out_dt = jnp.promote_types(dt, jnp.float32)
        logit = L.dense(p["out"], z.astype(out_dt), out_dt)
        return jnp.squeeze(logit, -1), new
