"""VGG-style classifier with a 1x1-conv residual on the last block.

Capability-parity rebuild of reference src/model.py:92-202 (~8.15M params):
four 3-conv blocks (64, 128, 256, 512) of bias-free Conv->BN->GELU; block 1
downsamples with a stride-2 conv, blocks 2-3 with ceil-mode max pooling;
block 4 adds a 1x1-conv+BN residual from 256->512 (src/model.py:150-153,
197-198); bias-free scalar MLP and classifier. Plain JAX, NHWC, bf16.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from tpu_breath.models import layers as L

_WIDTHS = (64, 128, 256, 512)
_CONVS_PER_BLOCK = 3


@dataclasses.dataclass(frozen=True)
class VGG:
    num_scalar_features: int = 36
    dropout_rate: float = 0.2
    dtype: Any = jnp.bfloat16
    in_channels: int = 9

    def init(self, key) -> dict:
        keys = iter(jax.random.split(key, 4 * _CONVS_PER_BLOCK + 6))
        params = {"convs": [], "scalar_mlp": [], "head": []}
        stats = {"convs": [], "scalar_mlp": [], "head": []}
        c_in = self.in_channels
        for width in _WIDTHS:
            for _ in range(_CONVS_PER_BLOCK):
                p, s = L.conv_block_init(next(keys), c_in, width,
                                         use_bias=False)
                params["convs"].append(p)
                stats["convs"].append(s)
                c_in = width
        bn_p, bn_s = L.bn_init(_WIDTHS[-1])
        params["residual"] = {
            "conv": L.conv_init(next(keys), _WIDTHS[-2], _WIDTHS[-1], 1,
                                use_bias=False),
            "bn": bn_p}
        stats["residual"] = bn_s
        for name, dims in (("scalar_mlp", ((self.num_scalar_features, 64),
                                           (64, 64))),
                           ("head", ((c_in + 64, 256), (256, 128)))):
            for d_in, d_out in dims:
                p, s = L.mlp_block_init(next(keys), d_in, d_out,
                                        use_bias=False)
                params[name].append(p)
                stats[name].append(s)
        params["out"] = L.dense_init(next(keys), 128, 1)
        return {"params": params, "batch_stats": stats}

    def apply(self, variables: dict, features, scalars, train: bool = False,
              key=None) -> tuple[jax.Array, dict]:
        """features [B, C, H, W], scalars [B, S] -> (logits [B] float32,
        batch_stats). `key` drives dropout in train mode."""
        p, st, dt, d = (variables["params"], variables["batch_stats"],
                        self.dtype, self.dropout_rate)
        new = {"convs": [], "scalar_mlp": [], "head": []}
        drop = (lambda i: None) if key is None else \
            (lambda i: jax.random.fold_in(key, i))

        def block(x, b, stride_last=1):
            for j in range(_CONVS_PER_BLOCK):
                i = b * _CONVS_PER_BLOCK + j
                stride = stride_last if j == _CONVS_PER_BLOCK - 1 else 1
                x, s = L.conv_block(p["convs"][i], st["convs"][i], x, train,
                                    order="bn_gelu", stride=stride, dtype=dt)
                new["convs"].append(s)
            return x

        def channel_drop(x, rate, i):
            return L.dropout(drop(i), x, rate, train, broadcast_dims=(1, 2))

        x = jnp.transpose(features, (0, 2, 3, 1)).astype(dt)  # NHWC
        x = channel_drop(block(x, 0, stride_last=2), d * 0.5, 0)
        x = channel_drop(L.max_pool_2x2(block(x, 1), ceil_mode=True), d, 1)
        x = channel_drop(L.max_pool_2x2(block(x, 2), ceil_mode=True), d, 2)

        # block 4 + 1x1-conv residual (src/model.py:150-153,197-198)
        residual, new["residual"] = L.batch_norm(
            p["residual"]["bn"], st["residual"],
            L.conv(p["residual"]["conv"], x, 1, dt), train)
        main = channel_drop(block(x, 3), d, 3)
        x = main.astype(residual.dtype) + residual
        x = L.global_avg_pool(x.astype(dt))

        s_in = scalars.astype(dt)
        for i, rate in enumerate((d, 0.0)):
            s_in, s = L.mlp_block(p["scalar_mlp"][i], st["scalar_mlp"][i],
                                  s_in, train, drop(4 + i), order="bn_gelu",
                                  rate=rate, dtype=dt)
            new["scalar_mlp"].append(s)

        z = jnp.concatenate([x, s_in], axis=-1)
        for i in range(2):
            z, s = L.mlp_block(p["head"][i], st["head"][i], z, train,
                               drop(6 + i), order="bn_gelu", rate=d, dtype=dt)
            new["head"].append(s)
        out_dt = jnp.promote_types(dt, jnp.float32)
        logit = L.dense(p["out"], z.astype(out_dt), out_dt)
        return jnp.squeeze(logit, -1), new
