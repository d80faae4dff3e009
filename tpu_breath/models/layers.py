"""Shared building blocks of the model zoo: plain JAX functions over
parameter pytrees.

A model is a pair of functions. `init(key)` returns the variables
{"params": ..., "batch_stats": ...}; `apply(variables, features, scalars,
train, key)` returns (logits, new batch_stats). Each block below takes its
own slice of both trees and returns its output with its updated statistics.

Conventions (differing deliberately from the reference's torch habits):
- NHWC activation layout; the public forward accepts the reference's
  [B, C, H, W] contract and transposes once at entry.
- bf16 activations with f32 params and f32 BatchNorm statistics — the
  analogue of the reference's CUDA AMP autocast (src/train.py:53,92); bf16
  has f32's exponent range so no GradScaler analogue is needed.
- Explicit (1,1) conv padding (not SAME) so strided convs produce exactly the
  reference's output sizes on odd inputs (src/model.py:103).
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from jax import lax

Dtype = Any

he_normal = jax.nn.initializers.variance_scaling(2.0, "fan_in", "normal")
xavier_uniform = jax.nn.initializers.xavier_uniform()

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def conv_init(key, in_ch: int, out_ch: int, size: int = 3,
              use_bias: bool = True) -> dict:
    p = {"kernel": he_normal(key, (size, size, in_ch, out_ch), jnp.float32)}
    if use_bias:
        p["bias"] = jnp.zeros((out_ch,), jnp.float32)
    return p


def dense_init(key, in_f: int, out_f: int, use_bias: bool = True) -> dict:
    p = {"kernel": xavier_uniform(key, (in_f, out_f), jnp.float32)}
    if use_bias:
        p["bias"] = jnp.zeros((out_f,), jnp.float32)
    return p


def bn_init(n: int) -> tuple[dict, dict]:
    """(params, stats) of a fresh BatchNorm over n features."""
    return ({"scale": jnp.ones((n,), jnp.float32),
             "bias": jnp.zeros((n,), jnp.float32)},
            {"mean": jnp.zeros((n,), jnp.float32),
             "var": jnp.ones((n,), jnp.float32)})


def conv(p: dict, x: jax.Array, stride: int, dtype: Dtype) -> jax.Array:
    """Square conv on NHWC with padding size//2 on every side."""
    pad = p["kernel"].shape[0] // 2
    y = lax.conv_general_dilated(
        x.astype(dtype), p["kernel"].astype(dtype), (stride, stride),
        ((pad, pad), (pad, pad)), dimension_numbers=("NHWC", "HWIO", "NHWC"))
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


def dense(p: dict, x: jax.Array, dtype: Dtype) -> jax.Array:
    y = jnp.dot(x.astype(dtype), p["kernel"].astype(dtype))
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


def batch_norm(p: dict, stats: dict, x: jax.Array, train: bool
               ) -> tuple[jax.Array, dict]:
    """BatchNorm over every axis but the last, in float32 (or wider, for a
    float64 reference).

    Train mode normalizes by the batch's biased statistics and moves the
    running ones by momentum 0.9; eval mode uses the running statistics and
    leaves them unchanged. Returns (f32 output, statistics)."""
    if train:
        xf = x.astype(jnp.promote_types(x.dtype, jnp.float32))
        axes = tuple(range(x.ndim - 1))
        mean = jnp.mean(xf, axes)
        var = jnp.maximum(0.0, jnp.mean(xf * xf, axes) - mean * mean)
        stats = {"mean": BN_MOMENTUM * stats["mean"] + (1 - BN_MOMENTUM) * mean,
                 "var": BN_MOMENTUM * stats["var"] + (1 - BN_MOMENTUM) * var}
    else:
        mean, var = stats["mean"], stats["var"]
    # x enters here in its own dtype (promoted by the subtraction), as in the
    # Flax layer this replaces: bf16 gradients then round the same way.
    y = (x - mean) * (lax.rsqrt(var + BN_EPS) * p["scale"]) + p["bias"]
    return y, stats


def dropout(key, x: jax.Array, rate: float, train: bool,
            broadcast_dims: tuple = ()) -> jax.Array:
    """Inverted dropout; one mask value is shared along broadcast_dims
    (channel dropout on NHWC uses broadcast_dims=(1, 2))."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = [1 if d in broadcast_dims else n for d, n in enumerate(x.shape)]
    mask = jnp.broadcast_to(jax.random.bernoulli(key, keep, shape), x.shape)
    return lax.select(mask, x / keep, jnp.zeros_like(x))


def _activate_norm(p: dict, stats: dict, x: jax.Array, train: bool,
                   order: str) -> tuple[jax.Array, dict]:
    if order == "relu_bn":
        return batch_norm(p, stats, jax.nn.relu(x), train)
    if order == "bn_gelu":
        x, stats = batch_norm(p, stats, x, train)
        return jax.nn.gelu(x, approximate=False), stats
    raise ValueError(order)


def conv_block_init(key, in_ch: int, out_ch: int, use_bias: bool = True
                    ) -> tuple[dict, dict]:
    bn_p, bn_s = bn_init(out_ch)
    return {"conv": conv_init(key, in_ch, out_ch, 3, use_bias), "bn": bn_p}, bn_s


def conv_block(p: dict, stats: dict, x: jax.Array, train: bool, *,
               order: str, stride: int = 1, dtype: Dtype = jnp.bfloat16
               ) -> tuple[jax.Array, dict]:
    """Conv3x3 (+optional stride) -> activation/BN in the given order.

    order="relu_bn" reproduces CNN8's Conv->ReLU->BN (src/model.py:10-12);
    order="bn_gelu" reproduces VGG's Conv->BN->GELU (src/model.py:97-99).
    """
    x = conv(p["conv"], x, stride, dtype)
    x, stats = _activate_norm(p["bn"], stats, x, train, order)
    return x.astype(dtype), stats


def mlp_block_init(key, in_f: int, out_f: int, use_bias: bool = True
                   ) -> tuple[dict, dict]:
    bn_p, bn_s = bn_init(out_f)
    return {"dense": dense_init(key, in_f, out_f, use_bias), "bn": bn_p}, bn_s


def mlp_block(p: dict, stats: dict, x: jax.Array, train: bool, key=None, *,
              order: str, rate: float = 0.0, dtype: Dtype = jnp.bfloat16
              ) -> tuple[jax.Array, dict]:
    """Linear -> (ReLU->BN | BN->GELU) -> optional Dropout, matching the
    reference's scalar/classifier stacks (src/model.py:47-69,157-177)."""
    x = dense(p["dense"], x, dtype)
    x, stats = _activate_norm(p["bn"], stats, x, train, order)
    return dropout(key, x.astype(dtype), rate, train), stats


def max_pool_2x2(x: jax.Array, ceil_mode: bool = False) -> jax.Array:
    """2x2/stride-2 max pool on NHWC; ceil_mode pads the tail like torch's
    MaxPool2d(ceil_mode=True) (src/model.py:119,133)."""
    if ceil_mode:
        ph, pw = x.shape[1] % 2, x.shape[2] % 2
        if ph or pw:
            x = jnp.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)),
                        constant_values=jnp.finfo(x.dtype).min)
    return lax.reduce_window(x, -jnp.inf, lax.max, (1, 2, 2, 1),
                             (1, 2, 2, 1), "VALID")


def global_avg_pool(x: jax.Array) -> jax.Array:
    """AdaptiveAvgPool2d((1,1)) + flatten on NHWC -> [B, C]."""
    return jnp.mean(x, axis=(1, 2))
