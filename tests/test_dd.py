"""Correctly-rounded double-float primitives (ops/dd.py): each op must match
its quantity computed in float64 and rounded once to float32, except for
inputs whose exact result sits within ~1e-10 relative of an f32 rounding
boundary (the documented dd-precision escape hatch). Pins the contract the
tuning-estimate flip suppression rests on (PARITY.md), independent of the
series length / internal layout."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpu_breath.ops import dd


def _away_from_boundary(r64: np.ndarray, rel: float = 1e-9) -> np.ndarray:
    """True where the f64 value is NOT near the midpoint between adjacent
    f32s (where correct rounding legitimately needs >dd precision)."""
    r32 = r64.astype(np.float32)
    ulp = np.spacing(np.abs(r32)).astype(np.float64)
    frac = np.abs(r64 - r32.astype(np.float64)) / ulp  # in [0, 0.5]
    return np.abs(frac - 0.5) > rel


def _check_two_sum_literal(device):
    x = jax.device_put(jnp.float32(1.0001086e-06), device)
    jit_s, jit_e = jax.jit(
        lambda b: dd._two_sum(dd._opaque(b, 1.0), b))(x)
    eag_s, eag_e = dd._two_sum(np.float32(1.0), np.float32(x))
    assert float(jit_s) == float(eag_s)
    assert float(jit_e) == float(eag_e) != 0.0


def _check_log2(device):
    rng = np.random.default_rng(0)
    x = np.exp(rng.uniform(np.log(1e-8), np.log(1e8), 200_000)
               ).astype(np.float32)
    got = np.asarray(jax.jit(dd.log2_cr)(jax.device_put(x, device)))
    r64 = np.log2(x.astype(np.float64))
    ok = _away_from_boundary(r64)
    assert ok.mean() > 0.999
    np.testing.assert_array_equal(got[ok], r64.astype(np.float32)[ok])


def _check_div(device):
    rng = np.random.default_rng(1)
    a = rng.standard_normal(200_000).astype(np.float32) * 1e3
    b = (rng.standard_normal(200_000).astype(np.float32) + 2.5)
    b = np.where(np.abs(b) < 0.1, 1.0, b).astype(np.float32)
    got = np.asarray(jax.jit(dd.div_cr)(jax.device_put(a, device),
                                        jax.device_put(b, device)))
    r64 = a.astype(np.float64) / b.astype(np.float64)
    ok = _away_from_boundary(r64)
    np.testing.assert_array_equal(got[ok], r64.astype(np.float32)[ok])


def _check_log1p(device):
    rng = np.random.default_rng(2)
    x = np.exp(rng.uniform(np.log(1e-6), np.log(30.0), 200_000)
               ).astype(np.float32)
    got = np.asarray(jax.jit(dd.log1p_cr)(jax.device_put(x, device)))
    r64 = np.log1p(x.astype(np.float64))
    ok = _away_from_boundary(r64)
    np.testing.assert_array_equal(got[ok], r64.astype(np.float32)[ok])


def _check_sqrt(device):
    rng = np.random.default_rng(3)
    h = np.exp(rng.uniform(np.log(1e-10), np.log(1e6), 100_000)
               ).astype(np.float32)
    l = (h * rng.uniform(-1, 1, h.shape) * 2e-8).astype(np.float32)
    got = np.asarray(jax.jit(dd.sqrt_dd)(jax.device_put(h, device),
                                         jax.device_put(l, device)))
    r64 = np.sqrt(h.astype(np.float64) + l.astype(np.float64))
    ok = _away_from_boundary(r64)
    np.testing.assert_array_equal(got[ok], r64.astype(np.float32)[ok])


_CHECKS = {"two_sum_literal": _check_two_sum_literal, "log2": _check_log2,
           "div": _check_div, "log1p": _check_log1p, "sqrt": _check_sqrt}


def test_two_sum_literal_operand(cpu_device):
    """XLA's algebraic simplifier rewrites (A + C) - C -> A for literal C,
    which destroys the two_sum residual under jit (the eager path is
    unaffected, so only a jit-vs-eager comparison catches it). dd routes
    literal EFT operands through an optimization_barrier (_opaque)."""
    _check_two_sum_literal(cpu_device)


def test_log2_cr_matches_f64_rounded(cpu_device):
    _check_log2(cpu_device)


def test_div_cr_matches_f64_rounded(cpu_device):
    _check_div(cpu_device)


def test_log1p_cr_matches_f64_rounded(cpu_device):
    _check_log1p(cpu_device)


def test_sqrt_dd_round_once(cpu_device):
    _check_sqrt(cpu_device)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(_CHECKS))
def test_dd_contract_on_gpu(name, gpu_device):
    """The same contracts as compiled for the card: XLA:GPU and ptxas may
    contract a multiply and an add into one FMA, which would break the
    error-free transforms these checks pin."""
    _CHECKS[name](gpu_device)
