"""Radix select (ops/select.py): exact order statistics at every descent
width, against np.sort/np.percentile/np.median ground truth. The wider
descents (bits>1) are bit-identical alternatives to the 32-step binary
descent."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpu_breath.ops import select

RNG = np.random.default_rng(7)


def _keys():
    return np.concatenate([
        RNG.integers(0, 2**32, 512, dtype=np.uint64).astype(np.uint32),
        np.repeat(RNG.integers(0, 2**32, 8, dtype=np.uint64
                               ).astype(np.uint32), 16),
        np.zeros(3, np.uint32),
        np.full(5, 2**32 - 1, np.uint64).astype(np.uint32)])


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_rank_select_exact_all_widths(bits):
    keys = _keys()
    ranks = RNG.integers(0, len(keys), 64)
    got = np.asarray(jax.jit(jax.vmap(
        lambda r: select.rank_select_u32(jnp.asarray(keys), r, bits=bits)
    ))(jnp.asarray(ranks)))
    np.testing.assert_array_equal(got, np.sort(keys)[ranks])


@pytest.mark.parametrize("bits", [1, 4])
def test_multi_rank_matches_scalar(bits):
    # one shared descent for R ranks must be bit-identical to R descents
    keys = _keys()
    ranks = RNG.integers(0, len(keys), 16)
    multi = np.asarray(jax.jit(
        lambda r: select.rank_select_u32_multi(jnp.asarray(keys), r,
                                               bits=bits)
    )(jnp.asarray(ranks)))
    np.testing.assert_array_equal(multi, np.sort(keys)[ranks])


def test_percentiles_pair_matches_numpy():
    x = np.random.default_rng(13).standard_normal(1000).astype(np.float32)
    got = np.asarray(jax.jit(
        lambda v: select.percentiles(v, (90.0, 10.0))
    )(jnp.asarray(x)))
    np.testing.assert_allclose(got, np.percentile(x, [90, 10]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bits", [1, 4])
def test_percentile_matches_numpy(bits):
    x = np.random.default_rng(11).standard_normal(1000).astype(np.float32)
    for q in (10, 50, 90):
        got = float(jax.jit(
            lambda v, q=q, b=bits: select.percentile(v, q, bits=b)
        )(jnp.asarray(x)))
        # ours interpolates in f32; numpy in f64 — one f32 ulp of slack
        np.testing.assert_allclose(got, np.percentile(x, q),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bits", [1, 4])
def test_masked_median_matches_numpy(bits):
    r2 = np.random.default_rng(12)
    x = r2.standard_normal(777).astype(np.float32)
    m = r2.random(777) < 0.3
    got = float(jax.jit(
        lambda v, mm, b=bits: select.masked_median(v, mm, bits=b)
    )(jnp.asarray(x), jnp.asarray(m)))
    np.testing.assert_allclose(got, np.median(x[m]), rtol=1e-6)
    # empty mask -> 0.0 by contract
    got0 = float(jax.jit(
        lambda v, mm, b=bits: select.masked_median(v, mm, bits=b)
    )(jnp.asarray(x), jnp.zeros(777, bool)))
    assert got0 == 0.0
