"""Correctly-rounded float32 division and log2 via double-float
(two-float32) arithmetic.

Why this exists: the tuning-estimation histogram (ops/chroma.py) takes an
argmax over ~100 near-tied bins of residuals r = mod(36*log2(pitch/27.5), 1).
On breathing-noise clips the modes are tied within +/-1 count, so ANY
rounding difference between the device's transcendentals and the host's
flips the argmax — a device's native f32 log2/divide that is ~1-2 ulp
accurate differs from numpy's, and flipped the estimated tuning on ~50% of
clips (PARITY.md). With log2/divide computed here to double-float accuracy
(~1e-14 relative) and rounded once to f32, the device bit-matches an oracle
that computes the same quantities in float64 and rounds to f32 — the only
remaining flips come from |STFT| magnitude noise between the matmul-DFT and
the host FFT, which measurement shows is rare.

Error-free transforms (two_sum, Veltkamp split / two_prod) rely on IEEE
round-to-nearest f32 add/mul without hidden FMA contraction. XLA keeps the
separate mul/add ops of the HLO unfused on the CPU and, as compiled for the
H100, on the GPU: tests/test_dd.py runs every contract on both.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from jax import lax

_SPLITTER = np.float32(4097.0)  # 2**12 + 1 for f32 Veltkamp splitting
_LN2_HI = np.float32(0.6931471824645996)       # fl32(ln 2)
_LN2_LO = np.float32(-1.904654323148236e-09)   # ln2 - LN2_HI (dd tail)


def _opaque(like, v):
    """Literal v as a runtime-opaque f32 constant shaped like `like`.

    XLA's algebraic simplifier rewrites (A + C) - C -> A when C is a
    trace-time literal, which silently destroys the error-free two_sum
    residual: under jit on the CPU backend, two_sum(1.0, x) returned
    ulp(1)/2 instead of the exact residual (the whole point of the EFT),
    while the same EFT on two traced operands compiles correctly
    (tests/test_dd.py::test_two_sum_literal_operand). An
    optimization_barrier hides the literal from the pattern matcher on
    every backend. Invariant for this module: any LITERAL operand of
    _two_sum/_fast_two_sum/_dd_add must pass through here; traced operands
    (and zeros_like tails, which no rewrite can damage) need not."""
    return lax.optimization_barrier(jnp.full_like(like, v))


def _two_sum(a, b):
    """a + b = s + e exactly (Knuth). Operands must be traced values or
    _opaque literals — see _opaque."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _fast_two_sum(a, b):
    """a + b = s + e exactly, requires |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    """a = hi + lo with hi/lo each having <= 12 significant bits."""
    t = _SPLITTER * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def _two_prod(a, b):
    """a * b = p + e exactly (Veltkamp/Dekker, no FMA)."""
    p = a * b
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def _dd_add(xh, xl, yh, yl):
    sh, se = _two_sum(xh, yh)
    te = se + xl + yl
    return _fast_two_sum(sh, te)


def _dd_mul(xh, xl, yh, yl):
    ph, pe = _two_prod(xh, yh)
    pe = pe + (xh * yl + xl * yh)
    return _fast_two_sum(ph, pe)


def _dd_mul_f(xh, xl, f):
    """double-float times plain float."""
    ph, pe = _two_prod(xh, f)
    pe = pe + xl * f
    return _fast_two_sum(ph, pe)


def div_cr(a: jax.Array, b: jax.Array) -> jax.Array:
    """Correctly-rounded float32 a / b (elementwise).

    Newton refinement of the hardware reciprocal in double-float: accurate
    to ~2^-40 before the single final rounding, so the f32 result matches
    float64-computed-then-rounded division except within ~1e-12 of a
    rounding boundary."""
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    y0 = 1.0 / b  # approximate hardware reciprocal
    # r = a * y0; correct with e = a - b*r computed exactly; q = r + e*y0
    r_h, r_l = _two_prod(a, y0)
    br_h, br_l = _dd_mul_f(jnp.float32(b), jnp.zeros_like(b), r_h)
    # e = a - b*r_h - b*r_l(approx)  (r_l tiny; fold via dd)
    e_h, e_l = _dd_add(a, jnp.zeros_like(a), -br_h, -br_l)
    e = e_h + (e_l - b * r_l)
    q_h, q_l = _fast_two_sum(r_h, e * y0 + r_l)
    return q_h + q_l


def matmul_dd_pair(a: jax.Array, b: jax.Array, chunk: int = 64,
                   b_lo: jax.Array | None = None
                   ) -> tuple[jax.Array, jax.Array]:
    """Compensated-accumulation f32 matmul a[..., m, k] @ b[k, n], returned
    as an unevaluated double-float pair (h, l).

    Why: a plain f32 GEMM's accumulation error grows with SUM |a_i b_i|, not
    with the result — for DFT rows (heavy cancellation: sum of |terms| can be
    ~100x the output) that is ~1e-5 absolute, which the gammatone channel's
    z-score (std ~0.005) amplifies ~200x past the 1e-3 parity budget
    (PARITY.md; reference channel recipe src/precompute/methods.py:136-140).

    Method: the contraction is split into `chunk`-wide slices; each slice is
    one GEMM at HIGHEST precision (near-exact products, and within-slice
    accumulation error is bounded by the slice's tiny |term| sum), and slices
    are accumulated across the scan in double-float (error-free two_sum), so
    cross-slice accumulation is exact. Measured error vs a float64 host GEMM:
    ~1e-7 absolute for the 512-point DFT, ~100x better than the single GEMM.

    b_lo, if given, is the f32 tail of a float64-valued B (b64 - f32(b64)):
    one extra DEFAULT-precision GEMM a @ b_lo folds the constant's rounding
    error back in, so the pair approximates a @ b64 rather than a @ f32(b64)
    (the tail product is ~3e-7 of the result; its own rounding is ~1e-14).

    chunk=64: the error floor is the per-product rounding, identical at
    widths 8/32/64 (|S| max 3.8e-6, tuning flips 0/500), while each scan
    step round-trips the (h, l) carries through device memory, so wider
    slices mean fewer steps. Width 128 grows the within-slice f32 sum error
    1.5x."""
    k = a.shape[-1]
    if b.shape[0] != k:
        raise ValueError(f"contraction mismatch: {a.shape} @ {b.shape}")
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    nc = -(-k // chunk)
    pad = nc * chunk - k
    if pad:
        a = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])
        b = jnp.pad(b, [(0, pad)] + [(0, 0)] * (b.ndim - 1))
    a_s = jnp.moveaxis(a.reshape(*a.shape[:-1], nc, chunk), -2, 0)
    b_s = b.reshape(nc, chunk, b.shape[-1])
    out_shape = (*a.shape[:-1], b.shape[-1])

    def body(carry, xs):
        h, l = carry
        a_c, b_c = xs
        p = jnp.matmul(a_c, b_c, precision=lax.Precision.HIGHEST)
        h, e = _two_sum(h, p)
        return (h, l + e), None

    zeros = jnp.zeros(out_shape, jnp.float32)
    if b_lo is not None:
        # DEFAULT precision suffices (TF32 on the H100, ~5e-4 relative): the
        # tail product is ~3e-7 of the result, so its own rounding lands
        # below ~1e-10.
        tail = jnp.matmul(a[..., :k], b_lo, precision=lax.Precision.DEFAULT)
        init = (zeros, tail)
    else:
        init = (zeros, zeros)
    (h, l), _ = lax.scan(body, init, (a_s, b_s))
    return _fast_two_sum(h, l)  # normalize: |l| <= ulp(h)/2 for dd consumers


def matmul_dd(a: jax.Array, b: jax.Array, chunk: int = 64) -> jax.Array:
    """matmul_dd_pair rounded once to f32."""
    h, l = matmul_dd_pair(a, b, chunk=chunk)
    return h + l


def sqrt_dd(sh: jax.Array, sl: jax.Array) -> jax.Array:
    """f32 sqrt of a non-negative double-float value, rounded once.

    One Newton correction of the hardware sqrt carried in double-float:
    r = y0 + (s - y0^2) / (2 y0), with y0^2 exact via two_prod and the
    subtraction error-free in dd — accurate to ~2^-45 relative before the
    single final rounding (matches float64-computed-then-rounded sqrt except
    within ~1e-12 of a rounding boundary). s == 0 returns 0."""
    y0 = jnp.sqrt(sh)
    p_h, p_l = _two_prod(y0, y0)
    e_h, e_l = _dd_add(sh, sl, -p_h, -p_l)
    denom = 2.0 * y0
    safe = jnp.where(denom > 0, denom, 1.0)
    corr = (e_h + e_l) / safe
    r_h, r_l = _fast_two_sum(y0, corr)
    return jnp.where(sh > 0, r_h + r_l, 0.0)


# log2(1+u) series on u in [sqrt(2)/2 - 1, sqrt(2) - 1): use
# log(m) = 2 atanh(z), z = (m-1)/(m+1), evaluated in double-float.
# Truncating before term k costs (z^2)^k/(2k+1) relative to the sum: the
# reduced range gives |z| <= 0.1716, z^2 <= 0.02944, so 9 terms (k=0..8)
# leave 0.02944^9/19 = 8.4e-16 — below the double-float working precision
# (~2^-48 = 3.6e-15) — while 8 terms leave 3.2e-14, which measurably
# breaks correct rounding (~1e-4 of random inputs miss by 1 ulp;
# tests/test_dd.py pins the contract against f64-then-rounded). 9 is the
# minimal length that preserves the contract; the original 11 wasted two
# dd multiply-adds per element on the tuning hot path.
_N_TERMS = 9


def log2_cr(x: jax.Array) -> jax.Array:
    """Correctly-rounded float32 log2(x) for x > 0 (elementwise).

    Exponent/mantissa split by integer bit ops (exact), mantissa log via the
    atanh series in double-float arithmetic, one final rounding to f32."""
    rh, rl = _log2_dd(x)
    return rh + rl


def _log2_dd(x: jax.Array):
    """log2(x) as an unevaluated double-float pair (~2^-45 relative)."""
    x = x.astype(jnp.float32)
    bits = jax.lax.bitcast_convert_type(x, jnp.int32)
    e = (bits >> 23) - 127
    m_bits = (bits & jnp.int32(0x7FFFFF)) | jnp.int32(0x3F800000)
    m = jax.lax.bitcast_convert_type(m_bits, jnp.float32)  # [1, 2)
    # reduce to [sqrt(2)/2, sqrt(2)) for a small series argument
    big = m > jnp.float32(1.4142135)
    m = jnp.where(big, m * jnp.float32(0.5), m)
    e = (e + big.astype(jnp.int32)).astype(jnp.float32)
    # z = (m-1)/(m+1) in double-float. m-1 is exact (Sterbenz); m+1 is NOT —
    # the ulp doubles crossing 2.0, so carry the denominator as an exact
    # two_sum pair or the whole quotient inherits its ~2^-25 rounding.
    num = m - jnp.float32(1.0)
    den_h, den_l = _two_sum(m, _opaque(m, 1.0))
    y0 = 1.0 / den_h
    zh, zl = _two_prod(num, y0)
    # refine: correction = (num - den*z) * y0
    dz_h, dz_l = _dd_mul_f(den_h, jnp.zeros_like(den_h), zh)
    corr = ((num - dz_h) - dz_l - den_h * zl - den_l * zh) * y0
    zh, zl = _fast_two_sum(zh, zl + corr)
    # s = z^2 in dd; atanh series: z * (1 + s/3 + s^2/5 + ...). The Horner
    # coefficients 1/(2k+1) must themselves be double-float: a bare
    # f32(1/3) carries ~1e-8 relative error, which propagates ~3e-10 into
    # the series sum — 1e4x the dd working precision and enough to miss
    # correct rounding ~1e-4 of the time (tests/test_dd.py caught this).
    sh, sl = _dd_mul(zh, zl, zh, zl)
    c_hi = np.float32(1.0 / (2 * _N_TERMS + 1))
    c_lo = np.float32(1.0 / (2 * _N_TERMS + 1) - np.float64(c_hi))
    th = _opaque(zh, c_hi)
    tl = _opaque(zh, c_lo)
    for k in range(_N_TERMS - 1, -1, -1):
        th, tl = _dd_mul(th, tl, sh, sl)
        c_hi = np.float32(1.0 / (2 * k + 1))
        c_lo = np.float32(1.0 / (2 * k + 1) - np.float64(c_hi))
        th, tl = _dd_add(th, tl, _opaque(th, c_hi), _opaque(th, c_lo))
    # ln(m) = 2 z * series
    lh, ll = _dd_mul(zh, zl, th, tl)
    lh, ll = _dd_mul_f(lh, ll, jnp.float32(2.0))
    # log2(m) = ln(m) / ln(2): multiply by 1/ln2 in dd
    inv_ln2_h = jnp.float32(1.4426950216293335)
    inv_ln2_l = jnp.float32(1.9259629911266175e-08)
    qh, ql = _dd_mul(lh, ll, jnp.broadcast_to(inv_ln2_h, lh.shape),
                     jnp.broadcast_to(inv_ln2_l, lh.shape))
    # + e (exact integer-valued f32)
    return _dd_add(qh, ql, e, jnp.zeros_like(e))


_INV_LN2 = np.float32(1.4426950408889634)
_INV_LN2_HI = np.float32(1.4426950216293335)      # fl32(1/ln 2)
_INV_LN2_LO = np.float32(1.9259629911266175e-08)  # 1/ln2 - HI (dd tail)


def log1p_cr(x: jax.Array) -> jax.Array:
    """Correctly-rounded float32 log1p(x) for x >= 0 (elementwise).

    Why: this backend's native log1p is only ~100-ulp faithful (measured
    2.3e-5 absolute on inputs ~0.1), which the gammatone channel's z-score
    (std ~0.005) amplifies to ~5e-3 — the entire remaining parity gap of
    that channel (PARITY.md). Method: u = 1 + x captured EXACTLY as a
    two_sum pair (uh, ul); log2(uh) via the dd atanh series (_log2_dd); the
    dropped tail enters as the correction (v - v^2/2)/ln2, v = ul/uh,
    itself in double-float (v is up to 6% of the result for x ~ 1e-6, so a
    bare-f32 first-order correction leaves ~0.05-ulp errors that miss
    correct rounding on ~0.1% of inputs); multiply by ln2 in double-float;
    one final rounding."""
    x = x.astype(jnp.float32)
    uh, ul = _two_sum(_opaque(x, 1.0), x)
    lh, ll = _log2_dd(uh)
    # v = ul/uh as a Newton-refined double-float (residual folded once)
    y0 = 1.0 / uh
    vh, vl = _two_prod(ul, y0)
    uv_h, uv_l = _dd_mul_f(uh, jnp.zeros_like(uh), vh)
    vl = vl + (((ul - uv_h) - uv_l) - uh * vl) * y0
    # log2(u) = log2(uh) + (v - v^2/2 + O(v^3))/ln2; v <= ~6e-8 so the
    # v^3 term (~1e-22 abs) is far below dd precision
    wh, wl = _dd_add(vh, vl, -0.5 * (vh * vh), jnp.zeros_like(vh))
    ch, cl = _dd_mul(wh, wl,
                     jnp.broadcast_to(_INV_LN2_HI, wh.shape),
                     jnp.broadcast_to(_INV_LN2_LO, wh.shape))
    lh, ll = _dd_add(lh, ll, ch, cl)
    rh, rl = _dd_mul(lh, ll, jnp.broadcast_to(_LN2_HI, lh.shape),
                     jnp.broadcast_to(jnp.float32(_LN2_LO), lh.shape))
    return rh + rl
