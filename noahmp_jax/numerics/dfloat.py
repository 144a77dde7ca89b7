"""Double-float (two-float f32) arithmetic for the one place the
reference computes in double precision: the groundwater S_NODE matric
potential, ``SMPFZ = -PSISAT*1000*S_NODE**(-BEXP)`` with S_NODE held in
``real(KIND=8)`` (reference core/module_noahmp_func.f90:6501,6560-6563).

The step runs in f32 with no x64 mode, so the build carries the value
as an unevaluated sum of two f32s (Dekker/Knuth error-free transforms,
~48-bit effective mantissa) and rounds once at the end — the result
matches the reference's f64-computed, f32-stored SMPFZ to <=1 ulp
(tests/test_numerics.py::test_snode_dfloat_bitexact asserts exactness
on >99.9% of a full-range sweep and <=1 ulp always).  Everything here
is plain f32 adds, muls and selects.

All helpers are elementwise over jnp arrays; a double-float value is a
``(hi, lo)`` tuple with |lo| <= ulp(hi)/2.
"""

import math

import numpy as np
import jax.numpy as jnp
from jax import lax

# All constants are plain Python floats (exactly f32-representable
# where it matters): they inline as jaxpr literals, and weak-type
# promotion rounds them to the intended f32 values at use sites.
_SPLIT = 4097.0                       # 2**12 + 1 (Veltkamp, f32)
_INV_LN2 = 1.4426950408889634
_SQRT2 = 1.4142135623730951


def _dfc(x):
    """Python/f64 constant -> (hi, lo) pair of f32-exact Python floats."""
    hi = float(np.float32(x))
    lo = float(np.float32(np.float64(x) - np.float64(hi)))
    return hi, lo


_LN2 = _dfc(0.6931471805599453094172321)


def two_sum(a, b):
    """Error-free sum: a+b = s+e exactly (round-to-nearest)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free sum assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: a*b = p+e exactly (Dekker, no FMA)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df(hi, lo=None):
    hi = jnp.asarray(hi, jnp.float32)
    return (hi, jnp.zeros_like(hi) if lo is None else
            jnp.broadcast_to(jnp.asarray(lo, jnp.float32), hi.shape))


def df_add(a, b):
    s, e = two_sum(a[0], b[0])
    e = e + (a[1] + b[1])
    return fast_two_sum(s, e)


def df_mul(a, b):
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return fast_two_sum(p, e)


def df_div(a, b):
    q1 = a[0] / b[0]
    r = df_add(a, df_neg(df_mul((q1, jnp.zeros_like(q1)), b)))
    q2 = r[0] / b[0]
    return fast_two_sum(q1, q2)


def df_neg(a):
    return (-a[0], -a[1])


def _exp2i(k):
    """2**k for integer-valued f32 k in [-127, 127], exactly, by
    exponentiation-by-squaring over exact power-of-two factors
    (multiplying exact powers of two is exact in any backend)."""
    a = jnp.abs(k)
    result = jnp.ones_like(k)
    sq = jnp.full_like(k, 2.0)
    for i in range(7):                 # 7 bits cover |k| <= 127
        ki = jnp.floor(a * (1.0 / (1 << i)))
        bit = ki - 2.0 * jnp.floor(0.5 * ki)
        result = jnp.where(bit > 0.5, result * sq, result)
        sq = sq * sq
    return jnp.where(k < 0, 1.0 / result, result)


def _frexp(x):
    """x = m * 2**e with m in [sqrt(1/2), sqrt(2)), for x in
    [2**-10, 2) — the S_NODE domain is [0.01, 1].  Exact
    doubling/halving ladder instead of exponent-field bitcasts
    (see _exp2i)."""
    m = jnp.asarray(x, jnp.float32)
    e = jnp.zeros_like(m)
    for _ in range(10):
        small = m < jnp.float32(1.0 / _SQRT2)
        m = jnp.where(small, m * 2.0, m)   # exact scaling
        e = jnp.where(small, e - 1.0, e)
    big = m >= _SQRT2
    m = jnp.where(big, 0.5 * m, m)
    e = jnp.where(big, e + 1.0, e)
    return m, e


# atanh-series coefficients 1/(2k+1), k = 11..1, as df constants (an
# f32-only 1/3 would already cost ~1e-9 relative — above the 2^-47
# target), consumed Horner-style over z^2
_ATANH_C = [_dfc(1.0 / (2 * k + 1)) for k in range(11, 0, -1)]
# exp Taylor 1/n!, n = 13..1
_EXP_C = [_dfc(1.0 / math.factorial(n)) for n in range(13, 0, -1)]


def _const_like(c, x):
    return (jnp.broadcast_to(c[0], x.shape), jnp.broadcast_to(c[1], x.shape))


def df_log(x):
    """Double-float ln(x) for positive normal f32 x (relative error
    ~2^-47).  atanh series: ln m = 2*atanh((m-1)/(m+1)), |z| <= 0.172
    after the sqrt(2) reduction; 11 df terms reach ~2^-50."""
    m, e = _frexp(x)
    num = df(m - 1.0)              # exact (Sterbenz: m in [0.70, 1.42])
    den = two_sum(m, jnp.ones_like(m))
    z = df_div(num, den)
    z2 = df_mul(z, z)
    acc = _const_like(_ATANH_C[0], m)
    for c in _ATANH_C[1:]:
        acc = df_add(df_mul(acc, z2), _const_like(c, m))
    atanh = df_add(df_mul(df_mul(acc, z2), z), z)
    lnm = df_add(atanh, atanh)     # *2
    k_ln2 = df_mul(df(e), _const_like(_LN2, e))
    return df_add(k_ln2, lnm)


def df_log_df(x):
    """df_log for a double-float input: ln(hi+lo) = ln(hi) + lo/hi +
    O((lo/hi)^2); the dropped term is < 2^-48 relative."""
    return df_add(df_log(x[0]), df(x[1] / x[0]))


def df_exp(y):
    """Double-float exp(y) for |y| <= ~87 (relative error ~|y|*2^-47).
    Range-reduce by ln2; 13-term df Taylor on r in [-0.347, 0.347]."""
    k = jnp.clip(jnp.round(y[0] * _INV_LN2), -126.0, 126.0)
    r = df_add(y, df_neg(df_mul(df(k), _const_like(_LN2, k))))
    acc = _const_like(_EXP_C[0], y[0])
    for c in _EXP_C[1:]:
        acc = df_add(df_mul(acc, r), _const_like(c, y[0]))
    acc = df_add(df_mul(acc, r), df(jnp.ones_like(y[0])))
    s = _exp2i(k)
    return (acc[0] * s, acc[1] * s)   # power-of-two scale is exact


def df_pow(s, p):
    """Double-float s**p for positive normal f32 s and f32 p."""
    return df_exp(df_mul(df_log(s), df(p)))


def smpfz_f64_parity(s_node, bexp, psisat, at_clip):
    """-PSISAT*1000*S_NODE**(-BEXP) to f64 parity, rounded once to f32.

    Reference semantics (func:6560-6563): S_NODE = the *f32* saturation
    ratio widened to real*8, except at the lower clamp where it is the
    exact double 0.01 (max against 0.01_8, slightly above f32(0.01) —
    ``at_clip`` marks those points); the RHS of the SMPFZ assignment
    promotes to real*8 through S_NODE and rounds once into the real*4
    SMPFZ.
    """
    s_node = jnp.asarray(s_node, jnp.float32)
    bexp = jnp.asarray(bexp, jnp.float32)
    psisat = jnp.asarray(psisat, jnp.float32)
    clip_lo = float(np.float32(np.float64(0.01)
                               - np.float64(np.float32(0.01))))
    lo = jnp.where(at_clip, clip_lo, 0.0).astype(jnp.float32)
    p = df_exp(df_mul(df_log_df((s_node, lo)), df(-bexp)))
    scale = two_prod(psisat, jnp.asarray(1000.0, jnp.float32))
    v = df_mul(p, scale)
    return -(v[0] + v[1])
