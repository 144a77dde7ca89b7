"""The one-hot select helpers (numerics/select.py) and the layer-array
idioms the column physics builds on them, batched with plain
``jax.vmap``, against a NumPy loop over columns."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from noahmp_jax.numerics.select import vsel, vset, vadd, vperm, \
    cumsum_small

L = 7
N = 32


def _np_set(v, i, x):
    out = v.copy()
    out[i] = x
    return out


def _np_add(v, i, x):
    out = v.copy()
    out[i] += x
    return out


# name -> (column function on (s scalar, v (L,)), NumPy reference,
#          exact?)  Reductions (jnp.sum) may associate differently
# from NumPy's, so those compare to f32 round-off instead of bitwise.
CASES = {
    "shift_concat": (
        lambda s, v: jnp.concatenate([jnp.zeros(1, v.dtype), v[:-1]]) - v,
        lambda s, v: np.concatenate([np.zeros(1, v.dtype), v[:-1]]) - v,
        True),
    "arange_mask": (
        lambda s, v: jnp.sum(jnp.where(
            jnp.arange(L) >= (s > 1.5).astype(jnp.int32) * 3, v, 0.0)),
        lambda s, v: v[int(s > 1.5) * 3:].sum(dtype=np.float32),
        False),
    "vsel": (
        lambda s, v: vsel(v, (s > 1.5).astype(jnp.int32) * 2),
        lambda s, v: v[int(s > 1.5) * 2],
        True),
    "vset": (
        lambda s, v: vset(v, (s > 1.5).astype(jnp.int32) * 2, s),
        lambda s, v: _np_set(v, int(s > 1.5) * 2, s),
        True),
    "vadd": (
        lambda s, v: vadd(v, (s > 1.2).astype(jnp.int32), s),
        lambda s, v: _np_add(v, int(s > 1.2), s),
        True),
    "vperm": (
        lambda s, v: vperm(v, jnp.clip(
            jnp.arange(L) + (s > 1.5).astype(jnp.int32), 0, L - 1)),
        lambda s, v: v[np.clip(np.arange(L) + int(s > 1.5), 0, L - 1)],
        True),
    "cumsum": (
        lambda s, v: cumsum_small(v),
        lambda s, v: np.cumsum(v, dtype=np.float32),
        True),
    "stack": (
        lambda s, v: jnp.stack([s, s * 2, jnp.sum(v)], axis=0) * 1.0,
        lambda s, v: np.array([s, s * 2, v.sum(dtype=np.float32)],
                              np.float32),
        False),
    "bool_layer_where": (
        lambda s, v: jnp.where((v > 0.5) & (s > 1.5), v, -v),
        lambda s, v: np.where((v > 0.5) & (s > 1.5), v, -v),
        True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_select_batched_matches_numpy_loop(name):
    col, ref, exact = CASES[name]
    s = np.linspace(1.0, 2.0, N, dtype=np.float32)
    v = np.linspace(0.0, 1.0, N * L, dtype=np.float32).reshape(N, L)
    got = np.asarray(jax.vmap(col)(jnp.asarray(s), jnp.asarray(v)))
    want = np.stack([np.asarray(ref(s[j], v[j]), np.float32)
                     for j in range(N)])
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
