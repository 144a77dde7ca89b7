"""One-hot select replacements for tiny-axis dynamic indexing.

The column physics indexes fixed, tiny vertical axes (MSNOW=3 snow
slots, NSOIL=4 soil layers, 12 climatology months) with *traced*
integers — the snow-layer shuffles (snow.py), the water-table layer
(soilwater.py groundwater), the phenology month.  Lowered naively these
become per-point gather/scatter HLOs, and under ``vmap`` XLA
serializes the scatters.  Over an axis of length 3–12, a one-hot
compare-and-select is pure elementwise selects that fuse into the
surrounding elementwise pipeline.

All helpers are exact (bit-identical to the gather/scatter they
replace): the index is assumed in-bounds, so exactly one lane matches
and the select/sum touches exactly the indexed element.
"""

import jax.numpy as jnp


def _iota(x):
    return jnp.arange(x.shape[-1])


def vsel(x, idx):
    """x[..., idx] with a traced in-bounds ``idx`` (scalar per column):
    an unrolled where-chain over the tiny last axis.  Exactly one
    branch matches, so this is bit-identical to a gather.  The
    unrolled form never materializes a layer-axis mask."""
    # seeded from element 0: idx is in-bounds, so idx==0 keeps x[..., 0]
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = jnp.where(idx == k, x[..., k], acc)
    return acc


def vset(x, idx, val):
    """x.at[..., idx].set(val) with a traced index."""
    return jnp.stack([jnp.where(idx == k, val, x[..., k])
                      for k in range(x.shape[-1])], axis=-1)


def vadd(x, idx, val):
    """x.at[..., idx].add(val) with a traced index."""
    return jnp.stack([jnp.where(idx == k, x[..., k] + val, x[..., k])
                      for k in range(x.shape[-1])], axis=-1)


def cumsum_small(x):
    """Sequential prefix sum over the tiny last axis (3..100 elems):
    same left-to-right association as a serial cumsum, built from
    static slices + adds."""
    outs = []
    acc = None
    for k in range(x.shape[-1]):
        acc = x[..., k] if acc is None else acc + x[..., k]
        outs.append(acc)
    return jnp.stack(outs, axis=-1)


def vperm(x, idxvec):
    """x[idxvec] for a traced in-bounds index vector over the same tiny
    axis (the snow divide() top-aligned permutation): L x L unrolled
    selects for axis length L (same op count as the previous one-hot
    matrix, no layer-axis mask materialized)."""
    return jnp.stack([vsel(x, idxvec[..., i])
                      for i in range(x.shape[-1])], axis=-1)
