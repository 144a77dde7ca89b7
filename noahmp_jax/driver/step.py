"""Batched, jitted model step and time loop.

``make_step`` vmaps the column physics over the leading land-point axis
and jits with donated state buffers; ``simulate`` runs a ``lax.scan``
over timesteps with the state as carry (the time axis is inherently
sequential, SURVEY.md section 5).
"""

from functools import partial
import jax
import jax.numpy as jnp

from ..physics.sflx import column_step


def make_step(params, opts, dt, jit=True, donate=True, layout="major"):
    """Build step(static, forcing, state) -> (state, flux), batched over
    all inputs.  ``opts`` and ``dt`` are static.

    ``params`` is passed as an explicit jit argument on every call —
    NOT closed over.  Closure params become HLO constants, and lowering
    a device-resident constant forces a device->host fetch
    (mlir.ir_constant -> array._value) and bakes the tables into the
    executable.  As an argument, a device-resident table stays on
    device and the traced gathers are identical.

    ``layout``: "major" batches over the leading axis (default);
    "minor" batches over the trailing axis, so the small layer arrays
    (L in {3,4,7}) are (L, n) with the land points contiguous.  Use
    ``batch_to_layout`` to convert pytrees.
    """
    ax = 0 if layout == "major" else -1

    def _step(params, static, forcing, state):
        col = lambda p, st, f, s: column_step(  # noqa: E731
            p, opts, st, f, s, jnp.asarray(dt, jnp.float32))
        batched = jax.vmap(col, in_axes=(None, ax, ax, ax),
                           out_axes=ax)
        return batched(params, static, forcing, state)

    if jit:
        jitted = jax.jit(_step, donate_argnums=(3,) if donate else ())
    else:
        jitted = _step

    def step(static, forcing, state):
        return jitted(params, static, forcing, state)

    step.jitted = jitted  # 4-arg form, for lowering inspection/tests
    step.params = params
    return step


def batch_to_layout(tree, layout):
    """Move the leading batch axis of every leaf to the layout's batch
    position ("major": unchanged; "minor": trailing)."""
    if layout == "major":
        return tree
    return jax.tree.map(
        lambda x: jnp.moveaxis(x, 0, -1) if jnp.ndim(x) > 1 else x,
        tree)


def simulate(params, opts, dt, static, forcings, state0,
             collect_fluxes=True):
    """Run a forcing sequence.  ``forcings`` is a Forcing pytree whose
    leaves have a leading time axis (then the batch axis).  Returns
    (final_state, fluxes-stacked-over-time or last flux).

    params/static are scan-invariant closure values here; callers who
    jit this should pass them through as jit arguments (see
    ``make_simulate``) so device-resident tables are never lowered as
    HLO constants."""

    def body(state, forcing):
        col = partial(column_step, params, opts)
        batched = jax.vmap(col, in_axes=(0, 0, 0, None))
        new_state, flux = batched(static, forcing, state,
                                  jnp.asarray(dt, jnp.float32))
        return new_state, (flux if collect_fluxes else None)

    final_state, fluxes = jax.lax.scan(body, state0, forcings)
    return final_state, fluxes


STRICT_SENTINEL = 2 ** 30  # "no step violated yet"


def make_chunk_step(params, opts, dt, acc_spec=(), donate=True,
                    mesh=None, strict_budgets=False):
    """Multi-step dispatch for the offline driver: one jitted
    ``lax.scan`` advances a whole chunk of timesteps, accumulating
    flux statistics on device in the scan carry.

    Per-step dispatch costs one host->device round trip per step *plus*
    one per eager writer op, which dominates wall-clock at small batch.
    Chunking gives the production driver one call per chunk, forcing
    uploaded as stacked (T, n) leaves, accumulated statistics fetched
    only at cadence boundaries.

    ``acc_spec``: tuple of (flux_field, op) with op "sum" (for output
    window means) or "absmax" (for conservation budget checks).

    Returns chunk(static, forcings, state, acc) -> (state, acc) where
    ``forcings`` leaves are stacked (T, n) and ``acc`` is a tuple of
    per-field running statistics in acc_spec order.  The callable is
    cached per chunk length T by jit's shape cache.

    ``mesh``: shard the land-point axis (the stacked forcing leaves
    shard their second axis); params replicated, as in dist.mesh.

    ``strict_budgets``: reproduce the reference's per-step fatal abort
    semantics (func:688-721: |ERRSW| > 0.01 or |ERRENG| > 0.01 W/m2
    kills the run at that step) inside the device-side scan.  The chunk
    then returns (state, acc, bad_step): ``bad_step`` is the 0-based
    chunk-local index of the FIRST violating step (STRICT_SENTINEL if
    none); the state stops advancing after it — exactly the state the
    aborting reference would leave — and the caller raises.
    """
    # strict mode reproduces the reference's exact abort bounds
    # (0.01 W/m2 for BOTH budgets, func:691,715) — not the f32-widened
    # ENG_TOL used by the advisory host-side check
    STRICT_TOL = 0.01

    def _chunk(params, static, forcings, state, acc,
               bad_step=None):
        def body(carry, xs):
            if strict_budgets:
                st, acc, bad = carry
                forcing, i = xs
                frozen = i > bad  # a previous step already aborted
            else:
                st, acc = carry
                forcing = xs
            col = lambda p, s, f, x: column_step(  # noqa: E731
                p, opts, s, f, x, jnp.asarray(dt, jnp.float32))
            new_st, flux = jax.vmap(col, in_axes=(None, 0, 0, 0))(
                params, static, forcing, st)
            new_acc = tuple(
                a + getattr(flux, f) if op == "sum"
                else jnp.maximum(a, jnp.abs(getattr(flux, f)))
                for a, (f, op) in zip(acc, acc_spec))
            if not strict_budgets:
                return (new_st, new_acc), None
            violated = jnp.any((jnp.abs(flux.errsw) > STRICT_TOL)
                               | (jnp.abs(flux.erreng) > STRICT_TOL))
            bad = jnp.minimum(
                bad, jnp.where(violated & ~frozen, i, STRICT_SENTINEL))
            keep = lambda old, new: jax.tree.map(  # noqa: E731
                lambda o, x: jnp.where(frozen, o, x), old, new)
            return (keep(st, new_st), keep(acc, new_acc), bad), None

        if strict_budgets:
            T = jax.tree.leaves(forcings)[0].shape[0]
            idx = jnp.arange(T, dtype=jnp.int32)
            (state, acc, bad_step), _ = jax.lax.scan(
                body, (state, acc, bad_step), (forcings, idx))
            return state, acc, bad_step
        (state, acc), _ = jax.lax.scan(body, (state, acc), forcings)
        return state, acc

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..dist.mesh import batch_sharding, replicated, POINTS_AXIS
        sh_b = batch_sharding(mesh)
        sh_r = replicated(mesh)
        sh_t = NamedSharding(mesh, P(None, POINTS_AXIS))
        shardings = (sh_r, sh_b, sh_t, sh_b, sh_b)
        if strict_budgets:
            shardings = shardings + (sh_r,)
        jitted = jax.jit(
            _chunk,
            in_shardings=shardings,
            donate_argnums=(3, 4) if donate else ())
    else:
        jitted = jax.jit(_chunk,
                         donate_argnums=(3, 4) if donate else ())

    if strict_budgets:
        def chunk(static, forcings, state, acc):
            return jitted(params, static, forcings, state, acc,
                          jnp.asarray(STRICT_SENTINEL, jnp.int32))
    else:
        def chunk(static, forcings, state, acc):
            return jitted(params, static, forcings, state, acc)

    chunk.jitted = jitted
    chunk.acc_spec = tuple(acc_spec)
    return chunk


def make_simulate(params, opts, dt, collect_fluxes=True, donate=True):
    """Jitted multi-step scan with params/static as explicit arguments
    (same closure-constant rationale as ``make_step``).  Returns
    sim(static, forcings, state0) -> (final_state, fluxes)."""

    def _sim(params, static, forcings, state0):
        return simulate(params, opts, dt, static, forcings, state0,
                        collect_fluxes=collect_fluxes)

    jitted = jax.jit(_sim, donate_argnums=(3,) if donate else ())

    def sim(static, forcings, state0):
        return jitted(params, static, forcings, state0)

    sim.jitted = jitted
    return sim
