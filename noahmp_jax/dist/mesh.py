"""SPMD scale-out over the land-point axis.

The reference is serial (SURVEY.md section 2.6); the one first-class
parallel dimension is land points, which are embarrassingly parallel.
We shard the batch axis of every state/forcing leaf over a 1-D device
mesh with NamedSharding; parameters are replicated (tiny tables); the
only collectives are diagnostics reductions.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..physics.sflx import column_step

POINTS_AXIS = "points"


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or given) devices along the land-point axis."""
    if devices is None:
        devices = jax.devices()
    import numpy as np
    return Mesh(np.asarray(devices), (POINTS_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(POINTS_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(tree, mesh: Mesh):
    """Place every leaf of a batched pytree with its leading axis sharded
    over the points axis (collective-free; see put_global)."""
    sh = batch_sharding(mesh)
    return jax.tree.map(lambda x: put_global(x, sh), tree)


def put_global(x, sh: NamedSharding):
    """Collective-free placement of host data onto a (possibly
    multi-process) sharding.

    In a REAL multi-process job, ``jax.device_put(host_array, s)``
    runs a cross-process ``assert_equal`` allgather for every call
    (jax dispatch.py).  That is wrong for us three times over, all
    observed via scripts/mp_spmd_cpu.py:

    - the parameter tables deliberately preserve the reference's nan4
      "unset" sentinels (module_noahmp_const.f90:12-13) and identical
      NaN-bearing arrays FAIL the elementwise ``==`` check;
    - the driver uploads forcing chunks from a prefetch thread while
      the main thread places other arrays — two processes interleave
      those hidden collectives differently and the Gloo transport
      dies with a payload-size mismatch;
    - a collective per placed leaf per chunk is pure overhead: every
      process already holds the data.

    So: slice the host array per addressable device and assemble the
    global jax.Array directly — no communication at all."""
    import numpy as np
    if jax.process_count() == 1:
        return jax.device_put(x, sh)
    if isinstance(x, jax.Array) and not getattr(x, "is_deleted",
                                                lambda: False)():
        if x.sharding == sh:
            return x  # already placed
        x = np.asarray(x)  # local fetch (callers pass host/replicated)
    arr = np.asarray(x)
    shards = [jax.device_put(arr[idx], d)
              for d, idx in
              sh.addressable_devices_indices_map(arr.shape).items()]
    return jax.make_array_from_single_device_arrays(
        arr.shape, sh, shards)


_put_replicated = put_global  # backwards-compat alias


def replicate(tree, mesh: Mesh):
    sh = replicated(mesh)
    return jax.tree.map(lambda x: put_global(x, sh), tree)


class StepDiagnostics(NamedTuple):
    """Globally-reduced conservation diagnostics (the only cross-chip
    communication in the model)."""
    max_abs_errsw: jnp.ndarray
    max_abs_erreng: jnp.ndarray
    max_abs_errwat: jnp.ndarray
    mean_fsh: jnp.ndarray
    mean_fsa: jnp.ndarray


def make_sharded_step(params, opts, dt, mesh: Mesh, donate=True,
                      with_diagnostics=True):
    """Build a pjit-compiled step over the mesh.

    Inputs/outputs carry NamedSharding over the points axis; XLA inserts
    the (only) collectives for the scalar diagnostics reductions.
    """
    sh_b = batch_sharding(mesh)
    sh_r = replicated(mesh)

    # Params travel as explicit (replicated) jit arguments, never as
    # closure constants: lowering a device-resident constant forces a
    # device->host fetch and bakes the tables into the executable (see
    # driver/step.py make_step).  NaN-sentinel tables need the
    # assert-free placement (_put_replicated).
    params = jax.tree.map(lambda x: _put_replicated(x, sh_r), params)

    def _step(params, static, forcing, state):
        col = partial(column_step, params, opts)
        new_state, flux = jax.vmap(col, in_axes=(0, 0, 0, None))(
            static, forcing, state, jnp.asarray(dt, jnp.float32))
        if not with_diagnostics:
            return new_state, flux, None
        diags = StepDiagnostics(
            max_abs_errsw=jnp.max(jnp.abs(flux.errsw)),
            max_abs_erreng=jnp.max(jnp.abs(flux.erreng)),
            max_abs_errwat=jnp.max(jnp.abs(flux.errwat)),
            mean_fsh=jnp.mean(flux.fsh),
            mean_fsa=jnp.mean(flux.fsa),
        )
        return new_state, flux, diags

    # output shardings propagate from the inputs
    jitted = jax.jit(
        _step,
        in_shardings=(sh_r, sh_b, sh_b, sh_b),
        donate_argnums=(3,) if donate else (),
    )

    def step(static, forcing, state):
        return jitted(params, static, forcing, state)

    step.jitted = jitted
    step.params = params
    return step


def process_slice(mesh: Mesh, n: int):
    """Global row range [lo, hi) of the land-point axis owned by THIS
    process under ``batch_sharding(mesh)`` (1-D mesh in device order,
    equal blocks).  Used by the sharded OutputWriter so each host
    writes only its addressable slice."""
    devs = list(mesh.devices.flat)
    ndev = len(devs)
    if n % ndev:
        raise ValueError(f"n={n} not divisible by {ndev} devices")
    per = n // ndev
    pid = jax.process_index()
    mine = [i for i, d in enumerate(devs) if d.process_index == pid]
    if not mine:
        return 0, 0
    if mine != list(range(mine[0], mine[-1] + 1)):
        raise ValueError(
            "this process's devices are not contiguous in the mesh; "
            "order the mesh by process so output slices are contiguous")
    return mine[0] * per, (mine[-1] + 1) * per


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Multi-host init (no-op on a single host).  Mirrors
    jax.distributed.initialize defaults."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address, num_processes,
                                   process_id)
