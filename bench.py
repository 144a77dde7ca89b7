"""Benchmark: land-point-steps/sec of the jitted column step on one
device (the BASELINE.json primary metric).  Prints one JSON line.

    python bench.py

The step is the vmapped column physics on 65,536 identical columns under
constant summer forcing (``__graft_entry__._build``).  Beside the rate
it reports XLA's own cost model (bytes accessed per point-step) and the
device bandwidth of a large elementwise copy timed in the same run, so
the step's bandwidth share needs no peak from a table.

The reference publishes no numbers (BASELINE.md); vs_baseline is the
ratio to the serial C++ reference column (native/) on one host core.
"""

import json
import time

import jax
import jax.numpy as jnp


def _device():
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _timed(fn, state, nsteps):
    """Seconds per call of ``state = fn(state)`` over ``nsteps`` calls
    after two warm-up calls; block_until_ready is the barrier."""
    state = jax.block_until_ready(fn(fn(state)))
    t0 = time.perf_counter()
    for _ in range(nsteps):
        state = fn(state)
    jax.block_until_ready(state)
    return (time.perf_counter() - t0) / nsteps


def time_step(n, nsteps=20):
    """Time the jitted column step at n points.  Returns a dict with
    ms per step, point-steps/s, compile seconds and XLA's cost-model
    bytes accessed per point-step."""
    from __graft_entry__ import _build
    from noahmp_jax.physics.sflx import column_step

    params, opts, static, forcing, state = _build(n)
    # one transfer up front so the timed loop passes device buffers
    params, static, forcing = jax.device_put((params, static, forcing))

    # params/static/forcing as jit args (loop-invariant buffers), not
    # closure constants (driver/step.py)
    def fn(params, static, forcing, state):
        col = lambda p, st, f, s: column_step(  # noqa: E731
            p, opts, st, f, s, jnp.float32(900.0))
        return jax.vmap(col, in_axes=(None, 0, 0, 0))(
            params, static, forcing, state)[0]

    t0 = time.perf_counter()
    compiled = jax.jit(fn, donate_argnums=(3,)).lower(
        params, static, forcing, state).compile()
    compile_s = time.perf_counter() - t0
    cost = compiled.cost_analysis()
    if isinstance(cost, list):  # older jax returns [dict]
        cost = cost[0]

    sec = _timed(lambda s: compiled(params, static, forcing, s), state,
                 nsteps)
    return {"n": n, "steps": nsteps, "ms_per_step": sec * 1e3,
            "point_steps_per_sec": n / sec, "compile_s": compile_s,
            "bytes_per_point_step": cost["bytes accessed"] / n}


def copy_bandwidth(nbytes=1 << 30, reps=20):
    """Device bandwidth in bytes/s of an elementwise pass over a
    ``nbytes`` f32 array (reads nbytes, writes nbytes)."""
    x = jnp.zeros((nbytes // 4,), jnp.float32)
    step = jax.jit(lambda a: a + 1.0)
    sec = _timed(step, x, reps)
    return 2 * nbytes / sec


def time_thomas(n, L=7, reps=20):
    """Time the jitted batched Thomas solve (numerics/tridiag.py) on an
    (n, L) system.  Returns (seconds per solve, bytes moved per solve:
    four (n, L) inputs read, one written)."""
    from noahmp_jax.numerics.tridiag import thomas

    k = jax.random.split(jax.random.PRNGKey(0), 4)
    a, c, d = (jax.random.uniform(kk, (n, L), jnp.float32, -0.5, 0.5)
               for kk in k[:3])
    b = jax.random.uniform(k[3], (n, L), jnp.float32, 1.5, 3.0)
    solve = jax.jit(jax.vmap(thomas))
    sec = _timed(lambda dd: solve(a, b, c, dd), d, reps)
    return sec, 5 * n * L * 4


def main():
    from noahmp_jax.utils import enable_compile_cache
    enable_compile_cache()
    n = 65536  # land points on one device
    r = time_step(n)
    bw = copy_bandwidth()

    # baseline: the serial C++ reference column on one host core
    from __graft_entry__ import _build
    from noahmp_jax import native
    params, opts, static, forcing, state = _build(256)
    baseline = native.bench_native(params, opts, static, forcing, state,
                                   steps=5, threads=1)

    print(json.dumps({
        "metric": "land-point-steps/sec/chip",
        "value": round(r["point_steps_per_sec"], 1),
        "unit": "point-steps/s",
        "vs_baseline": round(r["point_steps_per_sec"] / baseline, 2),
        "n": n,
        "ms_per_step": r["ms_per_step"],
        "compile_s": r["compile_s"],
        "bytes_per_point_step": r["bytes_per_point_step"],
        "copy_GBps": bw / 1e9,
        "step_bandwidth_share": (r["bytes_per_point_step"]
                                 * r["point_steps_per_sec"] / bw),
        "device": _device(),
    }))


if __name__ == "__main__":
    main()
