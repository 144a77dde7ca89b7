"""Roofline of the XLA column step on the device it runs on.

Pulls XLA's own cost model for the compiled step (flops,
transcendentals, bytes accessed) and its memory analysis, measures the
step rate (bench.time_step) and the bandwidth of a large elementwise
copy timed in the same run (bench.copy_bandwidth), and reports the
step's achieved bandwidth as a share of that copy.  No peak is taken
from a table.  Optionally captures a jax.profiler trace (--trace DIR).

Usage: python benchmarks/roofline.py [n] [--trace DIR]
Prints one JSON document.
"""

import json
import os
import sys

import jax

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def main():
    from noahmp_jax.utils import enable_compile_cache
    import bench
    from __graft_entry__ import _build
    from noahmp_jax.physics.sflx import column_step
    import jax.numpy as jnp

    enable_compile_cache()
    argv = sys.argv[1:]
    trace_dir = None
    if "--trace" in argv:
        trace_dir = argv[argv.index("--trace") + 1]
        argv.remove(trace_dir)
    args = [a for a in argv if not a.startswith("--")]
    n = int(args[0]) if args else 65536

    params, opts, static, forcing, state = _build(n)
    params, static, forcing = jax.device_put((params, static, forcing))

    def fn(params, static, forcing, state):
        col = lambda p, st, f, s: column_step(  # noqa: E731
            p, opts, st, f, s, jnp.float32(900.0))
        return jax.vmap(col, in_axes=(None, 0, 0, 0))(
            params, static, forcing, state)[0]

    compiled = jax.jit(fn, donate_argnums=(3,)).lower(
        params, static, forcing, state).compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, list):  # older jax returns [dict]
        cost = cost[0]
    ma = compiled.memory_analysis()
    mem = {k: getattr(ma, k, None) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes")}

    r = bench.time_step(n)
    bw = bench.copy_bandwidth()
    sec = r["ms_per_step"] / 1e3
    bytes_acc = cost["bytes accessed"]
    out = {
        "n": n,
        "ms_per_step": r["ms_per_step"],
        "point_steps_per_sec": r["point_steps_per_sec"],
        "xla_cost_model": {
            "flops_per_point": cost.get("flops", float("nan")) / n,
            "transcendentals_per_point":
                cost.get("transcendentals", float("nan")) / n,
            "bytes_per_point": bytes_acc / n,
        },
        "memory_analysis": mem,
        "achieved_GBps": bytes_acc / sec / 1e9,
        "copy_GBps": bw / 1e9,
        "copy_share": bytes_acc / sec / bw,
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind},
    }
    print(json.dumps(out, indent=2), flush=True)

    if trace_dir:
        with jax.profiler.trace(trace_dir):
            for _ in range(5):
                state = compiled(params, static, forcing, state)
            jax.block_until_ready(state)
        print(f"trace written to {trace_dir}", flush=True)


if __name__ == "__main__":
    main()
