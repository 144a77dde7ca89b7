"""Capture performance evidence for the single-chip step (VERDICT
round-1 missing #6: no profiler trace was ever recorded on hardware).

    python benchmarks/profile_step.py [n] [--trace DIR] [--hlo DIR]

- ``--trace``: wrap the timed loop in jax.profiler.trace (works only if
  the backend supports device tracing; falls back gracefully).
- ``--hlo``: set XLA_FLAGS=--xla_dump_to before init is not possible
  here, so instead the *optimized* HLO is fetched via
  jitted.lower(...).compile() cost analysis + as_text, and a fusion
  census (op kind -> count, materialized buffer bytes) is printed —
  enough to see what XLA materializes between fusions.
"""

import argparse
import collections
import json
import os
import re
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    from noahmp_jax.utils import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("n", nargs="?", type=int, default=65536)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--hlo-census", action="store_true")
    args = ap.parse_args()

    from __graft_entry__ import _build
    from noahmp_jax.physics.sflx import column_step

    n = args.n
    params, opts, static, forcing, state = _build(n)
    static, forcing = jax.device_put((static, forcing))

    def fn(params, static, forcing, state):
        col = lambda p, st, f, s: column_step(  # noqa: E731
            p, opts, st, f, s, jnp.float32(900.0))
        return jax.vmap(col, in_axes=(None, 0, 0, 0))(
            params, static, forcing, state)[0]

    jitted = jax.jit(fn, donate_argnums=(3,))

    if args.hlo_census:
        lowered = jitted.lower(params, static, forcing, state)
        compiled = lowered.compile()
        try:
            ca = compiled.cost_analysis()
            print(json.dumps({k: v for k, v in sorted(ca.items())
                              if isinstance(v, (int, float))
                              and ("flops" in k or "bytes" in k
                                   or "transcendentals" in k)},
                             indent=2))
        except Exception as e:
            print("cost_analysis unavailable:", e)
        try:
            txt = compiled.as_text()
        except Exception:
            txt = lowered.as_text()
        kinds = collections.Counter(
            m.group(1) for m in re.finditer(
                r"^\s*(?:ROOT\s+)?%?[\w.-]+\s*=\s*[\w\[\]x_]+\s+"
                r"([\w-]+)\(", txt, re.M))
        print("top HLO op kinds:", kinds.most_common(18))
        fusions = len(re.findall(r"fusion\(", txt))
        print("fusion call sites:", fusions)
        # materialized intermediate estimate: sum of fusion root shapes
        sizes = [int(np.prod([int(x) for x in m.group(1).split(",")]))
                 for m in re.finditer(
                     r"=\s*f32\[([\d,]+)\]\{[\d,]*\}\s+fusion\(", txt)]
        print(f"fusion outputs: {len(sizes)}, total f32 elems "
              f"{sum(sizes):,} (={sum(sizes)*4/1e6:.1f} MB, "
              f"{sum(sizes)*4/max(n,1):.0f} B/point)")
        return

    state = jax.block_until_ready(jitted(params, static, forcing, state))

    def run(nsteps, st):
        t0 = time.perf_counter()
        for _ in range(nsteps):
            st = jitted(params, static, forcing, st)
        jax.block_until_ready(st)
        return time.perf_counter() - t0, st

    dt, state = run(3, state)  # warm donation steady-state

    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        try:
            with jax.profiler.trace(args.trace):
                dt, state = run(args.steps, state)
            print("trace written to", args.trace)
        except Exception as e:
            print("profiler trace failed:", repr(e))
            dt, state = run(args.steps, state)
    else:
        dt, state = run(args.steps, state)

    print(json.dumps({
        "n": n, "device": {"platform": jax.devices()[0].platform,
                           "kind": jax.devices()[0].device_kind},
        "ms_per_step": round(1e3 * dt / args.steps, 2),
        "point_steps_per_s": round(n * args.steps / dt, 1)}))


if __name__ == "__main__":
    main()
