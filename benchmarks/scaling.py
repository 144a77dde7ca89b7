"""Benchmark harness for the five BASELINE.md configs.

1. single-point offline case       4. ~1M points, sharded mesh
2. 1k-column batch, single chip    5. multi-year scan throughput
3. ~100k heterogeneous points

Run: python benchmarks/scaling.py [--configs 1,2,3] [--points-cap N]
On CPU it also reports weak scaling over the virtual 8-device mesh.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build(n, heterogeneous=False, seed=0):
    from noahmp_jax.params import load_params
    from noahmp_jax.options import Options
    from noahmp_jax.state import init_state, init_static, Forcing

    params = load_params()
    opts = Options()
    static = init_static(n)
    if heterogeneous:
        rng = np.random.default_rng(seed)
        static = static._replace(
            lutyp=jnp.asarray(rng.choice([2, 5, 7, 8, 11, 14], n),
                              jnp.int32),
            sltyp=jnp.asarray(rng.choice([3, 4, 6, 8, 9, 12], n),
                              jnp.int32),
            isc=jnp.asarray(rng.integers(1, 9, n), jnp.int32))
    state = init_state(n)

    def rep(v):
        return np.broadcast_to(np.float32(v), (n,))
    forcing = Forcing(
        sfctmp=rep(290.0), sfcprs=rep(90000.0), psfc=rep(90000.0),
        uu=rep(3.0), vv=rep(1.0), q2=rep(0.007), soldn=rep(500.0),
        lwdn=rep(330.0), prcp=rep(0.0005), cosz=rep(0.6),
        co2air=rep(39.0), o2air=rep(18900.0), foln=rep(1.0),
        julian=rep(180.0), yearlen=rep(366.0))
    return params, opts, static, forcing, state


def time_step(params, opts, static, forcing, state, nsteps=10,
              scan_len=None, layout="major"):
    from noahmp_jax.physics.sflx import column_step

    # params/static/forcing travel as jit ARGUMENTS: device-resident
    # closure constants force a device->host fetch at lowering
    # (driver/step.py).
    def col(p, st, f, s):
        return column_step(p, opts, st, f, s, jnp.float32(900.0))

    # "minor": batch axis trailing, so the small layer arrays tile as
    # (L, n) without sublane padding (PERF.md lever 2; the 1M-point
    # droop experiment, VERDICT r3 weak #3)
    ax = 0 if layout == "major" else -1
    if layout != "major":
        from noahmp_jax.driver.step import batch_to_layout
        static, forcing, state = (batch_to_layout(static, layout),
                                  batch_to_layout(forcing, layout),
                                  batch_to_layout(state, layout))

    if scan_len:
        def fn(params, static, forcing, state):
            def body(s, _):
                s2, _f = jax.vmap(col, in_axes=(None, ax, ax, ax),
                                  out_axes=ax)(
                    params, static, forcing, s)
                return s2, None
            s, _ = jax.lax.scan(body, state, None, length=scan_len)
            return s
        steps_per_call = scan_len
    else:
        def fn(params, static, forcing, state):
            return jax.vmap(col, in_axes=(None, ax, ax, ax),
                            out_axes=ax)(
                params, static, forcing, state)[0]
        steps_per_call = 1

    jitted = jax.jit(fn, donate_argnums=(3,))
    # one upfront transfer: passing host numpy (broadcast views) would
    # re-upload static+forcing on every call and bound the measurement
    # by host->device bandwidth instead of device throughput
    params, static, forcing = jax.device_put((params, static, forcing))
    step = lambda s: jitted(params, static, forcing, s)  # noqa: E731

    state = jax.block_until_ready(step(state))
    calls = max(1, nsteps // steps_per_call)
    t0 = time.perf_counter()
    for _ in range(calls):
        state = step(state)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    n = int(np.asarray(static.lat).shape[0])
    return n * calls * steps_per_call / dt


def main():
    from noahmp_jax.utils import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3")
    ap.add_argument("--points-cap", type=int, default=1_048_576)
    ap.add_argument("--out", default=None,
                    help="also write results JSON to this path")
    ap.add_argument("--sweep", action="store_true",
                    help="single-chip batch-size sweep 16k -> 1M "
                    "(the BASELINE scaling table)")
    ap.add_argument("--layout", choices=("major", "minor"),
                    default="major",
                    help="minor: batch axis trailing (layer arrays "
                    "tile unpadded; 1M-droop experiment)")
    args = ap.parse_args()
    wanted = set(args.configs.split(","))
    results = {}

    if args.sweep:
        for n in (16384, 65536, 262144, 1048576):
            if n > args.points_cap:
                break
            rate = time_step(*build(n), nsteps=max(5, 2**21 // n * 4),
                             layout=args.layout)
            results[f"n_{n}"] = rate
            print(json.dumps({"n": n,
                              "point_steps_per_sec": round(rate, 1)}),
                  flush=True)
        wanted = set()

    if "1" in wanted:
        results["single_point"] = time_step(*build(8), nsteps=20)
    if "2" in wanted:
        results["1k_batch"] = time_step(*build(1024), nsteps=20)
    if "3" in wanted:
        results["100k_heterogeneous"] = time_step(
            *build(min(131072, args.points_cap), heterogeneous=True),
            nsteps=10)
    if "4" in wanted:
        n = min(1_048_576, args.points_cap)
        from noahmp_jax.dist.mesh import make_mesh, shard_batch
        mesh = make_mesh()
        params, opts, static, forcing, state = build(n,
                                                     heterogeneous=True)
        static = shard_batch(static, mesh)
        forcing = shard_batch(forcing, mesh)
        state = shard_batch(state, mesh)
        results[f"1M_sharded_{mesh.devices.size}dev"] = time_step(
            params, opts, static, forcing, state, nsteps=5)
    if "5" in wanted:
        results["scan_throughput"] = time_step(
            *build(65536), nsteps=50, scan_len=10)

    for k, v in results.items():
        print(json.dumps({"config": k, "point_steps_per_sec":
                          round(v, 1)}))
    if args.out:
        doc = {"device": {"platform": jax.devices()[0].platform,
                          "kind": jax.devices()[0].device_kind,
                          "count": len(jax.devices())},
               "results": {k: round(v, 1) for k, v in results.items()}}
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)


if __name__ == "__main__":
    main()
