"""Multi-year spin-up at scale on one device (BASELINE.md config 5).

The production driver streams file forcing per chunk.  Here the
diurnal+seasonal forcing is computed *inside* the jitted scan from
model time (pure jnp solar geometry + analytic meteorology), so a chunk
of T steps costs one dispatch and a few scalars of host traffic.

Checkpoints: state saved at every model-month boundary (restart
payload identical to driver restarts) under <checkout>/build/;
water-budget drift tracked as the running sum and absmax of per-step
ERRWAT.

Usage: python benchmarks/spinup.py [n] [years] [chunk_T] [--step]
           [--out PATH]
Prints one JSON document (and writes it to PATH with --out).

--step: per-step dispatch (chunk_T=1, no lax.scan graph).
"""

import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


DT = 900.0
YEARLEN = 365.0
STEPS_PER_DAY = int(86400 / DT)


def device_forcing(t_sec, static):
    """Analytic forcing at model time ``t_sec`` (scalar, seconds since
    Jan 1 00:00), fully traceable — the device-side equivalent of
    driver.io.SyntheticForcing with a seasonal cycle."""
    from noahmp_jax.state import Forcing

    lat, lon = static.lat, jnp.zeros_like(static.lat)
    jd = (t_sec / 86400.0) % YEARLEN
    frac = jd - jnp.floor(jd)
    decl = 0.409 * jnp.sin(2.0 * jnp.pi * (jd + 284.0) / YEARLEN)
    hang = 2.0 * jnp.pi * (frac - 0.5) + lon
    cosz = (jnp.sin(lat) * jnp.sin(decl)
            + jnp.cos(lat) * jnp.cos(decl) * jnp.cos(hang))
    day = jnp.maximum(cosz, 0.0)

    season = jnp.cos(2.0 * jnp.pi * (jd - 196.0) / YEARLEN)  # peak mid-July
    lat_deg = lat * 57.29578
    tmean = 288.0 - 0.45 * (lat_deg - 37.0) + 12.0 * season
    sfctmp = tmean + 9.0 * (day - 0.3)
    soldn = 1000.0 * day
    # periodic storm pattern: ~8 mm/day in bursts every ~5 days
    storm = (jnp.sin(2.0 * jnp.pi * jd / 5.3)
             + jnp.sin(2.0 * jnp.pi * jd / 11.7)) > 1.2
    prcp = jnp.where(storm, 1.0e-3, 0.0)
    q2 = 0.004 + 0.004 * season + 0.002 * day

    def rep(v):
        return jnp.broadcast_to(jnp.asarray(v, jnp.float32), lat.shape)

    return Forcing(
        sfctmp=rep(sfctmp), sfcprs=rep(95000.0), psfc=rep(95000.0),
        uu=rep(3.0), vv=rep(1.0), q2=rep(q2), soldn=rep(soldn),
        lwdn=rep(280.0 + 60.0 * day + 40.0 * season), prcp=rep(prcp),
        cosz=rep(cosz), co2air=rep(39.0), o2air=rep(18900.0),
        foln=rep(1.0), julian=rep(jd), yearlen=rep(YEARLEN))


def main():
    from noahmp_jax.utils import enable_compile_cache
    enable_compile_cache()
    out_path = None
    if "--out" in sys.argv:
        out_path = sys.argv[sys.argv.index("--out") + 1]
        sys.argv.remove(out_path)
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n = int(args[0]) if args else 65536
    years = float(args[1]) if len(args) > 1 else 2.0
    chunk_T = int(args[2]) if len(args) > 2 else 192
    if "--step" in sys.argv:
        chunk_T = 1

    sys.path.insert(0, os.path.join(_REPO, "examples"))
    import make_case
    from noahmp_jax.params import load_params
    from noahmp_jax.options import Options
    from noahmp_jax.state import Static, init_state
    from noahmp_jax.physics.sflx import column_step
    from noahmp_jax.driver import io as io_mod

    rng = np.random.default_rng(11)
    dom = make_case.conus_domain(n, rng)
    zsoil = np.broadcast_to(dom.pop("zsoil"), (n, 4))
    dom.pop("lon")
    static = Static(zsoil=np.asarray(zsoil, np.float32), **{
        k: np.asarray(v) for k, v in dom.items()})
    state = init_state(n)
    params = load_params("USGS", "STAS")
    opts = Options()

    def one_step(params, static, carry, t):
        st, acc = carry
        f = device_forcing(t, static)
        col = lambda p, s, fo, x: column_step(  # noqa: E731
            p, opts, s, fo, x, jnp.float32(DT))
        new_st, flux = jax.vmap(col, in_axes=(None, 0, 0, 0))(
            params, static, f, st)
        land = static.ist == 1
        ew = jnp.where(land, flux.errwat, 0.0)
        acc = (acc[0] + ew,                       # running sum
               jnp.maximum(acc[1], jnp.abs(ew)),  # absmax
               jnp.maximum(acc[2], jnp.abs(jnp.where(
                   land, flux.erreng, 0.0))))
        return new_st, acc

    def chunk(params, static, state, t0, acc):
        if chunk_T == 1:   # --step: no scan graph
            return one_step(params, static, (state, acc), t0)

        def body(carry, i):
            return one_step(params, static, carry, t0 + i * DT), None

        (state, acc), _ = jax.lax.scan(body, (state, acc),
                                       jnp.arange(chunk_T))
        return state, acc

    jchunk = jax.jit(chunk, donate_argnums=(2, 4))

    static_d, params_d = jax.device_put((static, params))
    acc = tuple(jnp.zeros((n,), jnp.float32) for _ in range(3))

    total_steps = int(round(years * YEARLEN * 86400 / DT))
    nchunks = total_steps // chunk_T
    total_steps = nchunks * chunk_T
    month_steps = 30 * STEPS_PER_DAY

    ckpt_dir = os.path.join(_REPO, "build", f"spinup_{n}")
    os.makedirs(ckpt_dir, exist_ok=True)
    import datetime
    anchor = datetime.datetime(2000, 1, 1)

    print(f"spin-up: n={n}, {years} yr = {total_steps} steps, "
          f"chunks of {chunk_T}", flush=True)
    t_start = time.time()
    state_d = jax.device_put(state)
    done = 0
    next_ckpt = month_steps
    ckpts = 0
    t_compile = None
    for c in range(nchunks):
        t0 = jnp.float32(done * DT)
        state_d, acc = jchunk(params_d, static_d, state_d, t0, acc)
        if c == 0:
            jax.block_until_ready(state_d)
            t_compile = time.time() - t_start
            print(f"[first chunk (compile) {t_compile:.1f}s]",
                  flush=True)
        done += chunk_T
        if done >= next_ckpt:
            st_host = jax.tree.map(np.asarray, state_d)
            io_mod.save_restart(
                os.path.join(ckpt_dir, f"restart_{done:07d}.npz"),
                st_host, anchor)
            next_ckpt += month_steps
            ckpts += 1
        if c % 50 == 0:
            el = time.time() - t_start
            print(f"  chunk {c}/{nchunks}  t={el:.0f}s  "
                  f"{done * n / max(el, 1e-9):,.0f} pt-steps/s",
                  flush=True)
    # final sync
    ew_sum, ew_max, ee_max = (np.asarray(a) for a in acc)
    elapsed = time.time() - t_start
    steady = (total_steps - chunk_T) * n / (elapsed - t_compile)

    out = {
        "config": "BASELINE.md #5 (multi-year spin-up, checkpointed)",
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "n": n, "years": years, "steps": total_steps,
        "chunk_T": chunk_T,
        "wall_s": round(elapsed, 1),
        "compile_s": round(t_compile, 1),
        "point_steps_per_s_steady": round(steady, 1),
        "checkpoints_written": ckpts,
        "errwat_drift_mm": {
            "max_cumulative": float(np.max(np.abs(ew_sum))),
            "mean_cumulative": float(np.mean(ew_sum)),
            "per_step_absmax": float(np.max(ew_max)),
        },
        "erreng_absmax_W_m2": float(np.max(ee_max)),
        "final_state_finite": bool(np.isfinite(
            np.asarray(state_d.tg)).all()),
    }
    print(json.dumps(out, indent=2), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
