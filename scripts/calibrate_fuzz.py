"""Measure JAX-vs-native-oracle divergence for the round-4 extended
stochastic fuzz (500 steps x option combos x 8 heterogeneous columns)
so tests/test_golden_native.py tolerances can be set at measured x10
(VERDICT r3 next #8).

Usage: python scripts/calibrate_fuzz.py [nsteps] [seed]
Prints a per-combo, per-field max-divergence table.
"""

import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

os.environ["JAX_PLATFORMS"] = "cpu"  # oracle comparison is CPU work

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from noahmp_jax.params import load_params  # noqa: E402
from noahmp_jax.options import Options  # noqa: E402
from noahmp_jax.state import init_state, init_static, Forcing, State  # noqa: E402
from noahmp_jax.driver.step import make_step  # noqa: E402
from noahmp_jax import native  # noqa: E402

# 8 heterogeneous columns: grass, forest, barren, crop, shrub,
# dry crop/pasture (USGS 2), urban (USGS 1), wooded tundra
LUTYP = [7, 14, 19, 11, 5, 2, 1, 21]
SLTYP = [6, 4, 1, 8, 9, 3, 12, 5]
ISC = [4, 2, 7, 5, 1, 3, 6, 8]

COMBOS = [
    ("default", Options()),
    ("frz2_tbot1", Options(frz=2, tbot=1)),
    ("jarvis_run3_inf2", Options(crs=2, run=3, inf=2)),
    ("dynveg2", Options(veg=2, crs=1)),
    ("snf2_stc2", Options(snf=2, stc=2)),
    ("btr3_run4_alb1_sfc2", Options(btr=3, run=4, alb=1, sfc=2)),
]

FIELDS = ("tg", "tv", "swc", "smc", "stc", "sneqv", "snowh",
          "canliq", "zwt", "lai")


def mkforcing(rng, n):
    day = rng.random(n) < 0.5
    return Forcing(
        sfctmp=rng.uniform(250.0, 305.0, n).astype(np.float32),
        sfcprs=np.full(n, 90000.0, np.float32),
        psfc=np.full(n, 90000.0, np.float32),
        uu=rng.uniform(0.5, 12.0, n).astype(np.float32),
        vv=np.full(n, 1.0, np.float32),
        q2=rng.uniform(0.001, 0.012, n).astype(np.float32),
        soldn=np.where(day, rng.uniform(100.0, 900.0, n),
                       0.0).astype(np.float32),
        lwdn=rng.uniform(200.0, 400.0, n).astype(np.float32),
        prcp=rng.choice([0.0, 0.0002, 0.001, 0.004],
                        n).astype(np.float32),
        cosz=np.where(day, rng.uniform(0.1, 0.95, n),
                      -0.2).astype(np.float32),
        co2air=np.full(n, 39.0, np.float32),
        o2air=np.full(n, 18900.0, np.float32),
        foln=np.full(n, 1.0, np.float32),
        julian=np.full(n, 180.0, np.float32),
        yearlen=np.full(n, 366.0, np.float32),
    )


def run_combo(params, params_host, name, opts, nsteps, seed,
              resync=False):
    """``resync``: single-step mode — the oracle starts every step from
    the JAX state, so the comparison measures per-step numerical
    difference only (no chaotic trajectory decoupling across discrete
    thresholds like snow-layer formation).  Layer counts must then
    match EXACTLY every step."""
    return _run(params, params_host, name, opts, nsteps, seed, resync)


def _run(params, params_host, name, opts, nsteps, seed, resync):
    n = len(LUTYP)
    rng = np.random.default_rng(seed)
    static = init_static(n)._replace(
        lutyp=np.asarray(LUTYP, np.int32),
        sltyp=np.asarray(SLTYP, np.int32),
        isc=np.asarray(ISC, np.int32))
    state = init_state(n, tg=278.0, tv=278.0, stc_soil=278.0)
    step = make_step(params, opts, 900.0, donate=False)

    st_j = state
    st_n = state  # host numpy throughout (device fetches per native
    #               call would dominate the wall clock)
    worst = {f: 0.0 for f in FIELDS}
    worst_nsnow = 0
    for t in range(nsteps):
        f = mkforcing(rng, n)
        prev_j = st_j
        st_j, _ = step(static, f, st_j)
        # device_get (one tree transfer) — per-leaf np.asarray costs
        # ~1-3 ms each and dominates the loop
        base = jax.device_get(prev_j) if resync else st_n
        upd = {nm: np.asarray(getattr(base, nm)).copy()
               for nm in State._fields}
        for i in range(n):
            sn, _fl = native.step_column(params_host, opts, static, f,
                                         base, i, 900.0)
            for nm in State._fields:
                upd[nm][i] = sn[nm]
        st_n = State(**upd)
        for fld in FIELDS:
            d = np.max(np.abs(np.asarray(getattr(st_j, fld), np.float64)
                              - np.asarray(getattr(st_n, fld),
                                           np.float64)))
            worst[fld] = max(worst[fld], float(d))
        dn = np.max(np.abs(np.asarray(st_j.nsnow)
                           - np.asarray(st_n.nsnow)))
        worst_nsnow = max(worst_nsnow, int(dn))
    return worst, worst_nsnow


def main():
    nsteps = int(sys.argv[1]) if len(sys.argv) > 1 else 500
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 42
    resync = "--resync" in sys.argv
    params = load_params()
    params_host = load_params(to_device=False)
    print(f"nsteps={nsteps} seed={seed} resync={resync} "
          f"cols lutyp={LUTYP} sltyp={SLTYP}")
    overall = {f: 0.0 for f in FIELDS}
    for name, opts in COMBOS:
        t0 = time.time()
        worst, wn = run_combo(params, params_host, name, opts, nsteps,
                              seed, resync=resync)
        line = " ".join(f"{f}={worst[f]:.3e}" for f in FIELDS)
        print(f"{name:22s} ({time.time()-t0:5.1f}s) nsnow_div={wn} "
              f"{line}", flush=True)
        for f in FIELDS:
            overall[f] = max(overall[f], worst[f])
    print("OVERALL " + " ".join(f"{f}={overall[f]:.3e}"
                                for f in FIELDS))


if __name__ == "__main__":
    main()
