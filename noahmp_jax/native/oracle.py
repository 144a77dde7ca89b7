"""Comparisons of the batched model against its references, shared by
the test suite and ``chip_smoke.py`` so that a run on an accelerator
is held to the same bounds as the CPU tests.

- ``resync_fuzz``: single-step-resync fuzz against the serial C++
  column (native/): every step the oracle restarts from the batched
  model's state, so each comparison is a one-step numerical check on a
  fresh realistic state and chaotic divergence cannot compound.
- ``snode_sweep``: the f64 reference for the groundwater S_NODE matric
  potential that numerics/dfloat.py reproduces in two-float f32.
"""

from __future__ import annotations

import numpy as np

from ..state import Forcing
from . import step_column

# Calibration (scripts/calibrate_fuzz.py --resync, on CPU): typical
# per-step divergence is <=1e-2 K; rare masked-vs-serial
# iteration-count flips in the Newton/Chen97 loops produce isolated
# bounded outliers (3 in 4000 column-steps measured, max tg 2.0 K,
# tv 1.25 K).  Tight bounds = calibrated max x ~10 margin on the smooth
# population, required of >= 99.5% of column-steps; caps = isolated
# knife-edge outliers x ~2, required always.  Layer counts must match
# exactly.
FUZZ_TIGHT = dict(tg=0.1, tv=0.3, swc=1e-4, sneqv=0.05, canliq=0.02)
FUZZ_CAP = dict(tg=4.0, tv=2.5, swc=1e-3, sneqv=0.5, canliq=0.25)
FUZZ_OUTLIER_FRAC = 0.005


def fuzz_forcing(rng, n):
    """Random multi-regime forcing (warm/cold, day/night, dry/rainy)."""
    day = rng.random(n) < 0.5
    rep = lambda v: np.full(n, v, np.float32)  # noqa: E731
    return Forcing(
        sfctmp=rng.uniform(250.0, 305.0, n).astype(np.float32),
        sfcprs=rep(90000.0), psfc=rep(90000.0),
        uu=rng.uniform(0.5, 12.0, n).astype(np.float32), vv=rep(1.0),
        q2=rng.uniform(0.001, 0.012, n).astype(np.float32),
        soldn=np.where(day, rng.uniform(100.0, 900.0, n),
                       0.0).astype(np.float32),
        lwdn=rng.uniform(200.0, 400.0, n).astype(np.float32),
        prcp=rng.choice([0.0, 0.0002, 0.001, 0.004],
                        n).astype(np.float32),
        cosz=np.where(day, rng.uniform(0.1, 0.95, n),
                      -0.2).astype(np.float32),
        co2air=rep(39.0), o2air=rep(18900.0), foln=rep(1.0),
        julian=rep(180.0), yearlen=rep(366.0))


def resync_fuzz(step, params_host, opts, static, state, rng, nsteps,
                dt=900.0, label=""):
    """Advance ``state`` ``nsteps`` times with ``step`` (the batched
    model, static/forcing/state -> (state, flux)) under ``fuzz_forcing``
    and compare every column with one native step from the same
    starting state.  ``static`` and ``params_host`` are host numpy.

    Raises AssertionError on a layer-count mismatch, a deviation beyond
    ``FUZZ_CAP`` or more than ``FUZZ_OUTLIER_FRAC`` of column-steps
    beyond ``FUZZ_TIGHT``.  Returns {"max": {field: largest deviation},
    "outliers": int, "column_steps": int}.
    """
    import jax

    n = int(np.asarray(static.lat).shape[0])
    worst = {fld: 0.0 for fld in FUZZ_TIGHT}
    outliers = 0
    total = 0
    for t in range(nsteps):
        f = fuzz_forcing(rng, n)
        prev = jax.device_get(state)
        state, _ = step(static, f, state)
        jarr = {k: np.asarray(getattr(state, k))
                for k in ("tg", "tv", "swc", "sneqv", "canliq",
                          "nsnow")}
        for i in range(n):
            sn, _fl = step_column(params_host, opts, static, f, prev, i,
                                  dt)
            assert int(jarr["nsnow"][i]) == int(sn["nsnow"]), \
                f"{label}: layer count diverged step {t} col {i}"
            is_out = False
            for fld, tol in FUZZ_TIGHT.items():
                d = float(np.max(np.abs(
                    np.asarray(jarr[fld][i], np.float64)
                    - np.asarray(sn[fld], np.float64))))
                assert d <= FUZZ_CAP[fld], (
                    f"{label}: {fld} diff {d:.3g} beyond hard cap at "
                    f"step {t} col {i} (lutyp "
                    f"{int(np.asarray(static.lutyp)[i])})")
                worst[fld] = max(worst[fld], d)
                if d > tol:
                    is_out = True
            outliers += is_out
            total += 1
    assert outliers <= FUZZ_OUTLIER_FRAC * total, (
        f"{label}: {outliers}/{total} column-steps beyond tight bounds "
        f"(allowed {FUZZ_OUTLIER_FRAC:.1%})")
    return {"max": worst, "outliers": outliers, "column_steps": total}


def snode_sweep(n=200_000, seed=1):
    """Full-range inputs of the groundwater S_NODE matric potential and
    its reference value (func:6560-6563): the f32 saturation ratio
    widened to f64, clamped against 0.01_8, f64 pow and product, one
    rounding into the real*4 SMPFZ.  Returns (s32, bexp, psisat,
    at_clip, ref) as numpy arrays, the first four the arguments of
    ``numerics.dfloat.smpfz_f64_parity``."""
    rng = np.random.default_rng(seed)
    smc = rng.uniform(0.002, 0.55, n)
    smcmax = rng.uniform(0.30, 0.50, n)
    psisat = rng.uniform(0.01, 0.76, n).astype(np.float32)
    bexp = rng.uniform(2.0, 12.0, n).astype(np.float32)

    # s_node exactly as physics/soilwater.py:groundwater computes it
    ratio32 = smc.astype(np.float32) / smcmax.astype(np.float32)
    s32 = np.clip(np.minimum(ratio32, np.float32(1.0)),
                  np.float32(0.01), None)
    at_clip = ratio32 <= np.float32(0.01)

    s64 = np.maximum(np.minimum(1.0, ratio32.astype(np.float64)), 0.01)
    ref = (-psisat.astype(np.float64) * 1000.0
           * s64 ** (-bexp.astype(np.float64))).astype(np.float32)
    return s32, bexp, psisat, at_clip, ref


def ulp_distance(out, ref):
    """|out - ref| in units of ref's f32 spacing."""
    return (np.abs(np.asarray(out, np.float64) - ref.astype(np.float64))
            / np.spacing(np.abs(ref)).astype(np.float64))
