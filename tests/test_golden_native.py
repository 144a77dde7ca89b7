"""Golden-trajectory validation: the masked/fixed-shape JAX model vs the
independent serial C++ reference column (native/noahmp_ref.cpp) over
multi-step trajectories.  This replaces the unavailable Fortran oracle
(no gfortran in the image; SURVEY.md section 4 item 1): the C++ column
uses real early exits / branching / in-place layer shifts, so agreement
validates the lockstep restructuring.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from noahmp_jax.params import load_params
from noahmp_jax.options import Options
from noahmp_jax.state import init_state, init_static, Forcing, State
from noahmp_jax.driver.step import make_step
from noahmp_jax import native
from noahmp_jax.native.oracle import resync_fuzz


@pytest.fixture(scope="module")
def params():
    return load_params()


@pytest.fixture(scope="module")
def params_host():
    # host-numpy tables for the native oracle: per-field fetches from
    # device-resident params cost ~1.5 s per step_column call
    return load_params(to_device=False)


def mkforcing(n, **kw):
    d = dict(sfctmp=295.0, sfcprs=90000.0, psfc=90000.0, uu=3.0, vv=1.0,
             q2=0.008, soldn=600.0, lwdn=350.0, prcp=0.001, cosz=0.7,
             co2air=39.0, o2air=18900.0, foln=1.0, julian=180.0,
             yearlen=366.0)
    d.update(kw)

    def rep(v):
        return jnp.broadcast_to(jnp.float32(v), (n,))
    return Forcing(**{k: rep(v) for k, v in d.items()})


def native_trajectory(params, opts, static, forcing, state, i, dt,
                      nsteps):
    """Run the native column serially, returning per-step state dicts."""
    params = _host_params(params)
    out = []
    sd = None
    st = state
    for _ in range(nsteps):
        sd, fl = native.step_column(params, opts, static, forcing, st,
                                    i, dt)
        # write the native state back into a State for the next call
        upd = {}
        for name in State._fields:
            ref = np.asarray(getattr(st, name)).copy()
            v = sd[name]
            if ref.ndim == 2:
                ref[i] = v
            else:
                ref[i] = v if np.ndim(v) == 0 else v
            upd[name] = jnp.asarray(ref)
        st = State(**upd)
        out.append((sd, fl))
    return out


_HOST_PARAMS_CACHE = {}


def _host_params(params):
    """Host-numpy mirror of a (possibly device-resident) params tree."""
    key = id(params)
    if key not in _HOST_PARAMS_CACHE:
        import jax
        _HOST_PARAMS_CACHE[key] = jax.tree.map(np.asarray, params)
    return _HOST_PARAMS_CACHE[key]


def compare(params, opts, static, forcing, state, dt, nsteps, cols,
            atol_t=0.02, atol_w=1e-3, atol_sneqv=0.05):
    step = make_step(params, opts, dt, donate=False)
    sj = state
    traj_j = []
    for _ in range(nsteps):
        sj, fj = step(static, forcing, sj)
        traj_j.append(sj)
    for i in cols:
        traj_n = native_trajectory(params, opts, static, forcing, state,
                                   i, dt, nsteps)
        for t, ((sn, _fl), sjt) in enumerate(zip(traj_n, traj_j)):
            np.testing.assert_allclose(
                float(sjt.tg[i]), sn["tg"], atol=atol_t,
                err_msg=f"tg col {i} step {t}")
            np.testing.assert_allclose(
                float(sjt.tv[i]), sn["tv"], atol=atol_t,
                err_msg=f"tv col {i} step {t}")
            np.testing.assert_allclose(
                np.asarray(sjt.stc[i])[3:], sn["stc"][3:], atol=atol_t,
                err_msg=f"soil stc col {i} step {t}")
            np.testing.assert_allclose(
                np.asarray(sjt.swc[i]), sn["swc"], atol=atol_w,
                err_msg=f"swc col {i} step {t}")
            np.testing.assert_allclose(
                float(sjt.sneqv[i]), sn["sneqv"], atol=atol_sneqv,
                err_msg=f"sneqv col {i} step {t}")


def test_warm_vegetated_trajectory(params):
    n = 2
    static = init_static(n, lutyp=7, sltyp=6)
    compare(params, Options(), static, mkforcing(n),
            init_state(n), 900.0, 24, cols=[0])


def test_forest_trajectory(params):
    n = 2
    static = init_static(n, lutyp=14, sltyp=4)
    compare(params, Options(), static,
            mkforcing(n, sfctmp=288.0, soldn=400.0, prcp=0.0),
            init_state(n), 900.0, 24, cols=[0])


def test_bare_ground_trajectory(params):
    n = 2
    static = init_static(n, lutyp=19, sltyp=1, shdfac=0.0, shdmax=0.0)
    compare(params, Options(), static,
            mkforcing(n, prcp=0.002), init_state(n), 900.0, 24,
            cols=[0])


def test_snow_trajectory(params):
    """Snow accumulation with layer formation: the hardest parity case
    (layer combine/divide + phase change)."""
    n = 2
    static = init_static(n, lutyp=7, sltyp=6)
    state = init_state(n, tg=266.0, tv=266.0, stc_soil=270.0)
    f = mkforcing(n, sfctmp=263.0, prcp=0.002, soldn=80.0, cosz=0.3,
                  lwdn=240.0, q2=0.002)
    # measured masked-vs-serial divergence over 60 steps is <3e-4 K
    # (f32 ordering only); 0.02 K keeps ~60x margin
    compare(params, Options(), static, f, state, 900.0, 60, cols=[0],
            atol_t=0.02, atol_w=1e-3)


def test_jarvis_and_runoff3_trajectory(params):
    n = 2
    static = init_static(n, lutyp=11, sltyp=8)
    opts = Options(crs=2, run=3, inf=2)
    compare(params, opts, static, mkforcing(n, prcp=0.002),
            init_state(n), 900.0, 24, cols=[0])


@pytest.mark.parametrize("opts,lutyp,sltyp", [
    (Options(frz=2), 7, 6),
    (Options(rad=2), 11, 8),
    (Options(rad=3), 11, 8),
    (Options(snf=2, tbot=1), 7, 6),
    (Options(snf=3, stc=2), 7, 6),
    (Options(alb=1, sfc=2), 14, 4),
    (Options(veg=1), 7, 6),
    (Options(veg=2, crs=1), 11, 8),
    (Options(veg=3, btr=2, run=2), 7, 6),
    (Options(btr=3, run=4), 5, 9),
])
def test_option_combo_trajectory(params, opts, lutyp, sltyp):
    """Broad option-matrix parity vs the serial C++ reference."""
    n = 2
    static = init_static(n, lutyp=lutyp, sltyp=sltyp)
    compare(params, opts, static, mkforcing(n, prcp=0.0015),
            init_state(n), 900.0, 12, cols=[0])


def test_stochastic_regime_fuzz(params):
    """Randomized multi-regime forcing vs the serial C++ oracle: each
    step draws new weather (warm/cold/rainy/snowy/night), hunting
    masked-vs-serial divergences across regime transitions."""
    rng = np.random.default_rng(42)
    n = 1
    static = init_static(n, lutyp=7, sltyp=6)
    state = init_state(n, tg=278.0, tv=278.0, stc_soil=278.0)
    step = make_step(params, Options(), 900.0, donate=False)

    st_j = state
    st_n = state
    for t in range(60):
        sfctmp = rng.uniform(255.0, 300.0)
        day = rng.random() < 0.5
        f = mkforcing(
            n, sfctmp=sfctmp,
            prcp=float(rng.choice([0.0, 0.0005, 0.003])),
            soldn=float(rng.uniform(200.0, 800.0)) if day else 0.0,
            cosz=float(rng.uniform(0.2, 0.9)) if day else -0.2,
            lwdn=float(rng.uniform(220.0, 380.0)),
            q2=float(rng.uniform(0.001, 0.01)),
            uu=float(rng.uniform(0.5, 10.0)))
        st_j, _ = step(static, f, st_j)
        sn, _fl = native.step_column(_host_params(params), Options(),
                                     static, f, st_n, 0, 900.0)
        upd = {}
        for name in State._fields:
            ref = np.asarray(getattr(st_n, name)).copy()
            ref[0] = sn[name]
            upd[name] = jnp.asarray(ref)
        st_n = State(**upd)

        # tolerances: measured x10 (VERDICT r3 next #8) over 200-step
        # runs across seeds {42, 7, 123}: max tg 0.0034 K, tv 0.011 K,
        # swc 2.3e-6, sneqv 0.003 mm; zero layer-count divergences
        np.testing.assert_allclose(
            float(st_j.tg[0]), sn["tg"], atol=0.034,
            err_msg=f"tg diverged at step {t} (sfctmp={sfctmp:.1f})")
        np.testing.assert_allclose(
            float(st_j.tv[0]), sn["tv"], atol=0.11,
            err_msg=f"tv diverged at step {t}")
        np.testing.assert_allclose(
            np.asarray(st_j.swc[0]), sn["swc"], atol=2.3e-5,
            err_msg=f"swc diverged at step {t}")
        np.testing.assert_allclose(
            float(st_j.sneqv[0]), sn["sneqv"], atol=0.03,
            err_msg=f"sneqv diverged at step {t}")
        assert int(st_j.nsnow[0]) == int(sn["nsnow"]), \
            f"layer count diverged at step {t}"


# ---------------------------------------------------------------------
# Round-4 extended fuzz (VERDICT r3 next #8): 500 single-step-resync
# comparisons x 8 heterogeneous columns (incl. urban/barren/tundra and
# clay soils the round-3 fuzz never touched) x 6 option combos.  The
# oracle restarts every step from the JAX state, so each comparison is
# a pure one-step numerical check on a fresh realistic state — chaotic
# trajectory decoupling across knife-edge thresholds cannot compound.
# Calibration (scripts/calibrate_fuzz.py --resync): typical per-step
# divergence is <=1e-2 K; rare masked-vs-serial iteration-count flips
# in the Newton/Chen97 loops produce isolated bounded outliers
# (3 in 4000 column-steps measured, max tg 2.0 K, tv 1.25 K).  The
# assertions below encode exactly that: tight bounds for >=99.5% of
# column-steps, hard caps for the outliers, EXACT layer counts always.
# This fuzz also caught a real oracle bug in round 4 (missing
# opt_stc=2 snow-surface TG cap, func:1318-1330).

# Columns 8+9 are the round-5 additions (VERDICT r4 next #6): a
# glacier column (USGS lutyp 24 = ISICE, pre-loaded near the 2000 mm
# overflow threshold) and a lake column (lutyp 16 = ISWATER, ist=2,
# WSLMAX branch) so the special surface types see resync fuzz, not
# just 24-step trajectories.
FUZZ_LUTYP = [7, 14, 19, 11, 5, 2, 1, 21, 24, 16]
FUZZ_SLTYP = [6, 4, 1, 8, 9, 3, 12, 5, 1, 6]
FUZZ_ISC = [4, 2, 7, 5, 1, 3, 6, 8, 1, 4]
FUZZ_IST = [1, 1, 1, 1, 1, 1, 1, 1, 1, 2]
GLACIER_COL = 8

FUZZ_COMBOS = [
    ("default", Options()),
    ("frz2_tbot1", Options(frz=2, tbot=1)),
    ("jarvis_run3_inf2", Options(crs=2, run=3, inf=2)),
    ("dynveg2", Options(veg=2, crs=1)),
    ("snf2_stc2", Options(snf=2, stc=2)),
    ("btr3_run4_alb1_sfc2", Options(btr=3, run=4, alb=1, sfc=2)),
    # round-5 additions: opt_rad 2/3 and opt_run=2 (zwteq equilibrium
    # water table) previously existed only in 24-step trajectories
    ("rad2_run2", Options(rad=2, run=2)),
    ("rad3_frz2_snf3", Options(rad=3, frz=2, snf=3)),
]

@pytest.mark.parametrize("name,opts", FUZZ_COMBOS,
                         ids=[c[0] for c in FUZZ_COMBOS])
def test_resync_fuzz(params, params_host, name, opts, runslow):
    n = len(FUZZ_LUTYP)
    # default: 75-step subsample per combo keeps the suite usable
    # (~15 s/combo); CI --runslow runs the full calibrated 500 steps
    nsteps = 500 if runslow else 75
    rng = np.random.default_rng(42)
    static = init_static(n)._replace(
        lutyp=np.asarray(FUZZ_LUTYP, np.int32),
        sltyp=np.asarray(FUZZ_SLTYP, np.int32),
        isc=np.asarray(FUZZ_ISC, np.int32),
        ist=np.asarray(FUZZ_IST, np.int32))
    st_j = init_state(n, tg=278.0, tv=278.0, stc_soil=278.0)
    # glacier column: cold, fully-layered 4 m pack just under the
    # 2000 mm SWE overflow threshold so the fuzz crosses it within a
    # few snowy steps while already layered (the reference's bulk
    # overflow path divides 0/0 when ISNOW=0, func:5137-5143 — real
    # glaciers are always layered, so start there)
    def percol(field, col, val):
        a = np.array(getattr(st_j, field), np.float32)
        a[col] = val
        return a
    gl_dz = np.array([0.05, 0.2, 3.75], np.float32)
    gl_ice = np.array([25.0, 100.0, 1870.0], np.float32)  # ~500 kg/m3
    gl_z = -np.cumsum(np.concatenate(
        [gl_dz, np.diff(np.concatenate(
            [[0.0], -np.asarray(static.zsoil[GLACIER_COL])]))]))
    gl_stc = np.concatenate([np.full(3, 266.0), np.full(4, 268.0)])
    st_j = st_j._replace(
        nsnow=np.where(np.arange(n) == GLACIER_COL, 3,
                       np.asarray(st_j.nsnow)).astype(np.int32),
        snice=percol("snice", GLACIER_COL, gl_ice),
        snliq=percol("snliq", GLACIER_COL, np.zeros(3, np.float32)),
        ficeold=percol("ficeold", GLACIER_COL, np.ones(3, np.float32)),
        zsnso=percol("zsnso", GLACIER_COL, gl_z.astype(np.float32)),
        stc=percol("stc", GLACIER_COL, gl_stc.astype(np.float32)),
        sneqv=percol("sneqv", GLACIER_COL, float(gl_ice.sum())),
        sneqvo=percol("sneqvo", GLACIER_COL, float(gl_ice.sum())),
        snowh=percol("snowh", GLACIER_COL, float(gl_dz.sum())),
        tg=percol("tg", GLACIER_COL, 266.0),
        tv=percol("tv", GLACIER_COL, 266.0))
    step = make_step(params, opts, 900.0, donate=False)
    resync_fuzz(step, params_host, opts, static, st_j, rng, nsteps,
                label=name)
