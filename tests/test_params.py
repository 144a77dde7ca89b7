"""Parameter-table loading tests.

Values asserted here are read directly from the data tables
(noahmp_jax/params/data/*.TBL) mirroring what the reference readers
produce (core/module_noahmp_veg_param.f90:77-161,
core/module_noahmp_soil_param.f90:31-72, core/module_noahmp_gen_param.f90:51-89).
"""

import numpy as np
import pytest

from noahmp_jax.params import load_params, VEG_SCHEMES, SOIL_SCHEMES


@pytest.fixture(scope="module")
def params():
    return load_params("USGS", "STAS")


def test_special_class_indices(params):
    assert int(params.veg.isurban) == 1
    assert int(params.veg.iswater) == 16
    assert int(params.veg.isbarren) == 19
    assert int(params.veg.isice) == 24
    assert int(params.veg.isegblf) == 13


def test_veg_rad_row(params):
    # RAD#USGS class 2: XL=-0.3, RHOL=(0.11, 0.58), TAUS=(0.22, 0.38)
    assert np.isclose(float(params.veg.xl[2]), -0.3)
    np.testing.assert_allclose(np.asarray(params.veg.rhol[2]), [0.11, 0.58])
    np.testing.assert_allclose(np.asarray(params.veg.taus[2]), [0.22, 0.38])


def test_veg_monthly_lai(params):
    # LAI12M#USGS class 11 (Deciduous Broadleaf): June = 4.7
    assert np.isclose(float(params.veg.lai12m[11, 5]), 4.7)
    assert params.veg.lai12m.shape[1] == 12


def test_soil_parm_row(params):
    # PARM#STAS type 12 (CLAY): B=11.55, SMCMAX=0.468
    assert np.isclose(float(params.soil.bexp[12]), 11.55)
    assert np.isclose(float(params.soil.smcmax[12]), 0.468)
    assert np.isclose(float(params.soil.dksat[1]), 4.66e-5)


def test_soil_derived_kdt(params):
    # KDT = KDTREF * DKSAT / DKREF with KDTREF=1.0, DKREF=2e-6
    assert np.isclose(float(params.soil.kdt[1]), 4.66e-5 / 2.0e-6, rtol=1e-5)


def test_frzx_compat_flag():
    buggy = load_params("USGS", "STAS", frzx_compat=True)
    fixed = load_params("USGS", "STAS", frzx_compat=False)
    ratio = float(fixed.soil.frzx[1] / buggy.soil.frzx[1])
    assert np.isclose(ratio, 1000.0, rtol=1e-4)


def test_soil_color_albedo(params):
    # COLOR row 4: ALBSAT=(0.09, 0.18) ALBDRY=(0.18, 0.36)
    np.testing.assert_allclose(np.asarray(params.soil.albsat[4]), [0.09, 0.18])
    np.testing.assert_allclose(np.asarray(params.soil.albdry[4]), [0.18, 0.36])


def test_gen_scalars(params):
    g = params.gen
    assert np.isclose(float(g.csoil), 2.0e6)
    assert np.isclose(float(g.zbot), -8.0)
    assert np.isclose(float(g.czil), 0.1)
    assert np.isclose(float(g.ssi), 0.03)
    np.testing.assert_allclose(np.asarray(g.omegas), [0.8, 0.4])
    np.testing.assert_allclose(np.asarray(g.alblake), [0.6, 0.4])
    assert np.isclose(float(g.slope[1]), 0.10)
    assert np.isclose(float(g.slope[3]), 1.00)


@pytest.mark.parametrize("veg_scheme", VEG_SCHEMES)
@pytest.mark.parametrize("soil_scheme", SOIL_SCHEMES)
def test_all_schemes_load(veg_scheme, soil_scheme):
    p = load_params(veg_scheme, soil_scheme)
    # all non-padding rows of key tables must be finite
    assert np.all(np.isfinite(np.asarray(p.veg.hvt)))
    assert np.all(np.isfinite(np.asarray(p.soil.bexp)))
