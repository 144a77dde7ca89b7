"""geo_em (WRF geogrid) ingestion tests: synthesize a geogrid file with
the native NetCDF writer, build Static through driver/geo.py, and check
masking, field mapping, and grid scatter/gather round trips."""

import numpy as np
import pytest

from noahmp_jax.driver import geo, io, netcdf


@pytest.fixture()
def geo_em_path(tmp_path):
    ny, nx = 5, 8
    rng = np.random.default_rng(3)
    lat = np.linspace(30.0, 45.0, ny)[:, None] + np.zeros((1, nx))
    lon = np.zeros((ny, 1)) + np.linspace(-110.0, -80.0, nx)[None, :]
    lu = rng.choice([2, 5, 7, 8, 11, 14], (ny, nx)).astype(np.float32)
    lu[0, :3] = 17.0   # water (MODIS ISWATER)
    lu[4, 7] = 15.0    # ice
    landmask = (lu != 17.0).astype(np.float32)
    greenfrac = rng.uniform(0.2, 0.9, (12, ny, nx)).astype(np.float32)
    soiltemp = np.full((ny, nx), 282.0, np.float32)
    soiltemp[1, 1] = 0.0  # missing value -> default
    arrays = {
        "XLAT_M": lat[None].astype(np.float32),
        "XLONG_M": lon[None].astype(np.float32),
        "LU_INDEX": lu[None],
        "LANDMASK": landmask[None],
        "SCT_DOM": rng.integers(1, 12, (1, ny, nx)).astype(np.float32),
        "SLOPECAT": np.ones((1, ny, nx), np.float32),
        "SOILTEMP": soiltemp[None],
        "GREENFRAC": greenfrac[None],
    }
    p = str(tmp_path / "geo_em.d01.nc")
    netcdf.write_classic(
        p, arrays,
        dims={"Time": 1, "south_north": ny, "west_east": nx,
              "month": 12},
        var_dims={
            "XLAT_M": ("Time", "south_north", "west_east"),
            "XLONG_M": ("Time", "south_north", "west_east"),
            "LU_INDEX": ("Time", "south_north", "west_east"),
            "LANDMASK": ("Time", "south_north", "west_east"),
            "SCT_DOM": ("Time", "south_north", "west_east"),
            "SLOPECAT": ("Time", "south_north", "west_east"),
            "SOILTEMP": ("Time", "south_north", "west_east"),
            "GREENFRAC": ("Time", "month", "south_north", "west_east"),
        },
        attrs={"MMINLU": "MODIFIED_IGBP_MODIS_NOAH", "ISWATER": 17,
               "ISICE": 15})
    return p, lu, greenfrac


def test_static_from_geo_em(geo_em_path):
    p, lu, greenfrac = geo_em_path
    static, mapping = geo.static_from_geo_em(p, month=7)
    n = mapping.n_points
    assert n == int(np.sum(lu != 17.0))
    assert mapping.scheme == "MODIFIED_IGBP_MODIS_NOAH"
    # water cells excluded, ice flagged
    lut = np.asarray(static.lutyp)
    assert not np.any(lut == 17)
    assert np.sum(np.asarray(static.ice)) == int(np.sum(lu == 15.0))
    # lat converted to radians
    assert np.all(np.asarray(static.lat) < 1.0)
    assert np.all(np.asarray(static.lat) > 0.4)
    # SOILTEMP==0 fell back to the default
    assert np.any(np.asarray(static.tbot) == 285.0)
    assert np.sum(np.asarray(static.tbot) == 285.0) == 1
    # shdfac from month 7, shdmax = yearly max
    gf_pts = greenfrac.reshape(12, -1)[:, mapping.index]
    np.testing.assert_allclose(np.asarray(static.shdfac), gf_pts[6],
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(static.shdmax),
                               gf_pts.max(axis=0), rtol=1e-6)


def test_scatter_gather_roundtrip(geo_em_path):
    p, lu, _ = geo_em_path
    _, mapping = geo.static_from_geo_em(p)
    v = np.arange(mapping.n_points, dtype=np.float32)
    grid = mapping.scatter(v)
    assert grid.shape == mapping.shape
    assert np.isnan(grid).sum() == lu.size - mapping.n_points
    np.testing.assert_array_equal(mapping.gather(grid), v)
    # layered fields keep trailing axes
    v2 = np.stack([v, v + 1], axis=-1)
    g2 = mapping.scatter(v2)
    assert g2.shape == mapping.shape + (2,)
    np.testing.assert_array_equal(mapping.gather(g2), v2)


def test_load_domain_detects_geogrid(geo_em_path):
    p, lu, _ = geo_em_path
    static = io.load_domain(p)
    assert static.lat.shape[0] == int(np.sum(lu != 17.0))


def test_write_grid_output(geo_em_path, tmp_path):
    scipy_io = pytest.importorskip("scipy.io")
    p, _, _ = geo_em_path
    _, mapping = geo.static_from_geo_em(p)
    out = str(tmp_path / "grid_out.nc")
    geo.write_grid_output(out, mapping,
                          {"tg": np.full(mapping.n_points, 280.0,
                                         np.float32)})
    with scipy_io.netcdf_file(out, "r", mmap=False) as f:
        tg = f.variables["tg"][:]
        assert tg.shape == mapping.shape
        assert np.nansum(tg == 280.0) == mapping.n_points
