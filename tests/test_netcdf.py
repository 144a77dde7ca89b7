"""NetCDF backend tests: classic-format round trips cross-validated
against scipy.io.netcdf, record-dimension reads, HDF5/NetCDF-4 reads via
h5py, and the driver-level .nc restart/output contract
(the reference's intended file layout, run/case.nml:2-11)."""

import datetime

import numpy as np
import pytest

from noahmp_jax.driver import netcdf


def test_classic_roundtrip_self(tmp_path):
    p = str(tmp_path / "a.nc")
    arrays = {
        "t2": np.arange(12, dtype=np.float32).reshape(3, 4),
        "mask": np.array([1, 0, 1], np.int32),
        "zsoil": np.array([-0.1, -0.4, -1.0, -2.0], np.float64),
        "tag": np.asarray("hello-world"),
        "scalar": np.float32(2.5),
    }
    netcdf.write_classic(p, arrays, attrs={"title": "test", "n": 3})
    assert netcdf.sniff(p) == "classic"
    ds = netcdf.read(p)
    assert ds.attrs["title"] == "test"
    np.testing.assert_array_equal(ds.variables["t2"].data, arrays["t2"])
    np.testing.assert_array_equal(ds.variables["mask"].data,
                                  arrays["mask"])
    np.testing.assert_array_equal(ds.variables["zsoil"].data,
                                  arrays["zsoil"])
    assert ds.variables["zsoil"].data.dtype == np.float64
    assert ds.variables["tag"].data.ravel()[0] == b"hello-world"
    assert float(ds.variables["scalar"].data) == 2.5


def test_classic_read_by_scipy(tmp_path):
    """Files we write must parse with an independent implementation."""
    scipy_io = pytest.importorskip("scipy.io")
    p = str(tmp_path / "b.nc")
    a = np.linspace(0, 1, 20, dtype=np.float32).reshape(4, 5)
    netcdf.write_classic(p, {"x": a, "k": np.array([7], np.int32)},
                         dims={"lat": 4, "lon": 5},
                         var_dims={"x": ("lat", "lon")},
                         attrs={"src": "noahmp_jax"})
    with scipy_io.netcdf_file(p, "r", mmap=False) as f:
        np.testing.assert_array_equal(f.variables["x"][:], a)
        assert f.dimensions["lat"] == 4
        assert f.variables["x"].dimensions == ("lat", "lon")
        assert f.src == b"noahmp_jax"
        np.testing.assert_array_equal(f.variables["k"][:], [7])


def test_classic_read_scipy_written_with_record_dim(tmp_path):
    """Record (unlimited) dims written by scipy read back correctly."""
    scipy_io = pytest.importorskip("scipy.io")
    p = str(tmp_path / "c.nc")
    with scipy_io.netcdf_file(p, "w") as f:
        f.createDimension("time", None)
        f.createDimension("points", 6)
        v = f.createVariable("swe", np.float32, ("time", "points"))
        u = f.createVariable("tg", np.float32, ("time", "points"))
        w = f.createVariable("lat", np.float32, ("points",))
        w[:] = np.arange(6, dtype=np.float32)
        for t in range(5):
            v[t] = t + np.arange(6, dtype=np.float32)
            u[t] = 280.0 + t
        f.history = "made by scipy"
    ds = netcdf.read(p)
    assert ds.dims["time"] == 5 and ds.dims["points"] == 6
    assert ds.variables["swe"].dims == ("time", "points")
    np.testing.assert_array_equal(
        ds.variables["swe"].data,
        np.arange(5, dtype=np.float32)[:, None]
        + np.arange(6, dtype=np.float32)[None, :])
    np.testing.assert_array_equal(ds.variables["tg"].data[:, 0],
                                  280.0 + np.arange(5, dtype=np.float32))
    assert "scipy" in str(ds.attrs["history"])


def test_single_record_var_no_padding(tmp_path):
    """The spec's special case: exactly one record variable is packed
    without inter-record padding."""
    scipy_io = pytest.importorskip("scipy.io")
    p = str(tmp_path / "d.nc")
    with scipy_io.netcdf_file(p, "w") as f:
        f.createDimension("time", None)
        v = f.createVariable("q", np.int16, ("time",))
        for t in range(7):
            v[t] = t * 3
    ds = netcdf.read(p)
    np.testing.assert_array_equal(ds.variables["q"].data,
                                  3 * np.arange(7, dtype=np.int16))


def test_hdf5_read(tmp_path):
    h5py = pytest.importorskip("h5py")
    p = str(tmp_path / "e.nc")
    with h5py.File(p, "w") as f:
        d = f.create_dataset("points", data=np.arange(8.0))
        d.make_scale("points")
        v = f.create_dataset("tg", data=280.0
                             + np.arange(8, dtype=np.float32))
        v.dims[0].attach_scale(d)
        v.attrs["units"] = "K"
        f.attrs["title"] = "nc4-style"
    ds = netcdf.read(p)
    assert netcdf.sniff(p) == "hdf5"
    assert ds.dims["points"] == 8
    assert ds.variables["tg"].dims == ("points",)
    assert ds.variables["tg"].attrs["units"] == "K"
    assert ds.attrs["title"] == "nc4-style"
    np.testing.assert_allclose(ds.variables["tg"].data,
                               280.0 + np.arange(8))


def test_driver_nc_restart_roundtrip(tmp_path):
    from noahmp_jax.driver import io
    from noahmp_jax.state import init_state

    state = init_state(5)
    when = datetime.datetime(2000, 1, 31, 12, 0)
    p = str(tmp_path / "restart" / "RESTART.2000013112.nc")
    written = io.save_restart(p, state, when)
    assert written.endswith(".nc") and netcdf.sniff(written) == "classic"
    state2, when2 = io.load_restart(written)
    assert when2 == when
    for name in state._fields:
        np.testing.assert_array_equal(np.asarray(getattr(state, name)),
                                      np.asarray(getattr(state2, name)),
                                      err_msg=name)


def test_output_writer_nc(tmp_path):
    scipy_io = pytest.importorskip("scipy.io")
    from noahmp_jax.driver import io
    from noahmp_jax.state import init_state
    from noahmp_jax.physics.sflx import Flux

    n = 4
    state = init_state(n)
    flux = Flux(*[np.full((n,), 1.5, np.float32)
                  for _ in Flux._fields])
    w = io.OutputWriter(str(tmp_path / "ldasout"),
                        datetime.timedelta(hours=3))
    t0 = datetime.datetime(2000, 1, 1, 0, 0)
    files = []
    for k in range(1, 13):  # 12 x 900s = one 3h boundary
        files = w.push(t0 + datetime.timedelta(seconds=900 * k), flux,
                       state)
    assert len(files) == 1 and files[0].endswith("0300.nc")
    with scipy_io.netcdf_file(files[0], "r", mmap=False) as f:
        np.testing.assert_allclose(f.variables["fsh"][:],
                                   np.full((n,), 1.5, np.float32))
        assert f.variables["smc"][:].shape == (n, 4)


def test_hdf5_write_roundtrip(tmp_path):
    pytest.importorskip("h5py")
    p = str(tmp_path / "w4.nc4")
    arrays = {
        "tg": 280.0 + np.arange(12, dtype=np.float32).reshape(3, 4),
        "mask": np.array([1, 0, 1, 1], np.int32),
        "points": np.arange(4, dtype=np.float64),  # coordinate var
    }
    netcdf.write_hdf5(p, arrays,
                      dims={"time": 3, "points": 4},
                      var_dims={"tg": ("time", "points"),
                                "mask": ("points",),
                                "points": ("points",)},
                      attrs={"title": "nc4-out"},
                      var_attrs={"tg": {"units": "K"}})
    assert netcdf.sniff(p) == "hdf5"
    ds = netcdf.read(p)
    assert ds.attrs["title"] == "nc4-out"
    assert ds.dims["time"] == 3 and ds.dims["points"] == 4
    assert ds.variables["tg"].dims == ("time", "points")
    assert ds.variables["tg"].attrs["units"] == "K"
    np.testing.assert_array_equal(ds.variables["tg"].data,
                                  arrays["tg"])
    np.testing.assert_array_equal(ds.variables["mask"].data,
                                  arrays["mask"])
    np.testing.assert_array_equal(ds.variables["points"].data,
                                  arrays["points"])


def test_hdf5_write_compressed_autodims(tmp_path):
    pytest.importorskip("h5py")
    from noahmp_jax.driver import io
    p = str(tmp_path / "big.nc4")
    arrays = {"smc": np.random.default_rng(0).random(
        (2048, 4)).astype(np.float32)}
    io.save_arrays(p, arrays)           # .nc4 -> NetCDF-4 writer
    ds = netcdf.read(p)
    np.testing.assert_array_equal(ds.variables["smc"].data,
                                  arrays["smc"])
    assert ds.variables["smc"].dims == ("n2048", "n4")


def test_output_writer_nc4(tmp_path):
    pytest.importorskip("h5py")
    from noahmp_jax.driver import io
    from noahmp_jax.state import init_state
    from noahmp_jax.physics.sflx import Flux

    n = 4
    state = init_state(n)
    flux = Flux(*[np.full((n,), 1.5, np.float32)
                  for _ in Flux._fields])
    w = io.OutputWriter(str(tmp_path / "ldasout"),
                        datetime.timedelta(hours=3), fmt="nc4")
    when = datetime.datetime(2000, 1, 1, 0, 0)
    step = datetime.timedelta(minutes=30)
    files = []
    for _ in range(6):
        when += step
        files = w.push(when, flux, state)
    assert len(files) == 1 and files[0].endswith(".nc4")
    ds = netcdf.read(files[0])
    np.testing.assert_allclose(ds.variables["fsa"].data,
                               np.full((n,), 1.5), rtol=1e-6)


def test_classic_slice_read(tmp_path):
    """Byte-range slicing of classic variables matches full reads
    (the CONUS-scale sharded-ingestion path)."""
    p = str(tmp_path / "slice.nc")
    rng = np.random.default_rng(1)
    arrays = {
        "sfctmp": rng.random(1000).astype(np.float32) * 30 + 270,
        "smc": rng.random((1000, 4)).astype(np.float32),
        "zsoil": np.array([-0.1, -0.4, -1.0, -2.0], np.float32),
        "count": np.int32(7),
    }
    netcdf.write_classic(p, arrays)
    meta = netcdf.read_classic_meta(p)
    assert meta["smc"].shape == (1000, 4)
    np.testing.assert_array_equal(
        netcdf.read_classic_slice(p, "sfctmp", 100, 200),
        arrays["sfctmp"][100:200])
    np.testing.assert_array_equal(
        netcdf.read_classic_slice(p, "smc", 990, 1000),
        arrays["smc"][990:])
    d = netcdf.read_arrays_slice(p, 250, 500)
    np.testing.assert_array_equal(d["sfctmp"], arrays["sfctmp"][250:500])
    np.testing.assert_array_equal(d["smc"], arrays["smc"][250:500])
    np.testing.assert_array_equal(d["zsoil"], arrays["zsoil"])


def test_hdf5_slice_read(tmp_path):
    pytest.importorskip("h5py")
    p = str(tmp_path / "slice.nc4")
    rng = np.random.default_rng(2)
    arrays = {"q2": rng.random(512).astype(np.float32) * 0.01,
              "lat": rng.random(512).astype(np.float32)}
    netcdf.write_hdf5(p, arrays)
    d = netcdf.read_arrays_slice(p, 64, 128, axis_len=512)
    np.testing.assert_array_equal(d["q2"], arrays["q2"][64:128])
    np.testing.assert_array_equal(d["lat"], arrays["lat"][64:128])


def test_file_forcing_points_slice(tmp_path):
    """FileForcing with points_slice reads only its shard of the
    global forcing file."""
    import datetime as dtmod
    from noahmp_jax.driver import io
    from noahmp_jax.state import init_static

    n_global, lo, hi = 64, 16, 32
    indir = tmp_path / "ldasin"
    indir.mkdir()
    rng = np.random.default_rng(3)
    base = {
        "sfctmp": rng.random(n_global).astype(np.float32) * 20 + 275,
        "sfcprs": np.full(n_global, 9.0e4, np.float32),
        "q2": np.full(n_global, 0.007, np.float32),
        "uu": np.full(n_global, 2.0, np.float32),
        "vv": np.full(n_global, 1.0, np.float32),
        "soldn": np.full(n_global, 400.0, np.float32),
        "lwdn": np.full(n_global, 330.0, np.float32),
        "prcp": np.full(n_global, 1e-4, np.float32),
    }
    for hr in (0, 1):
        netcdf.write_classic(str(indir / f"200001010{hr}.nc"), base)

    static = init_static(hi - lo)
    ff = io.FileForcing(str(indir), dtmod.timedelta(hours=1), static,
                        prefetch=False, points_slice=(lo, hi))
    f = ff(dtmod.datetime(2000, 1, 1, 0, 30))
    assert f.sfctmp.shape == (hi - lo,)
    np.testing.assert_allclose(f.sfctmp, base["sfctmp"][lo:hi],
                               atol=1e-5)
