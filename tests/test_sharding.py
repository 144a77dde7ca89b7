"""SPMD tests on the 8-device virtual CPU mesh (SURVEY.md section 4,
item 4): sharded step compiles/executes, results are bitwise identical
to the single-device run, and checkpoints round-trip sharded."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from noahmp_jax.params import load_params
from noahmp_jax.options import Options
from noahmp_jax.state import init_state, init_static, Forcing
from noahmp_jax.driver.step import make_step
from noahmp_jax.dist.mesh import (make_mesh, make_sharded_step,
                                  shard_batch)


@pytest.fixture(scope="module")
def setup():
    params = load_params()
    n = 64
    static = init_static(n)
    static = static._replace(
        lutyp=jnp.asarray(np.resize([1, 7, 11, 14], n), jnp.int32),
        sltyp=jnp.asarray(np.resize([3, 6, 9, 12], n), jnp.int32))
    state = init_state(n)

    def rep(v):
        return jnp.broadcast_to(jnp.float32(v), (n,))
    forcing = Forcing(
        sfctmp=rep(290.0), sfcprs=rep(90000.0), psfc=rep(90000.0),
        uu=rep(3.0), vv=rep(1.0), q2=rep(0.007), soldn=rep(500.0),
        lwdn=rep(330.0), prcp=rep(0.0008), cosz=rep(0.6),
        co2air=rep(39.0), o2air=rep(18900.0), foln=rep(1.0),
        julian=rep(180.0), yearlen=rep(366.0))
    return params, static, forcing, state


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_sharded_step_runs(setup):
    params, static, forcing, state = setup
    mesh = make_mesh()
    step = make_sharded_step(params, Options(), 900.0, mesh,
                             donate=False)
    st = shard_batch(state, mesh)
    new_state, flux, diags = step(shard_batch(static, mesh),
                                  shard_batch(forcing, mesh), st)
    assert float(diags.max_abs_errsw) < 0.01
    assert float(diags.max_abs_erreng) < 0.02
    # outputs stay sharded over the points axis
    assert "points" in str(new_state.tg.sharding)


def test_sharded_matches_single_device(setup):
    """Determinism across shardings: identical columns must produce
    identical bits on 1 device vs 8 devices."""
    params, static, forcing, state = setup
    single = make_step(params, Options(), 900.0, donate=False)
    s1, f1 = single(static, forcing, state)

    mesh = make_mesh()
    sharded = make_sharded_step(params, Options(), 900.0, mesh,
                                donate=False)
    s8, f8, _ = sharded(shard_batch(static, mesh),
                        shard_batch(forcing, mesh),
                        shard_batch(state, mesh))
    for name in ("tg", "tv", "stc", "swc", "sneqv"):
        np.testing.assert_array_equal(
            np.asarray(getattr(s1, name)),
            np.asarray(getattr(s8, name)),
            err_msg=f"{name} differs between shardings")
    np.testing.assert_array_equal(np.asarray(f1.fsh),
                                  np.asarray(f8.fsh))


def test_sharded_checkpoint_roundtrip(tmp_path, setup):
    from noahmp_jax.dist.checkpoint import CheckpointManager
    _params, _static, _forcing, state = setup
    mesh = make_mesh()
    st = shard_batch(state, mesh)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, st, wait=True)
    st2 = mgr.restore(template=st)
    np.testing.assert_array_equal(np.asarray(st.stc),
                                  np.asarray(st2.stc))
    assert mgr.latest_step() == 3
    mgr.close()


@pytest.mark.slow
def test_batch_minor_layout_matches_major(setup):
    """The batch-minor layout (points on the 128-lane axis, PERF.md
    lever 2) is bit-identical to the default batch-major layout."""
    from noahmp_jax.driver.step import batch_to_layout

    params, static, forcing, state = setup
    opts = Options()

    s_major = make_step(params, opts, 900.0, donate=False)
    s_minor = make_step(params, opts, 900.0, donate=False,
                        layout="minor")

    st_a, fl_a = s_major(static, forcing, state)
    st_b, fl_b = s_minor(batch_to_layout(static, "minor"),
                         batch_to_layout(forcing, "minor"),
                         batch_to_layout(state, "minor"))
    for name in st_a._fields:
        a = np.asarray(getattr(st_a, name))
        b = np.asarray(getattr(st_b, name))
        if a.ndim > 1:
            b = np.moveaxis(b, -1, 0)
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(np.asarray(fl_a.fsh),
                                  np.asarray(fl_b.fsh))


def test_sharded_output_write_and_merge(tmp_path):
    """Multi-host-grade output (VERDICT r3 missing #3): 8 per-shard
    writers (one per virtual device, emulating 8 hosts) each write only
    their slice of a sharded window; merge_shard_files reconstructs the
    gridded ldasout file — equal to the single-writer file and
    byte-stable across re-merges."""
    import datetime
    import os
    from noahmp_jax.driver import io as io_mod
    from noahmp_jax.driver.io import OutputWriter, merge_shard_files
    from noahmp_jax.dist.mesh import make_mesh, shard_batch

    n = 64
    mesh = make_mesh(jax.devices()[:8])
    rng = np.random.default_rng(3)
    state = init_state(n)._replace(
        tg=jnp.asarray(rng.uniform(260, 300, n).astype(np.float32)))
    means = {"fsh": rng.uniform(-50, 200, n).astype(np.float32),
             "fsa": rng.uniform(0, 800, n).astype(np.float32)}
    state_sh = shard_batch(state, mesh)
    means_sh = shard_batch(means, mesh)
    when = datetime.datetime(2000, 1, 1, 3)

    # single-writer reference file
    ref_dir = tmp_path / "ref"
    w = OutputWriter(str(ref_dir), datetime.timedelta(hours=3),
                     fields=tuple(means))
    w.push_window(when, {k: np.asarray(v) for k, v in means_sh.items()},
                  state_sh)

    # 8 shard writers emulating 8 single-device hosts
    out_dir = tmp_path / "out"
    per = n // 8
    for k in range(8):
        ws = OutputWriter(str(out_dir), datetime.timedelta(hours=3),
                          fields=tuple(means),
                          shard=(k * per, (k + 1) * per, n))
        ws.push_window(when, means_sh, state_sh)
    shard_files = sorted(os.listdir(out_dir))
    assert len(shard_files) == 8 and all(".nc.p" in f
                                         for f in shard_files)

    merged = merge_shard_files(str(out_dir))
    assert len(merged) == 1
    got = io_mod.load_arrays(merged[0])
    ref = io_mod.load_arrays(str(ref_dir / os.path.basename(merged[0])))
    assert set(got) == set(ref)
    for kk in ref:
        np.testing.assert_array_equal(got[kk], ref[kk], err_msg=kk)

    # byte-stability: re-merge reproduces identical bytes
    bytes1 = open(merged[0], "rb").read()
    merged2 = merge_shard_files(str(out_dir))
    assert open(merged2[0], "rb").read() == bytes1
