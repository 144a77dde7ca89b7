"""Compact (device-interp) chunk forcing vs the exact host-assembled
stack: same hourly files, same schedule, near-identical values (the
only permitted difference is FMA/fusion ulp in the on-device linear
interpolation)."""

import datetime
import os
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "examples"))


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    import make_case

    d = tmp_path_factory.mktemp("compact_case")
    make_case.conus(24, seed=3, days=1, outdir=str(d), fmt="nc")
    return str(d)


def test_frame_fields_match_provider_contract():
    from noahmp_jax.driver import io as io_mod

    assert set(io_mod.FRAME_FIELDS) == \
        set(io_mod.FileForcing.INTERP) | set(io_mod.FileForcing.HOLD)
    assert set(io_mod.FileForcing.HOLD) == \
        set(io_mod.FRAME_FIELDS) - io_mod._INTERP_SET


def test_compact_expander_matches_exact_stack(case_dir):
    import jax
    from noahmp_jax.driver import io as io_mod
    from noahmp_jax.driver.config import Config

    cfg = Config.from_namelist(os.path.join(case_dir, "case.nml"))
    static = io_mod.load_domain(cfg.constfile)
    provider = io_mod.FileForcing(cfg.indir, cfg.infreq, static,
                                  prefetch=False)
    when = cfg.begdatetime + datetime.timedelta(hours=2)
    steps, ts = 8, cfg.timestep

    # exact: host per-step assembly
    exact = jax.tree.map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]),
        *[provider(when + i * ts) for i in range(steps)])

    parts = io_mod.compact_chunk(provider, when, steps, ts)
    stacked = io_mod.make_chunk_expander()(*jax.device_put(parts))

    for f in exact._fields:
        a = np.asarray(getattr(exact, f), np.float64)
        b = np.asarray(getattr(stacked, f), np.float64)
        np.testing.assert_allclose(
            b, a, rtol=2e-6, atol=1e-5 * max(1.0, np.abs(a).max()),
            err_msg=f"compact forcing field {f} diverged")


def test_compact_chunk_run_matches_exact(case_dir):
    """Full chunked driver run in compact mode tracks the exact mode
    closely (state-level; interp ulps only)."""
    from noahmp_jax.driver.config import Config
    from noahmp_jax.driver.run import run_offline

    def cfg_for(tag):
        cfg = Config.from_namelist(os.path.join(case_dir, "case.nml"))
        cfg.outdir = os.path.join(case_dir, "ldasout_" + tag)
        cfg.resdir = os.path.join(case_dir, "restart_" + tag)
        os.makedirs(cfg.outdir, exist_ok=True)
        os.makedirs(cfg.resdir, exist_ok=True)
        cfg.enddatetime = cfg.begdatetime + datetime.timedelta(hours=6)
        return cfg

    st_e, _ = run_offline(cfg_for("exact"), verbose=False,
                          chunk_steps=8)
    st_c, _ = run_offline(cfg_for("compact"), verbose=False,
                          chunk_steps=8, forcing_mode="compact")
    np.testing.assert_allclose(np.asarray(st_c.tg),
                               np.asarray(st_e.tg), atol=5e-3)
    np.testing.assert_allclose(np.asarray(st_c.swc),
                               np.asarray(st_e.swc), atol=1e-5)
