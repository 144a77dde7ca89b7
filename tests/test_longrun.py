"""Long-run stability: a seasonal-cycle spin-up via lax.scan (the
BASELINE.md config-5 shape).  Checks state stays physical and budgets
stay closed over many steps with varying forcing."""

import numpy as np
import jax
import jax.numpy as jnp

from noahmp_jax.params import load_params
from noahmp_jax.options import Options
from noahmp_jax.state import init_state, init_static, Forcing
from noahmp_jax.driver.step import simulate


def test_seasonal_scan_stability():
    n = 8
    T = 384  # 4 days at 900 s (compile once, scan the rest)
    params = load_params()
    static = init_static(n, lutyp=7, sltyp=6)
    state = init_state(n)

    t = np.arange(T) * 900.0 / 86400.0
    diurnal = np.sin((t % 1.0 - 0.25) * 2 * np.pi)
    cosz = np.clip(diurnal, -0.3, 1.0).astype(np.float32)
    soldn = np.maximum(0.0, 800.0 * cosz).astype(np.float32)
    sfctmp = (283.0 + 7.0 * diurnal).astype(np.float32)
    prcp = np.where((t * 96).astype(int) % 37 == 0, 0.002,
                    0.0).astype(np.float32)

    def tvar(v):
        return jnp.broadcast_to(jnp.asarray(v)[:, None], (T, n))

    def const(v):
        return jnp.broadcast_to(jnp.float32(v), (T, n))

    forcings = Forcing(
        sfctmp=tvar(sfctmp), sfcprs=const(90000.0), psfc=const(90000.0),
        uu=const(3.0), vv=const(1.0), q2=const(0.006),
        soldn=tvar(soldn), lwdn=const(320.0), prcp=tvar(prcp),
        cosz=tvar(cosz), co2air=const(39.0), o2air=const(18900.0),
        foln=const(1.0), julian=tvar(np.full(T, 30.0, np.float32)
                                     + t.astype(np.float32)),
        yearlen=const(366.0))

    final, fluxes = simulate(params, Options(), 900.0, static, forcings,
                             state)
    # no NaNs anywhere in the trajectory
    for name in ("trad", "fsh", "errwat", "erreng"):
        arr = np.asarray(getattr(fluxes, name))
        assert np.all(np.isfinite(arr)), f"{name} has non-finite values"
    # budgets closed at every step
    assert np.max(np.abs(np.asarray(fluxes.errsw))) < 0.01
    assert np.max(np.abs(np.asarray(fluxes.erreng))) < 0.05
    assert np.max(np.abs(np.asarray(fluxes.errwat))) < 0.5
    # physical state at the end
    assert np.all(np.asarray(final.tg) > 230.0)
    assert np.all(np.asarray(final.tg) < 340.0)
    assert np.all(np.asarray(final.swc) >= 0.0)
    assert np.all(np.asarray(final.swc) <= 0.55)
    assert np.all(np.asarray(final.sneqv) >= 0.0)
