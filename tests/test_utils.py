"""Tests for the observability utilities."""

import numpy as np
import jax.numpy as jnp
import pytest

from noahmp_jax import utils
from noahmp_jax.state import init_state


def test_check_budgets_pass_and_fail():
    class F:
        errsw = jnp.zeros(4)
        erreng = jnp.zeros(4)
        errwat = jnp.zeros(4)
    utils.check_budgets(F)

    class Bad:
        errsw = jnp.asarray([0.0, 0.5, 0.0, 0.0])
        erreng = jnp.zeros(4)
        errwat = jnp.zeros(4)
    with pytest.raises(utils.ConservationError, match="column 1"):
        utils.check_budgets(Bad)


def test_check_budgets_respects_ist():
    class F:
        errsw = jnp.zeros(2)
        erreng = jnp.zeros(2)
        errwat = jnp.asarray([5.0, 0.0])  # lake column may not close
    utils.check_budgets(F, ist=jnp.asarray([2, 1]))
    with pytest.raises(utils.ConservationError):
        utils.check_budgets(F, ist=jnp.asarray([1, 1]))


def test_nan_report_and_assert_finite():
    st = init_state(3)
    assert utils.nan_report(st) == {}
    bad = st._replace(tg=jnp.asarray(st.tg).at[1].set(jnp.nan))
    rep = utils.nan_report(bad)
    assert any("tg" in k for k in rep)
    with pytest.raises(FloatingPointError, match="tg"):
        utils.assert_finite(bad)


def test_step_timer():
    t = utils.StepTimer(100)
    for _ in range(3):
        with t:
            pass
    assert t.steps == 3
    assert t.points_per_sec > 0
    assert "point-steps/s" in t.summary()
