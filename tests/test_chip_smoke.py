"""chip_smoke.py off the GPU: its device check refuses the CPU, the
compile-cache rule every entry point follows, and its phases rehearsed
on CPU at 64 points over 8 steps (the same functions the GPU run
calls, only smaller)."""

import os
import subprocess
import sys

import pytest

import chip_smoke
from noahmp_jax.utils import CHECKOUT_CACHE_DIR

N = 64
STEPS = 8


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("env_set", [True, False], ids=["set", "unset"])
def test_compile_cache_rule(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and no code sets
    another; unset, the cache is <checkout>/.jax_cache."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    want = CHECKOUT_CACHE_DIR
    if env_set:
        want = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    code = ("import jax, jax.numpy as jnp\n"
            "from noahmp_jax.utils import enable_compile_cache\n"
            "print(enable_compile_cache())\n"
            "jax.jit(lambda x: x * 3.0 + 1.0)(jnp.ones(3))"
            ".block_until_ready()\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=os.path.dirname(CHECKOUT_CACHE_DIR),
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert out == [want, want]
    if env_set:
        assert os.listdir(want), "nothing cached in the env directory"


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return chip_smoke.phase_case(str(tmp_path_factory.mktemp("smoke")),
                                 n=N, steps=STEPS)


def test_case_phase(case):
    _nml, res = case
    assert res["points"] == N and res["steps"] == STEPS
    assert res["max_abs_errsw_Wm2"] < 0.01
    assert res["max_abs_erreng_Wm2"] < 0.01


def test_resume_phase(case):
    chip_smoke.phase_resume(case[0], steps=STEPS)


def test_oracle_phase(case):
    chip_smoke.phase_oracle(case[0], ncols=N, nsteps=4)


def test_four_device_phase(tmp_path):
    """The sharded run and step on four of the suite's virtual CPU
    devices agree bitwise with one device."""
    chip_smoke.phase_four(str(tmp_path), n=N, steps=STEPS)
