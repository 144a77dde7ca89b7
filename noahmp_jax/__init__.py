"""noahmp_jax — NoahMP as a batched JAX land surface model.

Quick start::

    from noahmp_jax import load_params, Options, init_state, init_static
    from noahmp_jax import make_step

    params = load_params("USGS", "STAS")
    step = make_step(params, Options(), dt=900.0)
    state, flux = step(static, forcing, state)

See README.md for the architecture and PARITY.md for the reference
component map.
"""

from .constants import NBAND, NSOIL, MSNOW, NLEVELS
from .options import Options, DEFAULT_OPTIONS
from .params import load_params, Params
from .state import State, Static, Forcing, Flux, init_state, init_static
from .driver.step import make_step, simulate
from . import utils

__version__ = "0.1.0"

__all__ = [
    "NBAND", "NSOIL", "MSNOW", "NLEVELS",
    "Options", "DEFAULT_OPTIONS", "load_params", "Params",
    "State", "Static", "Forcing", "Flux", "init_state", "init_static",
    "make_step", "simulate", "utils", "__version__",
]
