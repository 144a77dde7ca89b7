"""Quick end-to-end smoke run of the batched column step on CPU."""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from noahmp_jax.params import load_params
from noahmp_jax.options import Options
from noahmp_jax.state import init_state, init_static, Forcing
from noahmp_jax.driver.step import make_step

n = 8
params = load_params("USGS", "STAS")
opts = Options()
static = init_static(n, lutyp=7, sltyp=6)
state = init_state(n)


def forcing(n, julian=180.0):
    def rep(v):
        return np.broadcast_to(np.float32(v), (n,))
    return Forcing(
        sfctmp=rep(295.0), sfcprs=rep(90000.0), psfc=rep(90000.0),
        uu=rep(3.0), vv=rep(1.0), q2=rep(0.008), soldn=rep(600.0),
        lwdn=rep(350.0), prcp=rep(0.001), cosz=rep(0.7),
        co2air=rep(39.0), o2air=rep(18900.0), foln=rep(1.0),
        julian=rep(julian), yearlen=rep(366.0))


step = make_step(params, opts, dt=900.0, donate=False)
f = forcing(n)
new_state, flux = step(static, f, state)
print("tg:", np.asarray(new_state.tg[:3]))
print("tv:", np.asarray(new_state.tv[:3]))
print("stc[0]:", np.asarray(new_state.stc[0]))
print("swc[0]:", np.asarray(new_state.swc[0]))
print("fsa:", np.asarray(flux.fsa[:3]), "fsh:", np.asarray(flux.fsh[:3]))
print("errsw:", np.asarray(flux.errsw[:3]))
print("erreng:", np.asarray(flux.erreng[:3]))
print("errwat:", np.asarray(flux.errwat[:3]))

# 10 steps to check stability
for i in range(10):
    new_state, flux = step(static, f, new_state)
print("after 10 more steps tg:", np.asarray(new_state.tg[:3]),
      "errwat:", np.asarray(flux.errwat[:3]))
