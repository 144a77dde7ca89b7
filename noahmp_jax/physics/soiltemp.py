"""Snow/soil temperature diffusion and phase change
(reference: core/module_noahmp_func.f90:3987-4598).

The heat equation is assembled over all NLEVELS=7 slots with inactive
snow slots as identity rows, then solved with the batched Thomas kernel.
Phase change (melt/freeze of snow layers, bulk thin snow, and soil water
with supercooled liquid) is fully masked elementwise.
"""

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from ..constants import (MSNOW, NSOIL, NLEVELS, MPE, TFRZ, HFUS, GRAV)
from .. import tuning
from ..numerics.tridiag import thomas, masked_identity_rows

def _idx():
    return jnp.arange(NLEVELS)


def tsnosoi(dt, nsnow, tbot, zbot, zsnso, ssoil, df, hcpct, snowh, stc,
            opt_tbot: int, opt_stc: int):
    """Advance snow/soil temperatures one implicit step
    (reference func:3987-4237).  Returns new stc (NLEVELS,)."""
    top = MSNOW - nsnow
    active = _idx() >= top
    is_top = _idx() == top
    is_bot = _idx() == NLEVELS - 1

    zbotsno = zbot - snowh  # lower BC depth measured from snow surface

    zs = zsnso
    zs_prev = jnp.concatenate([jnp.zeros((1,), zs.dtype), zs[:-1]])
    zs_next = jnp.concatenate([zs[1:], jnp.zeros((1,), zs.dtype)])
    stc_next = jnp.concatenate([stc[1:], jnp.zeros((1,), stc.dtype)])

    denom = (zs_prev - zs) * hcpct
    denom_safe = jnp.where(active, denom, -1.0)
    temp1 = jnp.where(is_bot, zs_prev - zs, zs_prev - zs_next)
    temp1 = jnp.where(active, temp1, -1.0)
    ddz = 2.0 / temp1
    dtsdz = 2.0 * (stc - stc_next) / temp1
    if opt_tbot == 1:
        botflx = jnp.zeros((), stc.dtype)
    else:
        # positive static indices: x[N-1] is a static slice
        nl = stc.shape[0]
        dtsdz_bot = (stc[nl - 1] - tbot) \
            / (0.5 * (zs[nl - 2] + zs[nl - 1]) - zbotsno)
        nlev = dtsdz.shape[0]
        dtsdz = jnp.where(jnp.arange(nlev) == nlev - 1, dtsdz_bot,
                          dtsdz)
        botflx = -df[nl - 1] * dtsdz_bot

    df_prev = jnp.concatenate([jnp.zeros((1,), df.dtype), df[:-1]])
    dtsdz_prev = jnp.concatenate([jnp.zeros((1,), stc.dtype),
                                  dtsdz[:-1]])
    ddz_prev = jnp.concatenate([jnp.zeros((1,), stc.dtype), ddz[:-1]])

    prev_flux = jnp.where(is_top, ssoil, df_prev * dtsdz_prev)
    eflux = jnp.where(is_bot, -botflx - prev_flux,
                      df * dtsdz - prev_flux)

    ai = jnp.where(is_top, 0.0, -df_prev * ddz_prev / denom_safe)
    ci = jnp.where(is_bot, 0.0, -df * ddz / denom_safe)
    bi = -(ai + ci)
    if opt_stc == 2:
        extra = df / (0.5 * zs * zs * hcpct)
        bi = jnp.where(is_top, bi + extra, bi)
    rhsts = eflux / (-denom_safe)

    # hstep: dt scaling + Thomas solve (func:4190-4237)
    a = ai * dt
    b = 1.0 + bi * dt
    c = ci * dt
    d = rhsts * dt
    a, b, c, d = masked_identity_rows(active, a, b, c, d)
    delta = thomas(a, b, c, d)
    return stc + jnp.where(active, delta, 0.0)


def frh2o(soil, sltyp, tkelv, smc, swc):
    """Supercooled liquid soil water, Koren99 eq.17 Newton iteration in
    log space with Flerchinger fallback (reference func:4494-4598)."""
    ck, blim, err = 8.0, 5.5, 0.005
    bx = jnp.minimum(soil.bexp[sltyp], blim)
    psisat = soil.psisat[sltyp]
    smcmax = soil.smcmax[sltyp]

    swl0 = jnp.clip(smc - swc, 0.0, smc - 0.02)

    # guard the log arguments for the warm branch (result unused there)
    tk_safe = jnp.minimum(tkelv, TFRZ - 1.0e-3)
    smc_safe = jnp.maximum(smc, 0.021)
    swl0s = jnp.clip(swl0, 0.0, smc_safe - 0.02)

    def body_safe(i, st):
        swl, kcount = st
        df = (jnp.log((psisat * GRAV / HFUS) * (1.0 + ck * swl) ** 2
                      * (smcmax / (smc_safe - swl)) ** bx)
              - jnp.log(-(tk_safe - TFRZ) / tk_safe))
        denom = 2.0 * ck / (1.0 + ck * swl) + bx / (smc_safe - swl)
        swlk = jnp.clip(swl - df / denom, 0.0, smc_safe - 0.02)
        dswl = jnp.abs(swlk - swl)
        swl_new = jnp.where(kcount, swl, swlk)
        return swl_new, kcount | (dswl <= err)

    swl, kcount = lax.fori_loop(
        0, 10, body_safe,
        (swl0s, jnp.zeros_like(swl0s, bool)),
        unroll=tuning.hot_loop_unroll())
    free_iter = smc - swl

    # Flerchinger explicit fallback when the iteration failed (func:4588-4595)
    fk = ((HFUS / (GRAV * (-psisat))
           * ((tk_safe - TFRZ) / tk_safe)) ** (-1.0 / bx)) * smcmax
    fk = jnp.maximum(fk, 0.02)
    free_flerch = jnp.minimum(fk, smc)
    free = jnp.where(kcount != 0, free_iter, free_flerch)
    return jnp.where(tkelv > TFRZ - 1.0e-3, smc, free)


class PhaseChangeOut(NamedTuple):
    stc: jnp.ndarray
    snice: jnp.ndarray
    snliq: jnp.ndarray
    sneqv: jnp.ndarray
    snowh: jnp.ndarray
    smc: jnp.ndarray
    swc: jnp.ndarray
    qmelt: jnp.ndarray
    imelt: jnp.ndarray    # (NLEVELS,) int: 1 melt, 2 freeze
    ponding: jnp.ndarray


def phasechange(soil, sltyp, ist, dt, nsnow, fact, dzsnso, stc, snice,
                snliq, sneqv, snowh, smc, swc,
                opt_frz: int) -> PhaseChangeOut:
    """Melt/freeze of snow and soil water (reference func:4291-4491)."""
    top = MSNOW - nsnow
    snow_active = (_idx() < MSNOW) & (_idx() >= top)
    soil_slot = _idx() >= MSNOW

    dz = dzsnso
    dz_soil = dz[MSNOW:]

    mice_snow = jnp.concatenate([snice, jnp.zeros(NSOIL, snice.dtype)])
    mliq_snow = jnp.concatenate([snliq, jnp.zeros(NSOIL, snliq.dtype)])
    mliq_soil = jnp.concatenate([jnp.zeros(MSNOW, swc.dtype),
                                 swc * dz_soil * 1000.0])
    mice_soil = jnp.concatenate([jnp.zeros(MSNOW, swc.dtype),
                                 (smc - swc) * dz_soil * 1000.0])
    mice = jnp.where(soil_slot, mice_soil, mice_snow)
    mliq = jnp.where(soil_slot, mliq_soil, mliq_snow)
    # zero out inactive snow slots
    mice = jnp.where(soil_slot | snow_active, mice, 0.0)
    mliq = jnp.where(soil_slot | snow_active, mliq, 0.0)

    wice0 = mice
    wliq0 = mliq
    wmass0 = mice + mliq

    # supercooled liquid water for soil slots (func:4373-4387)
    stc_soil = stc[MSNOW:]
    if opt_frz == 1:
        smp = HFUS * (TFRZ - stc_soil) / (GRAV * stc_soil)
        sc = soil.smcmax[sltyp] * (jnp.maximum(smp, MPE)
                                   / soil.psisat[sltyp]) \
            ** (-1.0 / soil.bexp[sltyp])
        sc = jnp.where(stc_soil < TFRZ, sc, 0.0)
    else:
        sc = frh2o(soil, sltyp, stc_soil, smc, swc)
    supercool_soil = sc * dz_soil * 1000.0
    supercool = jnp.concatenate([jnp.zeros(MSNOW, sc.dtype),
                                 supercool_soil])
    supercool = jnp.where((ist == 1) & soil_slot, supercool, 0.0)

    active = snow_active | soil_slot
    imelt = jnp.where(active & (mice > 0.0) & (stc >= TFRZ), 1, 0)
    imelt = jnp.where(active & (mliq > supercool) & (stc < TFRZ),
                      2, imelt)
    # thin snow without a layer melts through the first soil slot
    bulk_snow = (nsnow == 0) & (sneqv > 0.0)
    first_soil = _idx() == MSNOW
    imelt = jnp.where(bulk_snow & first_soil & (stc >= TFRZ), 1, imelt)

    # energy surplus/deficit (func:4406-4421)
    hm = jnp.where(imelt > 0, (stc - TFRZ) / fact, 0.0)
    stc = jnp.where(imelt > 0, TFRZ, stc)
    bad_melt = (imelt == 1) & (hm < 0.0)
    bad_frz = (imelt == 2) & (hm > 0.0)
    hm = jnp.where(bad_melt | bad_frz, 0.0, hm)
    imelt = jnp.where(bad_melt | bad_frz, 0, imelt)
    xm = hm * dt / HFUS

    # bulk (no-layer) snowmelt acting on the first soil slot (func:4424-4440)
    qmelt = jnp.zeros((), stc.dtype)
    ponding = jnp.zeros((), stc.dtype)
    xm1 = xm[MSNOW]
    hm1 = hm[MSNOW]
    do_bulk = bulk_snow & (xm1 > 0.0)
    temp1 = sneqv
    sneqv_new = jnp.maximum(0.0, temp1 - xm1)
    propor = sneqv_new / jnp.maximum(temp1, MPE)
    snowh_new = jnp.maximum(0.0, propor * snowh)
    heatr = hm1 - HFUS * (temp1 - sneqv_new) / dt
    xm1_new = jnp.where(heatr > 0.0, heatr * dt / HFUS, 0.0)
    hm1_new = jnp.where(heatr > 0.0, heatr, 0.0)
    qmelt_b = jnp.maximum(0.0, temp1 - sneqv_new) / dt
    ponding_b = temp1 - sneqv_new

    sneqv = jnp.where(do_bulk, sneqv_new, sneqv)
    snowh = jnp.where(do_bulk, snowh_new, snowh)
    lay1 = jnp.arange(xm.shape[0]) == MSNOW
    xm = jnp.where(lay1, jnp.where(do_bulk, xm1_new, xm1), xm)
    hm = jnp.where(lay1, jnp.where(do_bulk, hm1_new, hm1), hm)
    qmelt = jnp.where(do_bulk, qmelt_b, qmelt)
    ponding = jnp.where(do_bulk, ponding_b, ponding)

    # melt/freeze mass exchange (func:4443-4479)
    go = (imelt > 0) & (jnp.abs(hm) > 0.0)
    mice_melt = jnp.maximum(0.0, wice0 - xm)              # xm > 0
    # xm < 0: snow slots
    mice_frz_snow = jnp.minimum(wmass0, wice0 - xm)
    # xm < 0: soil slots
    mice_frz_soil = jnp.where(
        wmass0 < supercool, 0.0,
        jnp.maximum(jnp.minimum(wmass0 - supercool, wice0 - xm), 0.0))
    mice_frz = jnp.where(soil_slot, mice_frz_soil, mice_frz_snow)
    mice_new = jnp.where(xm > 0.0, mice_melt,
                         jnp.where(xm < 0.0, mice_frz, mice))
    heatr_l = jnp.where(xm != 0.0,
                        hm - HFUS * (wice0 - mice_new) / dt, 0.0)
    mliq_new = jnp.maximum(0.0, wmass0 - mice_new)
    stc_adj = stc + fact * heatr_l
    stc_adj = jnp.where(~soil_slot & (mliq_new * mice_new > 0.0),
                        TFRZ, stc_adj)
    stc = jnp.where(go & (jnp.abs(heatr_l) > 0.0), stc_adj, stc)
    mice = jnp.where(go, mice_new, mice)
    mliq = jnp.where(go, mliq_new, mliq)
    qmelt = qmelt + jnp.sum(
        jnp.where(go & (_idx() < MSNOW),
                  jnp.maximum(0.0, wice0 - mice) / dt, 0.0))

    snice_out = mice[:MSNOW]
    snliq_out = mliq[:MSNOW]
    swc_out = mliq[MSNOW:] / (1000.0 * dz_soil)
    smc_out = (mliq[MSNOW:] + mice[MSNOW:]) / (1000.0 * dz_soil)

    return PhaseChangeOut(stc, snice_out, snliq_out, sneqv, snowh,
                          smc_out, swc_out, qmelt, imelt, ponding)
