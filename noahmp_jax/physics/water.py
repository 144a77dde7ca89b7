"""Hydrology driver: canopy water, snowpack driver, soil/lake water
balance (reference: core/module_noahmp_func.f90:4601-5174).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..numerics.select import cumsum_small
from ..constants import (MSNOW, NSOIL, NLEVELS, MPE, TFRZ, HVAP, HSUB,
                         CICE, CWAT, HFUS, DENICE, DENWAT)
from . import snow as snow_mod
from . import soilwater as sw_mod

WSLMAX = 5000.0   # maximum lake storage [mm] (func:4705)


class CanWaterOut(NamedTuple):
    canliq: jnp.ndarray
    canice: jnp.ndarray
    tv: jnp.ndarray
    cmc: jnp.ndarray
    ecan: jnp.ndarray
    etran: jnp.ndarray
    qrain: jnp.ndarray
    qsnow: jnp.ndarray
    snowhin: jnp.ndarray
    fwet: jnp.ndarray
    fpice: jnp.ndarray


def canwater(veg, lutyp, dt, sfctmp, uu, vv, fcev, fctr, qprecc,
             qprecl, elai, esai, ist, tg, fveg, frozen_canopy, canliq,
             canice, tv, opt_snf: int) -> CanWaterOut:
    """Canopy interception/unloading/phase change
    (reference func:4807-5046)."""
    # rain/snow partition (func:4893-4921)
    if opt_snf == 1:
        fpice = jnp.where(
            sfctmp > TFRZ + 2.5, 0.0,
            jnp.where(sfctmp <= TFRZ + 0.5, 1.0,
                      jnp.where(sfctmp <= TFRZ + 2.0,
                                1.0 - (-54.632 + 0.2 * sfctmp), 0.6)))
    elif opt_snf == 2:
        fpice = jnp.where(sfctmp >= TFRZ + 2.2, 0.0, 1.0)
    else:
        fpice = jnp.where(sfctmp >= TFRZ, 0.0, 1.0)

    bdfall = jnp.minimum(120.0, 67.92 + 51.25
                         * jnp.exp((sfctmp - TFRZ) / 2.59))
    prcp = qprecc + qprecl
    rain = prcp * (1.0 - fpice)
    snowf = prcp * fpice
    fp = jnp.where(prcp > 0.0,
                   prcp / jnp.maximum(10.0 * qprecc + qprecl, MPE), 0.0)

    vai = elai + esai
    has_canopy = vai > 0.0

    # liquid interception (func:4938-4953)
    maxliq = veg.canwmxp[lutyp] * vai
    qintr = fveg * rain * fp
    qintr = jnp.minimum(qintr, (maxliq - canliq) / dt
                        * (1.0 - jnp.exp(-rain * dt
                                         / jnp.maximum(maxliq, MPE))))
    qintr = jnp.maximum(qintr, 0.0)
    qintr = jnp.where(has_canopy, qintr, 0.0)
    qdripr = jnp.where(has_canopy, fveg * rain - qintr, 0.0)
    qthror = jnp.where(has_canopy, (1.0 - fveg) * rain, rain)

    # canopy ET partition by phase (func:4956-4968)
    etran = jnp.where(frozen_canopy, jnp.maximum(fctr / HSUB, 0.0),
                      jnp.maximum(fctr / HVAP, 0.0))
    qevac = jnp.where(frozen_canopy, 0.0, jnp.maximum(fcev / HVAP, 0.0))
    qdewc = jnp.where(frozen_canopy, 0.0,
                      jnp.abs(jnp.minimum(fcev / HVAP, 0.0)))
    qsubc = jnp.where(frozen_canopy, jnp.maximum(fcev / HSUB, 0.0), 0.0)
    qfroc = jnp.where(frozen_canopy,
                      jnp.abs(jnp.minimum(fcev / HSUB, 0.0)), 0.0)

    qevac = jnp.minimum(canliq / dt, qevac)
    canliq = jnp.maximum(0.0, canliq + (qintr + qdewc - qevac) * dt)
    canliq = jnp.where(canliq <= 1.0e-6, 0.0, canliq)

    # snow interception (func:4977-4992)
    maxsno = 6.6 * (0.27 + 46.0 / bdfall) * vai
    qints = fveg * snowf * fp
    qints = jnp.minimum(qints, (maxsno - canice) / dt
                        * (1.0 - jnp.exp(-snowf * dt
                                         / jnp.maximum(maxsno, MPE))))
    qints = jnp.maximum(qints, 0.0)
    qints = jnp.where(has_canopy, qints, 0.0)
    ft = jnp.maximum(0.0, (tv - 270.15) / 1.87e5)
    fv = jnp.sqrt(uu * uu + vv * vv) / 1.56e5
    qdrips = jnp.where(has_canopy,
                       jnp.maximum(0.0, canice) * (fv + ft), 0.0)
    qthros = jnp.where(has_canopy,
                       (1.0 - fveg) * snowf + (fveg * snowf - qints),
                       snowf)

    qsubc = jnp.minimum(canice / dt, qsubc)
    canice = jnp.maximum(0.0, canice + (qints - qdrips) * dt
                         + (qfroc - qsubc) * dt)
    canice = jnp.where(canice <= 1.0e-6, 0.0, canice)

    # wetted fraction (func:4998-5005)
    fwet = jnp.where(canice > 0.0,
                     jnp.maximum(0.0, canice) / jnp.maximum(maxsno,
                                                            1.0e-6),
                     jnp.maximum(0.0, canliq) / jnp.maximum(maxliq,
                                                            1.0e-6))
    fwet = jnp.minimum(fwet, 1.0) ** 0.667

    # canopy melt / refreeze (func:5009-5024)
    melt = (canice > 1.0e-6) & (tv > TFRZ)
    qmeltc = jnp.minimum(canice / dt, (tv - TFRZ) * CICE * canice
                         / DENICE / (dt * HFUS))
    canice_m = jnp.maximum(0.0, canice - qmeltc * dt)
    canliq_m = jnp.maximum(0.0, canliq + qmeltc * dt)
    tv_m = fwet * TFRZ + (1.0 - fwet) * tv
    canice = jnp.where(melt, canice_m, canice)
    canliq = jnp.where(melt, canliq_m, canliq)
    tv = jnp.where(melt, tv_m, tv)

    frz = (canliq > 1.0e-6) & (tv < TFRZ)
    qfrzc = jnp.minimum(canliq / dt, (TFRZ - tv) * CWAT * canliq
                        / DENWAT / (dt * HFUS))
    canliq_f = jnp.maximum(0.0, canliq - qfrzc * dt)
    canice_f = jnp.maximum(0.0, canice + qfrzc * dt)
    tv_f = fwet * TFRZ + (1.0 - fwet) * tv
    canliq = jnp.where(frz, canliq_f, canliq)
    canice = jnp.where(frz, canice_f, canice)
    tv = jnp.where(frz, tv_f, tv)

    cmc = canliq + canice
    ecan = qevac + qsubc - qdewc - qfroc
    qrain = qdripr + qthror
    qsnow = qdrips + qthros
    snowhin = qsnow / bdfall
    warm_lake = (ist == 2) & (tg > TFRZ)
    qsnow = jnp.where(warm_lake, 0.0, qsnow)
    snowhin = jnp.where(warm_lake, 0.0, snowhin)

    return CanWaterOut(canliq, canice, tv, cmc, ecan, etran, qrain,
                       qsnow, snowhin, fwet, fpice)


class SnowWaterOut(NamedTuple):
    nsnow: jnp.ndarray
    snowh: jnp.ndarray
    sneqv: jnp.ndarray
    snice: jnp.ndarray
    snliq: jnp.ndarray
    stc: jnp.ndarray      # full (NLEVELS,)
    zsnso: jnp.ndarray    # full (NLEVELS,)
    dzsnso: jnp.ndarray   # full (NLEVELS,)
    swc: jnp.ndarray
    sice: jnp.ndarray
    qsnbot: jnp.ndarray
    snoflow: jnp.ndarray
    ponding1: jnp.ndarray
    ponding2: jnp.ndarray


def _active_slots(nsnow, nslots):
    """Live-slot mask for a bottom-aligned layer array of ``nslots``:
    the MSNOW snow slots alone, or extended by the always-live soil
    slots (index >= MSNOW), as ONE comparison.  Correctness of the
    extended form relies on the invariant
    0 <= nsnow <= MSNOW (snow.py guards every nsnow decrement with
    nsnow > 0 and every increment against MSNOW); if nsnow could go
    negative, soil depths would be silently zeroed here."""
    return jnp.arange(nslots) >= (MSNOW - nsnow)


def snowwater_full(gen, dt, zsoil, dzsnow, imelt_snow, sfctmp, snowhin,
                   qsnow, qsnfro, qsnsub, qrain, ficeold, nsnow, snowh,
                   sneqv, snice, snliq, swc, sice,
                   stc) -> SnowWaterOut:
    """Snowpack driver (reference func:5049-5174).  ``dzsnow`` is the
    (MSNOW,) positive snow layer thickness from the previous dzsnso."""
    dz_soil = -jnp.diff(jnp.concatenate([jnp.zeros(1, zsoil.dtype),
                                         zsoil]))
    p = snow_mod.Pack(
        nsnow=nsnow, dz=dzsnow, ice=snice, liq=snliq, stc=stc[:MSNOW],
        sneqv=sneqv, snowh=snowh, swc0=swc[0], sice0=sice[0],
        dzsoil1=dz_soil[0], ponding1=jnp.zeros((), stc.dtype),
        ponding2=jnp.zeros((), stc.dtype))

    p = snow_mod.snowfall(p, dt, qsnow, snowhin, sfctmp)

    def gated(fn, p):
        p2 = fn(p)
        return jax.tree.map(lambda a, b: jnp.where(p.nsnow > 0, a, b),
                            p2, p)

    p = gated(lambda q: snow_mod.compact(q, dt, imelt_snow, ficeold), p)
    p = gated(snow_mod.combine, p)
    p = gated(snow_mod.divide, p)

    p, qsnbot = snow_mod.snowh2o(p, dt, qsnfro, qsnsub, qrain, gen.ssi)

    # zero empty layers (func:5127-5133)
    active = _active_slots(p.nsnow, MSNOW)
    ice = jnp.where(active, p.ice, 0.0)
    liq = jnp.where(active, p.liq, 0.0)
    stc3 = jnp.where(active, p.stc, 0.0)
    dz3 = jnp.where(active, p.dz, 0.0)

    # glacier overflow (func:5137-5143)
    over = p.sneqv > 2000.0
    bot = MSNOW - 1
    bdsnow = ice[bot] / jnp.maximum(dz3[bot], MPE)
    snoflow_mm = jnp.where(over, p.sneqv - 2000.0, 0.0)
    # where-mask updates: .at[].add lowers as a scatter, which vmapped
    # XLA serializes (numerics/select.py)
    is_bot = jnp.arange(MSNOW) == bot
    ice = ice - jnp.where(is_bot, snoflow_mm, 0.0)
    dz3 = dz3 - jnp.where(is_bot & over,
                          snoflow_mm / jnp.maximum(bdsnow, MPE), 0.0)
    snoflow = snoflow_mm / dt

    # layered pack mass (func:5147-5152)
    sneqv = jnp.where(p.nsnow > 0,
                      jnp.sum(jnp.where(active, ice + liq, 0.0)),
                      p.sneqv)

    # rebuild zsnso/dzsnso (func:5154-5172)
    dz_full = jnp.concatenate([dz3, dz_soil])
    zsnso = -cumsum_small(dz_full)
    # inactive snow slots must carry zero depth; soil slots are always
    # live (see _active_slots for the nsnow invariant this rests on)
    full_active = _active_slots(p.nsnow, MSNOW + NSOIL)
    zsnso = jnp.where(full_active, zsnso, 0.0)
    dzsnso = jnp.where(full_active, dz_full, 0.0)

    stc_out = jnp.concatenate([stc3, stc[MSNOW:]])
    lay0 = jnp.arange(NSOIL) == 0
    swc_out = jnp.where(lay0, p.swc0, swc)
    sice_out = jnp.where(lay0, p.sice0, sice)

    return SnowWaterOut(p.nsnow, p.snowh, sneqv, ice, liq, stc_out,
                        zsnso, dzsnso, swc_out, sice_out, qsnbot,
                        snoflow, p.ponding1, p.ponding2)


class WaterOut(NamedTuple):
    canliq: jnp.ndarray
    canice: jnp.ndarray
    tv: jnp.ndarray
    fwet: jnp.ndarray
    nsnow: jnp.ndarray
    snowh: jnp.ndarray
    sneqv: jnp.ndarray
    snice: jnp.ndarray
    snliq: jnp.ndarray
    stc: jnp.ndarray
    zsnso: jnp.ndarray
    dzsnso: jnp.ndarray
    swc: jnp.ndarray
    smc: jnp.ndarray
    zwt: jnp.ndarray
    wa: jnp.ndarray
    wt: jnp.ndarray
    wslake: jnp.ndarray
    cmc: jnp.ndarray
    ecan: jnp.ndarray
    etran: jnp.ndarray
    runsrf: jnp.ndarray
    runsub: jnp.ndarray
    qin: jnp.ndarray
    qdis: jnp.ndarray
    qsnow: jnp.ndarray
    ponding1: jnp.ndarray
    ponding2: jnp.ndarray
    qsnbot: jnp.ndarray
    fpice: jnp.ndarray


def water(params, opts, lutyp, sltyp, slptyp, ist, dt, zsoil, dzsnow,
          imelt_snow, uu, vv, fcev, fctr, qprecc, qprecl, elai, esai,
          sfctmp, qvap, qdew, btrani, ficeold, ponding, tg, fveg,
          latheav, latheag, frozen_canopy, frozen_ground,
          nsnow, canliq, canice, tv, snowh, sneqv, snice, snliq, stc,
          swc, smc, zwt, wa, wt, wslake) -> WaterOut:
    """Hydrology driver (reference func:4601-4804)."""
    veg_p, soil_p, gen_p = params.veg, params.soil, params.gen
    sice = jnp.maximum(0.0, smc - swc)

    cw = canwater(veg_p, lutyp, dt, sfctmp, uu, vv, fcev, fctr, qprecc,
                  qprecl, elai, esai, ist, tg, fveg, frozen_canopy,
                  canliq, canice, tv, opts.snf)

    # sublimation/frost vs soil evap/dew partition (func:4725-4735)
    has_snow = sneqv > 0.0
    qsnsub = jnp.where(has_snow, jnp.minimum(qvap, sneqv / dt), 0.0)
    qseva = qvap - qsnsub
    qsnfro = jnp.where(has_snow, qdew, 0.0)
    qsdew = qdew - qsnfro

    sw = snowwater_full(gen_p, dt, zsoil, dzsnow, imelt_snow, sfctmp,
                        cw.snowhin, cw.qsnow, qsnfro, qsnsub, cw.qrain,
                        ficeold, nsnow, snowh, sneqv, snice, snliq,
                        swc, sice, stc)
    swc, sice = sw.swc, sw.sice

    # frozen-ground dew/evap acts on soil ice (func:4744-4752)
    dz1 = sw.dzsnso[MSNOW]
    sice0 = jnp.where(frozen_ground,
                      sice[0] + (qsdew - qseva) * dt / (dz1 * 1000.0),
                      sice[0])
    qsdew_g = jnp.where(frozen_ground, 0.0, qsdew)
    qseva_g = jnp.where(frozen_ground, 0.0, qseva)
    neg = frozen_ground & (sice0 < 0.0)
    l0 = jnp.arange(NSOIL) == 0
    swc = jnp.where(l0 & neg, swc[0] + sice0, swc)
    sice = jnp.where(l0, jnp.where(neg, 0.0, sice0), sice)

    # surface water input (func:4754-4764)
    qinsrf = (ponding + sw.ponding1 + sw.ponding2) / dt * 0.001
    qinsrf = qinsrf + jnp.where(sw.nsnow == 0,
                                (sw.qsnbot + qsdew_g + cw.qrain),
                                (sw.qsnbot + qsdew_g)) * 0.001
    qseva_m = qseva_g * 0.001

    etrani = cw.etran * btrani * 0.001  # (NSOIL,) [m/s]

    dz_soil = sw.dzsnso[MSNOW:]

    # lake branch (func:4774-4777)
    runsrf_lake = jnp.where(wslake >= WSLMAX, qinsrf * 1000.0, 0.0)
    wslake_new = wslake + (qinsrf - qseva_m) * 1000.0 * dt \
        - runsrf_lake * dt

    sh = sw_mod.soilh2o(soil_p, gen_p, veg_p, sltyp, slptyp, lutyp, dt,
                        zsoil, dz_soil, qinsrf, qseva_m, etrani, sice,
                        swc, smc, zwt, opts.run, opts.inf)

    if opts.run == 1:
        gw = sw_mod.groundwater(soil_p, gen_p, sltyp, dt, zsoil, sice,
                                sh.wcnd, sh.fcrmax, sh.swc, sh.zwt, wa,
                                wt)
        swc_soil = gw.swc
        zwt_soil = gw.zwt
        wa_new, wt_new = gw.wa, gw.wt
        qin, qdis = gw.qin, gw.qdis
        runsub = qdis
    else:
        swc_soil = sh.swc
        zwt_soil = sh.zwt
        wa_new, wt_new = wa, wt
        qin = jnp.zeros_like(tg)
        qdis = jnp.zeros_like(tg)
        runsub = sh.runsub
        if opts.run in (3, 4):
            runsub = runsub + sh.qdrain

    smc_soil = swc_soil + sice

    is_lake = ist == 2
    swc = jnp.where(is_lake, swc, swc_soil)
    smc = jnp.where(is_lake, smc, smc_soil)
    zwt = jnp.where(is_lake, zwt, zwt_soil)
    runsrf = jnp.where(is_lake, runsrf_lake, sh.runsrf)
    runsub = jnp.where(is_lake, 0.0, runsub) + sw.snoflow
    wslake = jnp.where(is_lake, wslake_new, wslake)
    wa = jnp.where(is_lake, wa, wa_new)
    wt = jnp.where(is_lake, wt, wt_new)

    return WaterOut(
        canliq=cw.canliq, canice=cw.canice, tv=cw.tv, fwet=cw.fwet,
        nsnow=sw.nsnow, snowh=sw.snowh, sneqv=sw.sneqv, snice=sw.snice,
        snliq=sw.snliq, stc=sw.stc, zsnso=sw.zsnso, dzsnso=sw.dzsnso,
        swc=swc, smc=smc, zwt=zwt, wa=wa, wt=wt, wslake=wslake,
        cmc=cw.cmc, ecan=cw.ecan, etran=cw.etran, runsrf=runsrf,
        runsub=runsub, qin=qin, qdis=qdis, qsnow=cw.qsnow,
        ponding1=sw.ponding1, ponding2=sw.ponding2, qsnbot=sw.qsnbot,
        fpice=cw.fpice)
