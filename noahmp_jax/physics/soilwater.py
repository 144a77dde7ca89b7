"""Soil moisture: Richards-equation solve with adaptive sub-stepping,
four runoff schemes, equilibrium water table, Schaake infiltration, and
the SIMGM unconfined aquifer
(reference: core/module_noahmp_func.f90:5822-6639).

The 4-row tridiagonal moisture solve reuses the batched Thomas kernel.
The reference's data-dependent sub-step count (3 or 6) becomes a fixed
6-trip loop with iterations beyond the column's count masked out.
"""

from typing import NamedTuple

import jax.numpy as jnp

from ..constants import NSOIL, MPE
from ..numerics import dfloat
from ..numerics.tridiag import thomas
from ..numerics.select import vsel, cumsum_small


def wdfcnd1(soil, sltyp, smc, fcr):
    """Diffusivity/conductivity scaled by unfrozen fraction
    (reference func:6386-6417)."""
    factr = jnp.maximum(0.01, smc / soil.smcmax[sltyp])
    wdf = soil.dwsat[sltyp] * factr ** (soil.bexp[sltyp] + 2.0)
    wdf = wdf * (1.0 - fcr)
    wcnd = soil.dksat[sltyp] * factr ** (2.0 * soil.bexp[sltyp] + 3.0)
    wcnd = wcnd * (1.0 - fcr)
    return wdf, wcnd


def wdfcnd2(soil, sltyp, smc, sice):
    """Diffusivity with ice-weighted blend (reference func:6420-6455)."""
    smcmax = soil.smcmax[sltyp]
    expon = soil.bexp[sltyp] + 2.0
    factr = jnp.maximum(0.01, smc / smcmax)
    wdf = soil.dwsat[sltyp] * factr ** expon
    vkwgt = 1.0 / (1.0 + (500.0 * sice) ** 3.0)
    wdf_ice = vkwgt * wdf + (1.0 - vkwgt) * soil.dwsat[sltyp] \
        * (0.2 / smcmax) ** expon
    wdf = jnp.where(sice > 0.0, wdf_ice, wdf)
    wcnd = soil.dksat[sltyp] * factr ** (2.0 * soil.bexp[sltyp] + 3.0)
    return wdf, wcnd


def zwteq(soil, sltyp, zsoil, dzsoil, swc):
    """Equilibrium water-table depth on a 100-layer fine grid
    (reference func:6051-6100)."""
    nfine = 100
    smcmax = soil.smcmax[sltyp]
    wd1 = jnp.sum((smcmax - swc) * dzsoil)
    dzfine = 3.0 * (-zsoil[NSOIL - 1]) / nfine
    kk = jnp.arange(1, nfine + 1, dtype=swc.dtype)
    zfine = kk * dzfine
    zwt0 = -3.0 * zsoil[NSOIL - 1] - 0.001
    temp = 1.0 + (zwt0 - zfine) / soil.psisat[sltyp]
    incr = smcmax * (1.0 - jnp.maximum(temp, MPE)
                     ** (-1.0 / soil.bexp[sltyp])) * dzfine
    wd2 = cumsum_small(incr)
    hit = jnp.abs(wd2 - wd1) <= 0.01
    # first-True index: min of masked iota; nfine when no hit (masked
    # by any(hit) below)
    first = jnp.min(jnp.where(hit, jnp.arange(nfine), nfine))
    # zfine[first] == (first+1)*dzfine exactly (how zfine was built);
    # avoids a traced 100-vector gather
    zhit = (first + 1).astype(swc.dtype) * dzfine
    return jnp.where(jnp.any(hit), zhit, zwt0)


def infil(soil, sltyp, dt, zsoil, swc, sice, sicemax, qinsrf):
    """Schaake96 maximum infiltration (reference func:6103-6196).
    Returns (qinfil, runsrf) in m/s."""
    cvfrz = 3
    dt1 = dt / 86400.0
    smcmax = soil.smcmax[sltyp]
    smcwlt = soil.smcwlt[sltyp]
    smcav = smcmax - smcwlt
    dz = -jnp.diff(jnp.concatenate([jnp.zeros(1, zsoil.dtype), zsoil]))
    dice = jnp.sum(dz * sice)
    dmax = dz * smcav * (1.0 - (swc + sice - smcwlt) / smcav)
    dd = jnp.sum(dmax)
    val = 1.0 - jnp.exp(-soil.kdt[sltyp] * dt1)
    ddt = dd * val
    px = jnp.maximum(0.0, qinsrf * dt)
    infmax = (px * (ddt / jnp.maximum(px + ddt, MPE))) / dt

    # frozen-soil correction: truncated series for CVFRZ=3 (func:6167-6180)
    acrt = cvfrz * soil.frzx[sltyp] / jnp.maximum(dice, MPE)
    series = 1.0 + acrt + acrt ** 2 / 2.0
    fcr = jnp.where(dice > 1.0e-2,
                    1.0 - jnp.exp(-acrt) * series, 1.0)
    infmax = infmax * fcr

    _wdf, wcnd = wdfcnd2(soil, sltyp, swc[0], sicemax)
    infmax = jnp.clip(infmax, wcnd, None)
    infmax = jnp.minimum(infmax, px)
    runsrf = jnp.maximum(0.0, qinsrf - infmax)
    qinfil = qinsrf - runsrf
    rain = qinsrf > 0.0
    return jnp.where(rain, qinfil, 0.0), jnp.where(rain, runsrf, 0.0)


def srt(soil, gen, sltyp, slptyp, dt, zsoil, qinfil, etrani, qseva, swc,
        smc, zwt, fcr, sicemax, fcrmax, opt_run: int, opt_inf: int):
    """Assemble the Richards tridiagonal (reference func:6199-6305).
    Returns (a, b, c, rhs, qdrain, wcnd)."""
    if opt_inf == 1:
        wdf, wcnd = wdfcnd1(soil, sltyp, smc, fcr)
        smx = smc
    else:
        wdf, wcnd = wdfcnd2(soil, sltyp, swc, sicemax)
        smx = swc

    z_prev = jnp.concatenate([jnp.zeros(1, zsoil.dtype), zsoil[:-1]])
    z_next = jnp.concatenate([zsoil[1:], jnp.zeros(1, zsoil.dtype)])
    smx_next = jnp.concatenate([smx[1:], jnp.zeros(1, smx.dtype)])
    idx = jnp.arange(NSOIL)
    is_top = idx == 0
    is_bot = idx == NSOIL - 1

    denom = z_prev - zsoil
    temp1 = jnp.where(is_bot, z_prev - zsoil, z_prev - z_next)
    ddz = 2.0 / temp1
    dsmdz = 2.0 * (smx - smx_next) / temp1

    if opt_run in (1, 2):
        qdrain = jnp.zeros((), smx.dtype)
    elif opt_run == 3:
        qdrain = gen.slope[slptyp] * wcnd[NSOIL - 1]
    else:
        qdrain = (1.0 - fcrmax) * wcnd[NSOIL - 1]

    wdf_prev = jnp.concatenate([jnp.zeros(1, wdf.dtype), wdf[:-1]])
    wcnd_prev = jnp.concatenate([jnp.zeros(1, wcnd.dtype), wcnd[:-1]])
    dsmdz_prev = jnp.concatenate([jnp.zeros(1, dsmdz.dtype),
                                  dsmdz[:-1]])
    ddz_prev = jnp.concatenate([jnp.zeros(1, ddz.dtype), ddz[:-1]])

    up_flux = jnp.where(is_top, qinfil - qseva,
                        wdf_prev * dsmdz_prev + wcnd_prev)
    wflux = jnp.where(is_bot,
                      -up_flux + etrani + qdrain,
                      wdf * dsmdz + wcnd - up_flux + etrani)

    a = jnp.where(is_top, 0.0, -wdf_prev * ddz_prev / denom)
    c = jnp.where(is_bot, 0.0, -wdf * ddz / denom)
    # the reference writes the top-row diagonal directly (func:6292)
    b = jnp.where(is_top, wdf * ddz / denom, -(a + c))
    rhs = wflux / (-denom)
    return a, b, c, rhs, qdrain, wcnd


def sstep(soil, sltyp, dt, dzsoil, sice, swc, a, b, c, rhs):
    """dt-scale, Thomas solve, saturation-excess bucket push-up
    (reference func:6308-6383).  Returns (swc, smc, wplus [m])."""
    aa = a * dt
    bb = 1.0 + b * dt
    cc = c * dt
    dd = rhs * dt
    delta = thomas(aa, bb, cc, dd)
    swc = swc + delta

    epore = jnp.maximum(1.0e-4, soil.smcmax[sltyp] - sice)
    # push saturation excess upward, bottom -> top (func:6372-6381)
    swc_l = [swc[k] for k in range(NSOIL)]
    for k in range(NSOIL - 1, 0, -1):
        wplus_k = jnp.maximum(swc_l[k] - epore[k], 0.0) * dzsoil[k]
        swc_l[k] = jnp.minimum(epore[k], swc_l[k])
        swc_l[k - 1] = swc_l[k - 1] + wplus_k / dzsoil[k - 1]
    wplus = jnp.maximum(swc_l[0] - epore[0], 0.0) * dzsoil[0]
    swc_l[0] = jnp.minimum(epore[0], swc_l[0])
    swc = jnp.stack(swc_l)
    smc = swc + sice
    return swc, smc, wplus


class SoilH2OOut(NamedTuple):
    swc: jnp.ndarray
    smc: jnp.ndarray
    zwt: jnp.ndarray
    runsrf: jnp.ndarray   # [mm/s]
    runsub: jnp.ndarray   # [mm/s] (opt_run==2 topmodel baseflow)
    qdrain: jnp.ndarray   # [mm/s]
    wcnd: jnp.ndarray     # (NSOIL,) [m/s]
    fcrmax: jnp.ndarray


def soilh2o(soil, gen, veg, sltyp, slptyp, lutyp, dt, zsoil, dzsoil,
            qinsrf, qseva, etrani, sice, swc, smc, zwt,
            opt_run: int, opt_inf: int) -> SoilH2OOut:
    """Soil water driver (reference func:5822-6048).  qinsrf/qseva/etrani
    in m/s."""
    smcmax = soil.smcmax[sltyp]
    a_pow = 4.0

    # clamp super-saturated layers (func:5893-5897)
    epore = jnp.maximum(1.0e-4, smcmax - sice)
    rsat = jnp.sum(jnp.maximum(0.0, swc - epore) * dzsoil)
    swc = jnp.minimum(epore, swc)

    fice = jnp.minimum(1.0, sice / smcmax)
    fcr = jnp.maximum(0.0, jnp.exp(-a_pow * (1.0 - fice))
                      - jnp.exp(-a_pow)) / (1.0 - jnp.exp(-a_pow))
    sicemax = jnp.max(sice)
    fcrmax = jnp.max(fcr)

    runsub = jnp.zeros((), swc.dtype)
    if opt_run == 2:
        zwt = zwteq(soil, sltyp, zsoil, dzsoil, swc)
        runsub = (1.0 - fcrmax) * 4.0 * jnp.exp(-gen.timean) \
            * jnp.exp(-2.0 * zwt)

    # urban surfaces are nearly impermeable (func:5927)
    fcr0 = jnp.where(lutyp == veg.isurban, 0.95, fcr[0])

    rain = qinsrf > 0.0
    if opt_run == 1:
        fsat = gen.fsatmax * jnp.exp(-0.5 * 6.0 * (zwt - 2.0))
        runsrf = jnp.where(rain, qinsrf * ((1.0 - fcr0) * fsat + fcr0),
                           0.0)
        qinfil = jnp.where(rain, qinsrf - runsrf, 0.0)
    elif opt_run == 2:
        fsat = gen.fsatmax * jnp.exp(-0.5 * 2.0 * zwt)
        runsrf = jnp.where(rain, qinsrf * ((1.0 - fcr0) * fsat + fcr0),
                           0.0)
        qinfil = jnp.where(rain, qinsrf - runsrf, 0.0)
    elif opt_run == 3:
        qinfil, runsrf = infil(soil, sltyp, dt, zsoil, swc, sice,
                               sicemax, qinsrf)
    else:
        # BATS: top-2m wetness^4 (func:5953-5968)
        within = cumsum_small(dzsoil) <= 2.0 + MPE
        within = within | (jnp.arange(NSOIL) == 0)
        dztot = jnp.sum(jnp.where(within, dzsoil, 0.0))
        smctot = jnp.sum(jnp.where(within, smc * dzsoil, 0.0)) / dztot
        fsat = jnp.maximum(0.01, smctot / smcmax) ** 4.0
        runsrf = jnp.where(rain, qinsrf * ((1.0 - fcr0) * fsat + fcr0),
                           0.0)
        qinfil = jnp.where(rain, qinsrf - runsrf, 0.0)

    # sub-stepping (func:5970-5996): fixed 6 trips, masked beyond niter
    if opt_inf == 1:
        niter = jnp.where(qinfil * dt > dzsoil[0] * smcmax, 6, 3)
        max_iter = 6
    else:
        niter = jnp.ones((), jnp.int32)
        max_iter = 1
    dtfine = dt / niter.astype(swc.dtype)

    qdrain_save = jnp.zeros((), swc.dtype)
    wcnd_out = jnp.zeros_like(swc)
    for it in range(max_iter):
        live = it < niter
        aa, bb, cc, rhs, qdrain, wcnd = srt(
            soil, gen, sltyp, slptyp, dtfine, zsoil, qinfil, etrani,
            qseva, swc, smc, zwt, fcr, sicemax, fcrmax, opt_run,
            opt_inf)
        swc_n, smc_n, wplus = sstep(soil, sltyp, dtfine, dzsoil, sice,
                                    swc, aa, bb, cc, rhs)
        swc = jnp.where(live, swc_n, swc)
        smc = jnp.where(live, smc_n, smc)
        rsat = jnp.where(live, rsat + wplus, rsat)
        qdrain_save = jnp.where(live, qdrain_save + qdrain, qdrain_save)
        wcnd_out = jnp.where(live, wcnd, wcnd_out)

    qdrain = qdrain_save / niter.astype(swc.dtype)
    runsrf = runsrf * 1000.0 + rsat * 1000.0 / dt
    qdrain = qdrain * 1000.0

    if opt_run == 2:
        # remove baseflow proportionally to transmissivity (func:6004-6014)
        wtsub = jnp.sum(wcnd_out * dzsoil)
        mh2o = runsub * dt * (wcnd_out * dzsoil) \
            / jnp.maximum(wtsub, MPE)
        swc = swc - mh2o / (dzsoil * 1000.0)

    if opt_run != 1:
        # WATMIN bucket fix-up (func:6018-6046)
        watmin = 0.01
        mliq = [swc[k] * dzsoil[k] * 1000.0 for k in range(NSOIL)]
        for k in range(NSOIL - 1):
            xs = jnp.where(mliq[k] < 0.0, watmin - mliq[k], 0.0)
            mliq[k] = mliq[k] + xs
            mliq[k + 1] = mliq[k + 1] - xs
        xs = jnp.where(mliq[-1] < watmin, watmin - mliq[-1], 0.0)
        mliq[-1] = mliq[-1] + xs
        runsub = runsub - xs / dt
        swc = jnp.stack([mliq[k] / (dzsoil[k] * 1000.0)
                         for k in range(NSOIL)])

    return SoilH2OOut(swc, smc, zwt, runsrf, runsub, qdrain, wcnd_out,
                      fcrmax)


class GroundwaterOut(NamedTuple):
    swc: jnp.ndarray
    zwt: jnp.ndarray
    wa: jnp.ndarray
    wt: jnp.ndarray
    qin: jnp.ndarray
    qdis: jnp.ndarray


def groundwater(soil, gen, sltyp, dt, zsoil, sice, wcnd, fcrmax, swc,
                zwt, wa, wt) -> GroundwaterOut:
    """SIMGM unconfined aquifer, opt_run=1 (reference func:6458-6639)."""
    rous, cmic = 0.2, 0.20
    smcmax = soil.smcmax[sltyp]

    z_prev = jnp.concatenate([jnp.zeros(1, zsoil.dtype), zsoil[:-1]])
    dzmm = (z_prev - zsoil) * 1.0e3
    znode = -z_prev + 0.5 * (z_prev - zsoil)
    smc = swc + sice
    mliq = swc * dzmm
    epore = jnp.maximum(0.01, smcmax - sice)
    hk = 1.0e3 * wcnd

    # first unsaturated layer above the water table (func:6545-6551)
    deeper = zwt <= -zsoil  # (NSOIL,) True where table at/above bottom
    cand = deeper[1:]       # for iz = 2..NSOIL
    any_c = jnp.any(cand)
    # first-True index (min of masked iota, as in zwteq)
    first = jnp.min(jnp.where(cand, jnp.arange(cand.shape[0]),
                              cand.shape[0]))
    jwt = jnp.where(any_c, first, NSOIL - 1)  # 0-based IWT

    qdis = (1.0 - fcrmax) * 5.0 * jnp.exp(-gen.timean) \
        * jnp.exp(-6.0 * (zwt - 2.0))

    # The reference computes S_NODE in real*8 (its one double-precision
    # variable, func:6501) and rounds the resulting SMPFZ back to real*4
    # (func:6562).  The step runs in f32, so the pow runs in two-float f32
    # arithmetic (numerics/dfloat.py) — bit-identical to the f64-computed,
    # f32-rounded reference value on a full-range parameter sweep
    # (tests/test_numerics.py::test_snode_f32_precision), by default and
    # on every backend (no x64 gating).
    ratio = vsel(smc, jwt) / smcmax
    s_node = jnp.clip(jnp.minimum(ratio, 1.0), 0.01, None)
    at_clip = ratio <= jnp.float32(0.01)
    smpfz = dfloat.smpfz_f64_parity(s_node, soil.bexp[sltyp],
                                    soil.psisat[sltyp], at_clip)
    smpfz = jnp.maximum(-120000.0, cmic * smpfz)

    ka = vsel(hk, jwt)
    znode_jwt = vsel(znode, jwt)
    wh_zwt = -zwt * 1.0e3
    wh = smpfz - znode_jwt * 1.0e3
    qin = -ka * (wh_zwt - wh) / jnp.maximum((zwt - znode_jwt) * 1.0e3,
                                            MPE)
    qin = jnp.clip(qin, -10.0 / dt, 10.0 / dt)

    wt = wt + (qin - qdis) * dt

    deep = jwt == NSOIL - 1
    # water table below the soil column (func:6577-6584)
    wa_d = wa + (qin - qdis) * dt
    wt_d = wa_d
    zwt_d = (-zsoil[NSOIL - 1] + 25.0) - wa_d / 1000.0 / rous
    mliq_bot_d = mliq[NSOIL - 1] - qin * dt \
        + jnp.maximum(0.0, wa_d - 5000.0)
    wa_d = jnp.minimum(wa_d, 5000.0)

    # water table within the column (func:6587-6606)
    near = jwt == NSOIL - 2
    zwt_near = -zsoil[NSOIL - 1] - (wt - rous * 1000.0 * 25.0) \
        / epore[NSOIL - 1] / 1000.0
    idxs = jnp.arange(NSOIL)
    ws = jnp.sum(jnp.where(idxs >= jwt + 2, epore * dzmm, 0.0))
    zsoil_j1 = vsel(zsoil, jnp.minimum(jwt + 1, NSOIL - 1))
    epore_j1 = vsel(epore, jnp.minimum(jwt + 1, NSOIL - 1))
    zwt_far = -zsoil_j1 - (wt - rous * 1000.0 * 25.0 - ws) \
        / epore_j1 / 1000.0
    zwt_s = jnp.where(near, zwt_near, zwt_far)
    wtsub = jnp.sum(hk * dzmm)
    mliq_s = mliq - qdis * dt * hk * dzmm / jnp.maximum(wtsub, MPE)

    mliq_d = jnp.where(jnp.arange(NSOIL) == NSOIL - 1, mliq_bot_d, mliq)
    mliq = jnp.where(deep, mliq_d, mliq_s)
    wa = jnp.where(deep, wa_d, wa)
    wt = jnp.where(deep, wt_d, wt)
    zwt = jnp.where(deep, zwt_d, zwt_s)
    zwt = jnp.maximum(1.5, zwt)

    # WATMIN fix-up (func:6615-6634)
    watmin = 0.01
    ml = [mliq[k] for k in range(NSOIL)]
    for k in range(NSOIL - 1):
        xs = jnp.where(ml[k] < 0.0, watmin - ml[k], 0.0)
        ml[k] = ml[k] + xs
        ml[k + 1] = ml[k + 1] - xs
    xs = jnp.where(ml[-1] < watmin, watmin - ml[-1], 0.0)
    ml[-1] = ml[-1] + xs
    wa = wa - xs
    wt = wt - xs
    swc = jnp.stack([ml[k] / dzmm[k] for k in range(NSOIL)])

    return GroundwaterOut(swc, zwt, wa, wt, qin, qdis)
