"""Tile energy balances: the coupled canopy/ground Newton iteration
(vege_flux) and the bare-ground Newton iteration (bare_flux)
(reference: core/module_noahmp_func.f90:2465-3257).

The reference's early-exit iterations (LITER logic, func:2870-2876)
become fixed-trip ``lax.fori_loop``s whose updates are frozen once the
column has converged, preserving serial semantics while keeping batches
in lockstep on the accelerator.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..constants import MPE, SB, CPAIR, KARMAN, TFRZ
from .. import tuning
from . import sfc

NITERC = 20   # canopy Newton iterations (func:2675)
NITERG = 5    # ground Newton iterations under canopy (func:2677)
NITERB = 5    # bare-ground Newton iterations (func:3115)


class VegeFluxOut(NamedTuple):
    tv: jnp.ndarray
    tgv: jnp.ndarray
    tah: jnp.ndarray
    eah: jnp.ndarray
    qsfc: jnp.ndarray
    cmv: jnp.ndarray
    chv: jnp.ndarray
    tauxv: jnp.ndarray
    tauyv: jnp.ndarray
    irc: jnp.ndarray
    irg: jnp.ndarray
    shc: jnp.ndarray
    shg: jnp.ndarray
    evc: jnp.ndarray
    evg: jnp.ndarray
    tr: jnp.ndarray
    ghv: jnp.ndarray
    t2mv: jnp.ndarray
    q2v: jnp.ndarray
    psnsun: jnp.ndarray
    psnsha: jnp.ndarray
    rssun: jnp.ndarray
    rssha: jnp.ndarray
    chleaf: jnp.ndarray
    chuc: jnp.ndarray
    ch2v: jnp.ndarray


class BareFluxOut(NamedTuple):
    tgb: jnp.ndarray
    qsfc: jnp.ndarray
    cmb: jnp.ndarray
    chb: jnp.ndarray
    tauxb: jnp.ndarray
    tauyb: jnp.ndarray
    irb: jnp.ndarray
    shb: jnp.ndarray
    evb: jnp.ndarray
    ghb: jnp.ndarray
    t2mb: jnp.ndarray
    q2b: jnp.ndarray
    ehb2: jnp.ndarray


def vege_flux(veg, gen, lutyp, opts, dt, sav, sag, lwdn, ur, uu, vv,
              sfctmp, thair, qair, eair, rhoair, snowh, vai, gammav,
              gammag, fwet, laisun, laisha, cwp, htop, zlvl, zpd, z0m,
              fveg, z0mg, emv, emg, canliq, canice, stc_top, df_top,
              dz_top, rsurf, latheav, latheag, parsun, parsha, igs,
              foln, co2air, o2air, btran, sfcprs, rhsur, psfc,
              eah0, tah0, tv0, tg0, cm0, ch0) -> VegeFluxOut:
    """Coupled canopy/ground energy balance over the vegetated tile.

    Solves -SAV + IRC[TV]+SHC[TV]+EVC[TV]+TR[TV] = 0 by Newton on TV
    (<=20 iters, masked exit when |dTV|<=0.01 after 5 iters), then
    -SAG + IRG[TG]+SHG[TG]+EVG[TG]+GH[TG] = 0 by 5 Newton steps on TG.
    """
    vaie = jnp.minimum(6.0, vai / fveg)
    laisune = jnp.minimum(6.0, laisun / fveg)
    laishae = jnp.minimum(6.0, laisha / fveg)

    estg, _ = sfc.esat_t(tg0)
    qsfc = 0.622 * eair / (psfc - 0.378 * eair)

    hcan = htop
    uc = ur * jnp.log(hcan / z0m) / jnp.log(zlvl / z0m)
    # reference aborts when HCAN <= ZPD (func:2726-2738); clamp instead
    hcan_zpd = jnp.maximum(hcan - zpd, MPE)

    air = (-emv * (1.0 + (1.0 - emv) * (1.0 - emg)) * lwdn
           - emv * emg * SB * tg0 ** 4)
    cir = (2.0 - emv * (1.0 - emg)) * emv * SB

    class C(NamedTuple):
        tv: jnp.ndarray
        tah: jnp.ndarray
        eah: jnp.ndarray
        cm: jnp.ndarray
        ch: jnp.ndarray
        qsfc: jnp.ndarray
        h: jnp.ndarray
        hg: jnp.ndarray
        irc: jnp.ndarray
        shc: jnp.ndarray
        evc: jnp.ndarray
        tr: jnp.ndarray
        rahc: jnp.ndarray
        rahg: jnp.ndarray
        rawg: jnp.ndarray
        cvh: jnp.ndarray
        fv: jnp.ndarray
        fh2: jnp.ndarray
        liter: jnp.ndarray
        done: jnp.ndarray
        s1: sfc.Sfcdif1Carry
        s2: sfc.Sfcdif2Carry
        mozg: jnp.ndarray
        fhg: jnp.ndarray

    z = jnp.zeros_like(tv0)
    onec = z + 1.0
    init = C(tv=tv0, tah=tah0, eah=eah0, cm=cm0, ch=ch0, qsfc=qsfc,
             h=z, hg=z, irc=z, shc=z, evc=z, tr=z, rahc=onec,
             rahg=onec, rawg=onec, cvh=z, fv=z + 0.1, fh2=z,
             liter=z > 1.0,
             done=z > 1.0,
             s1=sfc.sfcdif1_init(z), s2=sfc.Sfcdif2Carry(cm0, ch0, z, z,
                                                         z + 0.1),
             mozg=z, fhg=z)

    def iteration(c: C, first, it_ge5, rssun, rssha):
        z0h = z0m
        z0hg = z0mg
        if opts.sfc == 1:
            cm, ch, _ch2, s1 = sfc.sfcdif1(first, c.s1, sfctmp, rhoair,
                                           c.h, qair, zlvl, zpd, z0m,
                                           z0h, ur)
            fv = s1.fv
            fh2 = s1.fh2
            s2 = c.s2
        else:
            scale = ur if tuning.chen97_fixed_carry() else 1.0
            s2 = sfc.sfcdif2(first, c.s2._replace(akms=c.cm * scale,
                                                  akhs=c.ch * scale),
                             z0m, c.tah, thair, ur, gen.czil, zlvl)
            cm = s2.akms / ur
            ch = s2.akhs / ur
            fv = s2.ustar
            fh2 = z  # undefined in the reference for opt_sfc=2
            s1 = c.s1

        ramc = jnp.maximum(1.0, 1.0 / (cm * ur))
        rahc = jnp.maximum(1.0, 1.0 / (ch * ur))
        rawc = rahc

        rahg, rawg, rb, (mozg, fhg) = sfc.ragrb(
            veg, lutyp, first, (c.mozg, c.fhg), vaie, rhoair, c.hg,
            c.tah, zpd, z0mg, z0hg, hcan, uc, z0h, fv, cwp)

        estv, destv = sfc.esat_t(c.tv)

        if rssun is None:
            # first iteration: stomatal resistance (func:2798-2814)
            if opts.crs == 1:
                rssun, psnsun = sfc.stomata(veg, lutyp, igs, sfcprs,
                                            sfctmp, parsun, c.tv, c.eah,
                                            estv, o2air, co2air, foln,
                                            btran, rb)
                rssha, psnsha = sfc.stomata(veg, lutyp, igs, sfcprs,
                                            sfctmp, parsha, c.tv, c.eah,
                                            estv, o2air, co2air, foln,
                                            btran, rb)
            else:
                rssun, psnsun = sfc.canres(veg, lutyp, sfcprs, c.tv,
                                           parsun, c.eah, btran)
                rssha, psnsha = sfc.canres(veg, lutyp, sfcprs, c.tv,
                                           parsha, c.eah, btran)
            stomata_out = (rssun, rssha, psnsun, psnsha)
        else:
            stomata_out = None

        # sensible heat conductances (func:2817-2823)
        cah = 1.0 / rahc
        cvh = 2.0 * vaie / rb
        cgh = 1.0 / rahg
        cond = cah + cvh + cgh
        ata = (sfctmp * cah + tg0 * cgh) / cond
        bta = cvh / cond
        csh = (1.0 - bta) * rhoair * CPAIR * cvh

        # latent heat conductances (func:2826-2834)
        caw = 1.0 / rawc
        cew = fwet * vaie / rb
        ctw = (1.0 - fwet) * (laisune / (rb + rssun)
                              + laishae / (rb + rssha))
        cgw = 1.0 / (rawg + rsurf)
        cond = caw + cew + ctw + cgw
        aea = (eair * caw + estg * cgw) / cond
        bea = (cew + ctw) / cond
        cev = (1.0 - bea) * cew * rhoair * CPAIR / gammav
        ctr = (1.0 - bea) * ctw * rhoair * CPAIR / gammav

        tah = ata + bta * c.tv
        eah = aea + bea * estv

        irc = fveg * (air + cir * c.tv ** 4)
        shc = fveg * rhoair * CPAIR * cvh * (c.tv - tah)
        evc = fveg * rhoair * CPAIR * cew * (estv - eah) / gammav
        tr = fveg * rhoair * CPAIR * ctw * (estv - eah) / gammav
        evc_cap = jnp.where(c.tv > TFRZ, canliq, canice) * latheav / dt
        evc = jnp.minimum(evc_cap, evc)

        b = sav - irc - shc - evc - tr
        a = fveg * (4.0 * cir * c.tv ** 3 + csh + (cev + ctr) * destv)
        dtv = b / a

        irc = irc + fveg * 4.0 * cir * c.tv ** 3 * dtv
        shc = shc + fveg * csh * dtv
        evc = evc + fveg * cev * destv * dtv
        tr = tr + fveg * ctr * destv * dtv
        tv = c.tv + dtv

        h = rhoair * CPAIR * (tah - sfctmp) / rahc
        hg = rhoair * CPAIR * (tg0 - tah) / rahg
        qsfc_new = (0.622 * eah) / (sfcprs - 0.378 * eah)

        done = c.done | c.liter
        liter = c.liter | (it_ge5 & (jnp.abs(dtv) <= 0.01) & ~c.liter)

        new = C(tv=tv, tah=tah, eah=eah, cm=cm, ch=ch, qsfc=qsfc_new,
                h=h, hg=hg, irc=irc, shc=shc, evc=evc, tr=tr, rahc=rahc,
                rahg=rahg, rawg=rawg, cvh=cvh, fv=fv, fh2=fh2,
                liter=liter, done=done,
                s1=s1, s2=s2, mozg=mozg, fhg=fhg)
        # freeze everything once the column exited the loop
        merged = jax.tree.map(
            lambda old, upd: jnp.where(c.done, old, upd), c, new)
        return merged, stomata_out

    # iteration 1 unrolled (computes stomatal resistance once)
    c, (rssun, rssha, psnsun, psnsha) = iteration(
        init, jnp.ones((), bool), jnp.zeros((), bool), None, None)

    def body(i, c):
        it_ge5 = (i + 2) >= 5  # Fortran iter index is i+2
        c2, _ = iteration(c, jnp.zeros((), bool), it_ge5, rssun, rssha)
        return c2

    c = lax.fori_loop(0, NITERC - 1, body, c,
                      unroll=tuning.hot_loop_unroll())

    # under-canopy ground energy balance (func:2879-2914)
    air_g = -emg * (1.0 - emv) * lwdn - emg * emv * SB * c.tv ** 4
    cir_g = emg * SB
    csh_g = rhoair * CPAIR / c.rahg
    cev_g = rhoair * CPAIR / (gammag * (c.rawg + rsurf))
    cgh_g = 2.0 * df_top / dz_top

    def gbody(_, st):
        tg, _irg, _shg, _evg, _gh, _estg = st
        estg, destg = sfc.esat_t(tg)
        irg = cir_g * tg ** 4 + air_g
        shg = csh_g * (tg - c.tah)
        evg = cev_g * (estg * rhsur - c.eah)
        gh = cgh_g * (tg - stc_top)
        b = sag - irg - shg - evg - gh
        a = 4.0 * cir_g * tg ** 3 + csh_g + cev_g * destg + cgh_g
        dtg = b / a
        irg = irg + 4.0 * cir_g * tg ** 3 * dtg
        shg = shg + csh_g * dtg
        evg = evg + cev_g * destg * dtg
        gh = gh + cgh_g * dtg
        return tg + dtg, irg, shg, evg, gh, estg

    tg, irg, shg, evg, gh, estg = lax.fori_loop(
        0, NITERG, gbody, (tg0, z, z, z, z, estg),
        unroll=tuning.hot_loop_unroll())
    # snow-surface temperature cap (func:2920-2928)
    if opts.stc == 1:
        cap = (snowh > 0.05) & (tg > TFRZ)
        tg_c = jnp.where(cap, TFRZ, tg)
        irg = jnp.where(cap,
                        cir_g * tg_c ** 4 - emg * (1.0 - emv) * lwdn
                        - emg * emv * SB * c.tv ** 4, irg)
        shg = jnp.where(cap, csh_g * (tg_c - c.tah), shg)
        evg = jnp.where(cap, cev_g * (estg * rhsur - c.eah), evg)
        gh = jnp.where(cap, sag - (irg + shg + evg), gh)
        tg = tg_c

    tauxv = -rhoair * c.cm * ur * uu
    tauyv = -rhoair * c.cm * ur * vv

    # 2-m diagnostics (func:2942-2957)
    z0h = z0m
    cah2 = c.fv * KARMAN / (jnp.log((2.0 + z0h) / z0h) - c.fh2)
    small = cah2 < 1.0e-5
    t2mv = jnp.where(small, c.tah,
                     c.tah - (shg + c.shc / fveg)
                     / (rhoair * CPAIR) / jnp.maximum(cah2, MPE))
    q2v = jnp.where(small, c.qsfc,
                    c.qsfc - ((c.evc + c.tr) / fveg + evg)
                    / (latheav * rhoair) / jnp.maximum(cah2, MPE))

    return VegeFluxOut(
        tv=c.tv, tgv=tg, tah=c.tah, eah=c.eah, qsfc=c.qsfc, cmv=c.cm,
        chv=1.0 / c.rahc, tauxv=tauxv, tauyv=tauyv, irc=c.irc, irg=irg,
        shc=c.shc, shg=shg, evc=c.evc, evg=evg, tr=c.tr, ghv=gh,
        t2mv=t2mv, q2v=q2v, psnsun=psnsun, psnsha=psnsha, rssun=rssun,
        rssha=rssha, chleaf=c.cvh, chuc=1.0 / c.rahg, ch2v=cah2)


def bare_flux(veg, gen, lutyp, opts, dt, sag, lwdn, ur, uu, vv, sfctmp,
              thair, qair, eair, rhoair, snowh, stc_top, df_top, dz_top,
              zlvl, zpd, z0m, emg, rsurf, lathea, gamma, rhsur, psfc,
              sfcprs, tgb0, cm0, ch0, qsfc0) -> BareFluxOut:
    """Bare-ground Newton iteration on TGB (reference func:2967-3257)."""
    dtype = jnp.result_type(tgb0)
    z = jnp.zeros((), dtype)

    cir = emg * SB
    cgh = 2.0 * df_top / dz_top

    class B(NamedTuple):
        tgb: jnp.ndarray
        cm: jnp.ndarray
        ch: jnp.ndarray
        qsfc: jnp.ndarray
        h: jnp.ndarray
        irb: jnp.ndarray
        shb: jnp.ndarray
        evb: jnp.ndarray
        ghb: jnp.ndarray
        estg: jnp.ndarray
        fv: jnp.ndarray
        fh2: jnp.ndarray
        rahb: jnp.ndarray
        csh: jnp.ndarray
        cev: jnp.ndarray
        s1: sfc.Sfcdif1Carry
        s2: sfc.Sfcdif2Carry

    init = B(tgb=tgb0, cm=cm0, ch=ch0, qsfc=qsfc0, h=z, irb=z, shb=z,
             evb=z, ghb=z, estg=z, fv=z + 0.1, fh2=z, rahb=jnp.ones((), dtype),
             csh=z, cev=z, s1=sfc.sfcdif1_init(z),
             s2=sfc.Sfcdif2Carry(cm0, ch0, z, z, z + 0.1))

    def body(i, c: B):
        first = i == 0
        z0h = z0m
        if opts.sfc == 1:
            cm, ch, _ch2, s1 = sfc.sfcdif1(first, c.s1, sfctmp, rhoair,
                                           c.h, qair, zlvl, zpd, z0m,
                                           z0h, ur)
            fv = s1.fv
            fh2 = s1.fh2
            s2 = c.s2
        else:
            scale = ur if tuning.chen97_fixed_carry() else 1.0
            s2 = sfc.sfcdif2(first, c.s2._replace(akms=c.cm * scale,
                                                  akhs=c.ch * scale),
                             z0m, c.tgb, thair, ur, gen.czil, zlvl)
            cm = s2.akms / ur
            ch = s2.akhs / ur
            snow = snowh > 0.0
            cm = jnp.where(snow, jnp.minimum(0.01, cm), cm)
            ch = jnp.where(snow, jnp.minimum(0.01, ch), ch)
            fv = s2.ustar
            fh2 = z
            s1 = c.s1

        rahb = jnp.maximum(1.0, 1.0 / (ch * ur))
        rawb = rahb

        estg, destg = sfc.esat_t(c.tgb)
        csh = rhoair * CPAIR / rahb
        cev = rhoair * CPAIR / gamma / (rsurf + rawb)

        irb = cir * c.tgb ** 4 - emg * lwdn
        shb = csh * (c.tgb - sfctmp)
        evb = cev * (estg * rhsur - eair)
        ghb = cgh * (c.tgb - stc_top)
        b = sag - irb - shb - evb - ghb
        a = 4.0 * cir * c.tgb ** 3 + csh + cev * destg + cgh
        dtg = b / a
        irb = irb + 4.0 * cir * c.tgb ** 3 * dtg
        shb = shb + csh * dtg
        evb = evb + cev * destg * dtg
        ghb = ghb + cgh * dtg
        tgb = c.tgb + dtg

        h = csh * (tgb - sfctmp)
        estg2, _ = sfc.esat_t(tgb)
        qsfc = 0.622 * (estg2 * rhsur) / (psfc - 0.378 * (estg2 * rhsur))

        return B(tgb=tgb, cm=cm, ch=ch, qsfc=qsfc, h=h, irb=irb,
                 shb=shb, evb=evb, ghb=ghb, estg=estg2, fv=fv, fh2=fh2,
                 rahb=rahb, csh=csh, cev=cev, s1=s1, s2=s2)

    c = lax.fori_loop(0, NITERB, body, init,
                      unroll=tuning.hot_loop_unroll())

    # snow cap (func:3225-3233)
    if opts.stc == 1:
        cap = (snowh > 0.05) & (c.tgb > TFRZ)
        tgb = jnp.where(cap, TFRZ, c.tgb)
        irb = jnp.where(cap, cir * tgb ** 4 - emg * lwdn, c.irb)
        shb = jnp.where(cap, c.csh * (tgb - sfctmp), c.shb)
        evb = jnp.where(cap, c.cev * (c.estg * rhsur - eair), c.evb)
        ghb = jnp.where(cap, sag - (irb + shb + evb), c.ghb)
    else:
        tgb, irb, shb, evb, ghb = c.tgb, c.irb, c.shb, c.evb, c.ghb

    tauxb = -rhoair * c.cm * ur * uu
    tauyb = -rhoair * c.cm * ur * vv

    z0h = z0m
    ehb2 = c.fv * KARMAN / (jnp.log((2.0 + z0h) / z0h) - c.fh2)
    small = ehb2 < 1.0e-5
    t2mb = jnp.where(small, tgb,
                     tgb - shb / (rhoair * CPAIR)
                     / jnp.maximum(ehb2, MPE))
    q2b = jnp.where(small, c.qsfc,
                    c.qsfc - evb / (lathea * rhoair)
                    * (1.0 / jnp.maximum(ehb2, MPE) + rsurf))
    q2b = jnp.where(lutyp == veg.isurban, c.qsfc, q2b)

    return BareFluxOut(tgb=tgb, qsfc=c.qsfc, cmb=c.cm,
                       chb=1.0 / c.rahb, tauxb=tauxb, tauyb=tauyb,
                       irb=irb, shb=shb, evb=evb, ghb=ghb, t2mb=t2mb,
                       q2b=q2b, ehb2=ehb2)
