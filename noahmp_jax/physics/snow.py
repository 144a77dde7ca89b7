"""Snowpack hydrology: snowfall, compaction, layer combine/divide, and
liquid percolation (reference: core/module_noahmp_func.f90:5049-5819).

This is the main structural divergence from the reference: the Fortran
does data-dependent layer-count changes with in-place shifting and early
exits.  Here the pack is a fixed-shape (MSNOW,) bottom-aligned structure
(slot MSNOW-1 touches the soil; with ``nsnow`` active layers, slots
MSNOW-nsnow .. MSNOW-1 are live) and every re-layering step is expressed
as masked gathers/scatters over the 3 slots, iterated with static Python
loops — provably the same serial semantics, fully batchable under vmap.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..constants import (MSNOW, MPE, TFRZ, TTRI, CICE, CWAT,
                         HFUS, DENICE, DENWAT)
from ..numerics.select import vsel, vperm, cumsum_small

def _i3():
    return jnp.arange(MSNOW)

# minimum thickness per layer position for the combine pass
# (reference func:5272)
DZMIN = (0.025, 0.025, 0.1)


class Pack(NamedTuple):
    """Snowpack + first-soil-layer coupling state."""
    nsnow: jnp.ndarray    # active layers (int 0..MSNOW)
    dz: jnp.ndarray       # (MSNOW,) layer thickness [m] (0 if inactive)
    ice: jnp.ndarray      # (MSNOW,) layer ice [mm]
    liq: jnp.ndarray      # (MSNOW,) layer liquid [mm]
    stc: jnp.ndarray      # (MSNOW,) layer temperature [K]
    sneqv: jnp.ndarray    # bulk SWE [mm]
    snowh: jnp.ndarray    # depth [m]
    swc0: jnp.ndarray     # first soil layer liquid [m3/m3]
    sice0: jnp.ndarray    # first soil layer ice [m3/m3]
    dzsoil1: jnp.ndarray  # first soil layer thickness [m] (constant)
    ponding1: jnp.ndarray
    ponding2: jnp.ndarray


def _top(nsnow):
    return MSNOW - nsnow


def _shift_down(x, p, top):
    """x[i] = x[i-1] for i in [top+1, p] (the reference's element shift
    after removing a layer, func:5308-5315)."""
    rolled = jnp.concatenate([x[:1], x[:-1]])
    mask = (_i3() >= top + 1) & (_i3() <= p)
    return jnp.where(mask, rolled, x)


def combo(dz1, liq1, ice1, t1, dz2, liq2, ice2, t2):
    """Enthalpy-conserving merge of layer 2 into layer 1
    (reference func:5536-5577)."""
    dzc = dz1 + dz2
    icec = ice1 + ice2
    liqc = liq1 + liq2
    h = (CICE * ice1 + CWAT * liq1) * (t1 - TFRZ) + HFUS * liq1
    h2 = (CICE * ice2 + CWAT * liq2) * (t2 - TFRZ) + HFUS * liq2
    hc = h + h2
    cden = jnp.maximum(CICE * icec + CWAT * liqc, MPE)
    tc = jnp.where(hc < 0.0, TFRZ + hc / cden,
                   jnp.where(hc <= HFUS * liqc, TFRZ,
                             TFRZ + (hc - HFUS * liqc) / cden))
    return dzc, liqc, icec, tc


def snowfall(p: Pack, dt, qsnow, snowhin, sfctmp) -> Pack:
    """Add snowfall; create the first layer at 2.5 cm depth
    (reference func:5177-5233)."""
    no_layer = (p.nsnow == 0) & (qsnow > 0.0)
    snowh = jnp.where(no_layer, p.snowh + snowhin * dt, p.snowh)
    sneqv = jnp.where(no_layer, p.sneqv + qsnow * dt, p.sneqv)

    create = no_layer & (snowh >= 0.025)
    bot = MSNOW - 1
    dz = jnp.where(create & (_i3() == bot), snowh, p.dz)
    stc = jnp.where(create & (_i3() == bot),
                    jnp.minimum(TTRI, sfctmp), p.stc)
    ice = jnp.where(create & (_i3() == bot), sneqv, p.ice)
    liq = jnp.where(create & (_i3() == bot), 0.0, p.liq)
    nsnow = jnp.where(create, 1, p.nsnow)
    snowh = jnp.where(create, 0.0, snowh)

    # layered pack: add to the top layer
    add = (p.nsnow > 0) & (qsnow > 0.0)
    top = _top(p.nsnow)
    is_top = _i3() == top
    ice = jnp.where(add & is_top, ice + qsnow * dt, ice)
    dz = jnp.where(add & is_top, dz + snowhin * dt, dz)

    return p._replace(nsnow=nsnow, dz=dz, ice=ice, liq=liq, stc=stc,
                      sneqv=sneqv, snowh=snowh)


def compact(p: Pack, dt, imelt3, ficeold) -> Pack:
    """Snow compaction: destructive metamorphism, overburden, melt
    (reference func:5580-5677)."""
    c2, c3, c4, c5 = 21.0e-3, 2.5e-6, 0.04, 2.0
    dm, eta0 = 100.0, 0.8e6

    top = _top(p.nsnow)
    active = _i3() >= top
    wx = p.ice + p.liq
    fice = p.ice / jnp.maximum(wx, MPE)
    dzs = jnp.maximum(p.dz, MPE)
    void = 1.0 - (p.ice / DENICE + p.liq / DENWAT) / dzs

    # burden: mass of overlying active layers (exclusive prefix sum)
    wx_act = jnp.where(active, wx, 0.0)
    burden = cumsum_small(wx_act) - wx_act

    bi = p.ice / dzs
    td = jnp.maximum(0.0, TFRZ - p.stc)
    dexpf = jnp.exp(-c4 * td)
    ddz1 = -c3 * dexpf
    ddz1 = jnp.where(bi > dm, ddz1 * jnp.exp(-46.0e-3 * (bi - dm)), ddz1)
    ddz1 = jnp.where(p.liq > 0.01 * dzs, ddz1 * c5, ddz1)
    ddz2 = -(burden + 0.5 * wx) * jnp.exp(-0.08 * td - c2 * bi) / eta0
    ddz3 = jnp.where(imelt3 == 1,
                     -jnp.maximum(0.0, (ficeold - fice)
                                  / jnp.maximum(1.0e-6, ficeold)) / dt,
                     0.0)
    pdzdtc = jnp.maximum(-0.5, (ddz1 + ddz2 + ddz3) * dt)
    compactable = active & (void > 0.001) & (p.ice > 0.1)
    dz = jnp.where(compactable, p.dz * (1.0 + pdzdtc), p.dz)
    return p._replace(dz=dz)


def combine(p: Pack) -> Pack:
    """Merge vanishing/thin layers (reference func:5236-5413)."""
    n0 = p.nsnow
    top0 = _top(n0)
    nsnow = n0
    dz, ice, liq, stc = p.dz, p.ice, p.liq, p.stc
    sneqv, snowh = p.sneqv, p.snowh
    swc0, sice0, pond1 = p.swc0, p.sice0, p.ponding1

    for pp in range(MSNOW):
        top_cur = _top(nsnow)
        was_active = pp >= top0
        cond = was_active & (ice[pp] <= 0.1) & (nsnow > 0)

        if pp != MSNOW - 1:
            # merge into the layer below (func:5278-5280)
            nxt = _i3() == pp + 1
            liq = liq + jnp.where(nxt & cond, liq[pp], 0.0)
            ice = ice + jnp.where(nxt & cond, ice[pp], 0.0)
        else:
            multi = n0 > 1  # reference tests ISNOW_OLD < -1 (func:5282)
            m_up = cond & multi
            prv = _i3() == pp - 1
            liq = liq + jnp.where(prv & m_up, liq[pp], 0.0)
            ice = ice + jnp.where(prv & m_up, ice[pp], 0.0)
            # single-layer collapse (func:5286-5302)
            m_col = cond & ~multi
            pos = ice[pp] >= 0.0
            pond1 = jnp.where(m_col & pos, liq[pp], pond1)
            sneqv = jnp.where(m_col, jnp.where(pos, ice[pp], 0.0), sneqv)
            snowh = jnp.where(m_col, jnp.where(pos, dz[pp], 0.0), snowh)
            p1_neg = liq[pp] + ice[pp]
            pond1 = jnp.where(m_col & ~pos,
                              jnp.maximum(p1_neg, 0.0), pond1)
            sice0 = jnp.where(m_col & ~pos & (p1_neg < 0.0),
                              jnp.maximum(0.0, sice0 + p1_neg
                                          / (p.dzsoil1 * 1000.0)), sice0)
            cur = _i3() == pp
            liq = jnp.where(cur & m_col, 0.0, liq)
            ice = jnp.where(cur & m_col, 0.0, ice)
            dz = jnp.where(cur & m_col, 0.0, dz)

        # shift layers above down one slot (func:5308-5315)
        do_shift = cond & (pp > top_cur) & (nsnow >= 2)
        pi = jnp.asarray(pp)

        def sh(x):
            return jnp.where(do_shift, _shift_down(x, pi, top_cur), x)

        stc = sh(stc)
        liq = sh(liq)
        ice = sh(ice)
        dz = sh(dz)
        nsnow = jnp.where(cond, nsnow - 1, nsnow)

    # conserve water after over-sublimation (func:5322-5325)
    neg = sice0 < 0.0
    swc0 = jnp.where(neg, swc0 + sice0, swc0)
    sice0 = jnp.where(neg, 0.0, sice0)

    multi = nsnow > 0
    active = _i3() >= _top(nsnow)
    zwice = jnp.sum(jnp.where(active, ice, 0.0))
    zwliq = jnp.sum(jnp.where(active, liq, 0.0))
    sneqv = jnp.where(multi, zwice + zwliq, sneqv)
    snowh = jnp.where(multi, jnp.sum(jnp.where(active, dz, 0.0)), snowh)

    # total collapse when too shallow (func:5344-5350)
    collapse = multi & (snowh < 0.025)
    pond2 = jnp.where(collapse, zwliq, p.ponding2)
    sneqv = jnp.where(collapse, zwice, sneqv)
    snowh = jnp.where(collapse & (zwice <= 0.0), 0.0, snowh)
    nsnow = jnp.where(collapse, 0, nsnow)

    # thin-layer combination pass (func:5361-5411)
    n1 = nsnow
    top1 = _top(n1)
    mssi = jnp.zeros((), jnp.int32)
    exited = jnp.zeros((), bool)
    def dzmin_at(m):
        # DZMIN[min(m, 2)] without an array constant
        return jnp.where(m >= 2, DZMIN[2],
                         jnp.where(m == 1, DZMIN[1], DZMIN[0]))
    for pp in range(MSNOW):
        top_cur = _top(nsnow)
        was_active = (pp >= top1) & (n1 >= 2)
        thin = was_active & ~exited & \
            (dz[pp] < dzmin_at(mssi))

        # neighbor choice (func:5369-5376)
        pi = jnp.asarray(pp)
        is_top_l = pi == top_cur
        is_bot_l = pp == MSNOW - 1
        below_sum = dz[min(pp + 1, MSNOW - 1)] + dz[pp]
        above_sum = dz[max(pp - 1, 0)] + dz[pp]
        prefer_above = (~is_top_l) & (not is_bot_l) \
            & (above_sum < below_sum)
        neib_above = prefer_above | is_bot_l
        jj = jnp.where(neib_above, pi, jnp.minimum(pi + 1, MSNOW - 1))
        ll = jnp.where(neib_above, jnp.maximum(pi - 1, 0), pi)

        # one-hot select/set: jj/ll are traced (numerics/select.py)
        dzj, liqj, icej, tj = (vsel(dz, jj), vsel(liq, jj),
                               vsel(ice, jj), vsel(stc, jj))
        dzl, liql, icel, tl = (vsel(dz, ll), vsel(liq, ll),
                               vsel(ice, ll), vsel(stc, ll))
        dzc, liqc, icec, tc = combo(dzj, liqj, icej, tj,
                                    dzl, liql, icel, tl)
        at_jj = thin & (_i3() == jj)
        dz = jnp.where(at_jj, dzc, dz)
        liq = jnp.where(at_jj, liqc, liq)
        ice = jnp.where(at_jj, icec, ice)
        stc = jnp.where(at_jj, tc, stc)

        # shift above the removed slot (func:5391-5398)
        do_shift = thin & (jj - 1 > top_cur)

        def sh2(x):
            return jnp.where(do_shift, _shift_down(x, jj - 1, top_cur), x)

        stc = sh2(stc)
        ice = sh2(ice)
        liq = sh2(liq)
        dz = sh2(dz)
        nsnow = jnp.where(thin, nsnow - 1, nsnow)
        exited = exited | (thin & (nsnow <= 1))
        mssi = jnp.where(was_active & ~thin, mssi + 1, mssi)

    return p._replace(nsnow=nsnow, dz=dz, ice=ice, liq=liq, stc=stc,
                      sneqv=sneqv, snowh=snowh, swc0=swc0, sice0=sice0,
                      ponding1=pond1, ponding2=pond2)


def divide(p: Pack) -> Pack:
    """Split too-thick layers back up to MSNOW layers
    (reference func:5416-5533).  Works on a top-aligned copy."""
    n = p.nsnow
    top = _top(n)
    idx = jnp.clip(top + _i3(), 0, MSNOW - 1)
    dz = vperm(p.dz, idx)    # dz[0] = top layer (idx traced: one-hot)
    ice = vperm(p.ice, idx)
    liq = vperm(p.liq, idx)
    t = vperm(p.stc, idx)
    msno = n

    # single layer deeper than 5 cm -> split in two (func:5454-5466)
    split1 = (msno == 1) & (dz[0] > 0.05)
    half = dz[0] / 2.0
    dz = jnp.where(split1, jnp.stack([half, half, dz[2]]), dz)
    ice = jnp.where(split1,
                    jnp.stack([ice[0] / 2, ice[0] / 2, ice[2]]), ice)
    liq = jnp.where(split1,
                    jnp.stack([liq[0] / 2, liq[0] / 2, liq[2]]), liq)
    t = jnp.where(split1, jnp.stack([t[0], t[0], t[2]]), t)
    msno = jnp.where(split1, 2, msno)

    # top layer > 5 cm with >=2 layers: push excess down (func:5468-5501)
    deep1 = (msno > 1) & (dz[0] > 0.05)
    drr = dz[0] - 0.05
    propor = drr / jnp.maximum(dz[0], MPE)
    zwice = propor * ice[0]
    zwliq = propor * liq[0]
    keep = 0.05 / jnp.maximum(dz[0], MPE)
    ice0_new = keep * ice[0]
    liq0_new = keep * liq[0]
    dz2c, liq2c, ice2c, t2c = combo(dz[1], liq[1], ice[1], t[1],
                                    drr, zwliq, zwice, t[0])
    dz = jnp.where(deep1, jnp.stack([0.05, dz2c, dz[2]]), dz)
    ice = jnp.where(deep1, jnp.stack([ice0_new, ice2c, ice[2]]), ice)
    liq = jnp.where(deep1, jnp.stack([liq0_new, liq2c, liq[2]]), liq)
    t = jnp.where(deep1, jnp.stack([t[0], t2c, t[2]]), t)

    # subdivide layer 2 when only 2 layers and it got too thick
    split2 = deep1 & (msno <= 2) & (dz[1] > 0.20)
    dtdz = (t[0] - t[1]) / ((dz[0] + dz[1]) / 2.0)
    dz2h = dz[1] / 2.0
    t3_try = t[1] - dtdz * dz2h / 2.0
    t3_new = jnp.where(t3_try >= TFRZ, t[1], t3_try)
    t2_new = jnp.where(t3_try >= TFRZ, t[1], t[1] + dtdz * dz2h / 2.0)
    dz = jnp.where(split2, jnp.stack([dz[0], dz2h, dz2h]), dz)
    ice = jnp.where(split2,
                    jnp.stack([ice[0], ice[1] / 2, ice[1] / 2]), ice)
    liq = jnp.where(split2,
                    jnp.stack([liq[0], liq[1] / 2, liq[1] / 2]), liq)
    t = jnp.where(split2, jnp.stack([t[0], t2_new, t3_new]), t)
    msno = jnp.where(split2, 3, msno)

    # 3 layers: layer 2 > 20 cm pushes excess into layer 3 (func:5504-5517)
    deep2 = (msno > 2) & (dz[1] > 0.2)
    drr2 = dz[1] - 0.2
    prop2 = drr2 / jnp.maximum(dz[1], MPE)
    zwice2 = prop2 * ice[1]
    zwliq2 = prop2 * liq[1]
    keep2 = 0.2 / jnp.maximum(dz[1], MPE)
    dz3c, liq3c, ice3c, t3c = combo(dz[2], liq[2], ice[2], t[2],
                                    drr2, zwliq2, zwice2, t[1])
    dz = jnp.where(deep2, jnp.stack([dz[0], 0.2, dz3c]), dz)
    ice = jnp.where(deep2, jnp.stack([ice[0], keep2 * ice[1], ice3c]),
                    ice)
    liq = jnp.where(deep2, jnp.stack([liq[0], keep2 * liq[1], liq3c]),
                    liq)
    t = jnp.where(deep2, jnp.stack([t[0], t[1], t3c]), t)

    # write back bottom-aligned (func:5521-5526)
    new_top = _top(msno)
    k = _i3() - new_top            # top-aligned index for each slot
    valid = k >= 0
    kc = jnp.clip(k, 0, MSNOW - 1)
    dz_b = jnp.where(valid, vperm(dz, kc), 0.0)
    ice_b = jnp.where(valid, vperm(ice, kc), 0.0)
    liq_b = jnp.where(valid, vperm(liq, kc), 0.0)
    t_b = jnp.where(valid, vperm(t, kc), p.stc)
    return p._replace(nsnow=msno, dz=dz_b, ice=ice_b, liq=liq_b,
                      stc=t_b)


def snowh2o(p: Pack, dt, qsnfro, qsnsub, qrain, ssi) -> tuple:
    """Sublimation/frost on the pack + gravity drainage of liquid
    (reference func:5680-5819).  Returns (Pack, qsnbot)."""
    # no snow at all: frost/sublimation acts on soil ice (func:5726-5732)
    none_ = p.sneqv == 0.0
    sice0 = jnp.where(none_, p.sice0 + (qsnfro - qsnsub) * dt
                      / (p.dzsoil1 * 1000.0), p.sice0)
    swc0 = jnp.where(none_ & (sice0 < 0.0), p.swc0 + sice0, p.swc0)
    sice0 = jnp.where(none_ & (sice0 < 0.0), 0.0, sice0)

    # bulk shallow snow (func:5739-5754)
    bulk = (p.nsnow == 0) & (p.sneqv > 0.0)
    temp = p.sneqv
    sneqv = jnp.where(bulk, p.sneqv - qsnsub * dt + qsnfro * dt, p.sneqv)
    propor = sneqv / jnp.maximum(temp, MPE)
    snowh = jnp.where(bulk, jnp.maximum(0.0, propor * p.snowh), p.snowh)
    oversub = bulk & (sneqv < 0.0)
    sice0 = jnp.where(oversub, sice0 + sneqv / (p.dzsoil1 * 1000.0),
                      sice0)
    sneqv = jnp.where(oversub, 0.0, sneqv)
    snowh = jnp.where(oversub, 0.0, snowh)
    fix = sice0 < 0.0
    swc0 = jnp.where(fix, swc0 + sice0, swc0)
    sice0 = jnp.where(fix, 0.0, sice0)

    tiny = (snowh <= 1.0e-8) | (sneqv <= 1.0e-6)
    snowh = jnp.where(tiny, 0.0, snowh)
    sneqv = jnp.where(tiny, 0.0, sneqv)

    p = p._replace(sneqv=sneqv, snowh=snowh, swc0=swc0, sice0=sice0)

    # deep snow: sublimation from the top layer (func:5763-5778)
    deep = p.nsnow > 0
    top = _top(p.nsnow)
    wgdif = vsel(p.ice, top) - qsnsub * dt + qsnfro * dt
    ice = jnp.where(deep & (_i3() == top), wgdif, p.ice)
    p = p._replace(ice=ice)
    # if the top layer lost its ice, re-run combine
    need_combine = deep & (wgdif < 1.0e-6)
    pc = combine(p)
    p = jax.tree.map(lambda a, b: jnp.where(need_combine, a, b), pc, p)

    deep2 = p.nsnow > 0
    top2 = _top(p.nsnow)
    liq = jnp.where(
        deep2 & (_i3() == top2),
        jnp.maximum(0.0, vsel(p.liq, top2) + qrain * dt), p.liq)
    p = p._replace(liq=liq)

    # percolation top -> bottom (func:5784-5814)
    active = _i3() >= _top(p.nsnow)
    dzs = jnp.maximum(p.dz, MPE)
    vol_ice = jnp.minimum(1.0, p.ice / (dzs * DENICE))
    epore = 1.0 - vol_ice
    vol_liq = jnp.minimum(epore, p.liq / (dzs * DENWAT))

    liq = p.liq
    qin = jnp.zeros((), liq.dtype)
    qout = jnp.zeros((), liq.dtype)
    for j in range(MSNOW):
        act = active[j]
        liq_j = liq[j] + jnp.where(act, qin, 0.0)
        if j < MSNOW - 1:
            blocked = (epore[j] < 0.05) | (epore[j + 1] < 0.05)
            qo = jnp.maximum(0.0, (vol_liq[j] - ssi * epore[j])
                             * p.dz[j])
            qo = jnp.minimum(qo, (1.0 - vol_ice[j + 1] - vol_liq[j + 1])
                             * p.dz[j + 1])
            qo = jnp.where(blocked, 0.0, qo)
        else:
            qo = jnp.maximum(0.0, (vol_liq[j] - ssi * epore[j])
                             * p.dz[j])
        qo = qo * 1000.0
        liq_j = liq_j - jnp.where(act, qo, 0.0)
        liq = jnp.where((_i3() == j) & act, liq_j, liq)
        qout = jnp.where(act, qo, qout)
        qin = jnp.where(act, qo, qin)

    qsnbot = qout / dt
    return p._replace(liq=liq), qsnbot
