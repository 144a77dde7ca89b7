// Native serial reference implementation of the NoahMP column step.
//
// Purpose: an independent C++ oracle with *natural* control flow (true
// early exits, real branches, in-place layer shifting) for validating
// the masked/fixed-shape JAX implementation, and a fast CPU fallback.
// Physics follows the same equations as noahmp_jax/physics/* (each of
// which cites the upstream Fortran file:line it models).
//
// Single precision throughout to match the f32 batched model.
#pragma once

#include <cstdint>

namespace noahmp {

constexpr int NBAND = 2;
constexpr int NSOIL = 4;
constexpr int MSNOW = 3;
constexpr int NLEV = MSNOW + NSOIL;

// Per-column parameters: table values already gathered for the column's
// vegetation/soil/slope/color classes (done host-side in Python).
struct ColParams {
  // vegetation
  int32_t nroot;
  float canwmxp, dleaf, z0mvt, hvt, hvb, rcrown, cwpvt, xl;
  float rhol[NBAND], rhos[NBAND], taul[NBAND], taus[NBAND];
  float lai12m[12], sai12m[12];
  float tmin;
  int32_t c3c4;
  float kc25, akc, ko25, ako, vcmx25, avcmx, bp, mp, qe25, folnmx;
  float rgl, hs, rsmax, rsmin, topt;
  float sla, dilefc, dilefw, fragr, ltovrc, wrrat, wdpool, tdlef;
  float rmf25, rms25, rmr25, arm, mrp;
  // class flags for the column's land-use type
  int32_t is_urban, is_water, is_barren, is_ice_class, is_egblf;
  // soil
  float bexp, smcmax, smcref, smcwlt, psisat, dksat, dwsat, quartz;
  float kdt, frzx;
  float albsat[NBAND], albdry[NBAND];
  // general
  float csoil, zbot, czil, timean, fsatmax, mltfct, z0sno, ssi, swemax;
  float albice[NBAND], alblake[NBAND], omegas[NBAND], betads, betais;
  float emssoil, emslake, slope;
  // static per-point attributes
  float lat;
  int32_t ist, ice, isc, slptyp;
  float zsoil[NSOIL];
  float shdfac, shdmax, tbot, zlvl_ref;
};

struct Opts {
  int32_t veg, crs, btr, run, sfc, frz, inf, rad, alb, snf, tbot, stc;
};

struct ColForcing {
  float sfctmp, sfcprs, psfc, uu, vv, q2, soldn, lwdn, prcp, cosz;
  float co2air, o2air, foln, julian, yearlen;
};

// Prognostic state; layout mirrors noahmp_jax.state.State:
// snow/soil arrays are bottom-aligned, slot i = python index i
// (snow slots 0..2 with the bottom at 2; soil slots 3..6).
struct ColState {
  float canliq, canice, tv, eah, tah, fwet, lai, sai;
  float tg, qsfc, cm, ch;
  int32_t nsnow;
  float snowh, sneqv, sneqvo;
  float snice[MSNOW], snliq[MSNOW];
  float zsnso[NLEV];
  float albold, tauss;
  float ficeold[MSNOW];
  float qsnow;
  float stc[NLEV];
  float swc[NSOIL], smc[NSOIL];
  float zwt, wa, wt, wslake;
  float lfmass, rtmass, stmass, wood, stblcp, fastcp;
};

struct ColFlux {
  float fsa, fsr, fira, fsh, fcev, fgev, fctr, ssoil, trad;
  float ecan, etran, edir, runsrf, runsub;
  float apar, psn, sav, sag, fsno, nee, gpp, npp, fveg, albedo;
  float qsnbot, ponding, rssun, rssha, t2mv, t2mb, q2v, q2b, fpice;
  float errwat, errsw, erreng;
};

}  // namespace noahmp

extern "C" {
// Advance one column one timestep (in-place state update).
void noahmp_step(const noahmp::ColParams* p, const noahmp::Opts* o,
                 const noahmp::ColForcing* f, float dt,
                 noahmp::ColState* s, noahmp::ColFlux* out);

// Advance n columns (independent; OpenMP-friendly serial loop).
void noahmp_step_batch(const noahmp::ColParams* p, const noahmp::Opts* o,
                       const noahmp::ColForcing* f, float dt,
                       noahmp::ColState* s, noahmp::ColFlux* out,
                       int64_t n);
}
