// Native serial reference column physics. See noahmp_ref.hpp.
// Structure mirrors noahmp_jax/physics/*; each section notes the
// corresponding JAX module (which cites the upstream Fortran lines).

#include "noahmp_ref.hpp"

#include <algorithm>
#include <cmath>
#include <cstring>

namespace noahmp {
namespace {

// ----- constants (constants.py) -----
constexpr float MPE = 1.0e-6f;
constexpr float GRAV = 9.80616f, SB = 5.67e-8f, RGAS = 8.3144598f;
constexpr float KARMAN = 0.40f, TFRZ = 273.15f, TTRI = 273.16f;
constexpr float HSUB = 2.8440e6f, HVAP = 2.5104e6f, HFUS = 0.3336e6f;
constexpr float CWAT = 4.188e6f, CICE = 2.094e6f, CPAIR = 1004.64f;
constexpr float TKWAT = 0.6f, TKICE = 2.2f;
constexpr float RAIR = 287.04f, RVAP = 461.269f;
constexpr float DENWAT = 1000.0f, DENICE = 917.0f;

inline float clampf(float x, float lo, float hi) {
  return std::min(hi, std::max(lo, x));
}
inline float tdc(float t) { return clampf(t - TFRZ, -50.0f, 50.0f); }

// ----- esat polynomials (physics/sfc.py) -----
inline float poly6(const float* c, float t) {
  float acc = c[6];
  for (int i = 5; i >= 0; --i) acc = acc * t + c[i];
  return 100.0f * acc;
}
const float ESW[7] = {6.107799961f, 4.436518521e-1f, 1.428945805e-2f,
                      2.650648471e-4f, 3.031240396e-6f, 2.034080948e-8f,
                      6.136820929e-11f};
const float ESI[7] = {6.109177956f, 5.034698970e-1f, 1.886013408e-2f,
                      4.176223716e-4f, 5.824720280e-6f, 4.838803174e-8f,
                      1.838826904e-10f};
const float DSW[7] = {4.438099984e-1f, 2.857002636e-2f, 7.938054040e-4f,
                      1.215215065e-5f, 1.036561403e-7f, 3.532421810e-10f,
                      -7.090244804e-13f};
const float DSI[7] = {5.030305237e-1f, 3.773255020e-2f, 1.267995369e-3f,
                      2.477563108e-5f, 3.005693132e-7f, 2.158542548e-9f,
                      7.131097725e-12f};

inline void esat_t(float tk, float* es, float* des) {
  float t = tdc(tk);
  if (t > 0.0f) {
    *es = poly6(ESW, t);
    *des = poly6(DSW, t);
  } else {
    *es = poly6(ESI, t);
    *des = poly6(DSI, t);
  }
}

// ----- tridiagonal Thomas solve over rows [top, n) -----
void thomas(const float* a, const float* b, const float* c,
            const float* d, float* x, int top, int n) {
  float p[NLEV], q[NLEV];
  p[top] = -c[top] / b[top];
  q[top] = d[top] / b[top];
  for (int k = top + 1; k < n; ++k) {
    float denom = b[k] + a[k] * p[k - 1];
    p[k] = -c[k] / denom;
    q[k] = (d[k] - a[k] * q[k - 1]) / denom;
  }
  x[n - 1] = q[n - 1];
  for (int k = n - 2; k >= top; --k) x[k] = p[k] * x[k + 1] + q[k];
}

// ----- atm (physics/atm.py) -----
struct Atm {
  float thair, qair, eair, rhoair, qprecc, qprecl;
  float solad[2], solai[2], swdown;
};
Atm atm(const ColForcing& f) {
  Atm a;
  a.thair = f.sfctmp;
  a.qair = f.q2;
  a.eair = a.qair * f.sfcprs / (0.622f + 0.378f * a.qair);
  a.rhoair = (f.sfcprs - 0.378f * a.eair) / (RAIR * f.sfctmp);
  a.qprecc = 0.10f * f.prcp;
  a.qprecl = 0.90f * f.prcp;
  a.swdown = (f.cosz <= 0.0f) ? 0.0f : f.soldn;
  a.solad[0] = a.solad[1] = a.swdown * 0.7f * 0.5f;
  a.solai[0] = a.solai[1] = a.swdown * 0.3f * 0.5f;
  return a;
}

// ----- phenology (physics/phenology.py) -----
void phenology(const ColParams& p, const Opts& o, const ColForcing& f,
               float snowh, float tv, float* lai, float* sai,
               float* elai, float* esai, float* igs, float* htop) {
  if (o.veg == 1 || o.veg == 3 || o.veg == 4) {
    float day = (p.lat >= 0.0f)
                    ? f.julian
                    : std::fmod(f.julian + 0.5f * f.yearlen, f.yearlen);
    float t = 12.0f * day / f.yearlen;
    int it1 = (int)std::floor(t + 0.5f);
    int it2 = it1 + 1;
    float wt1 = (it1 + 0.5f) - t;
    float wt2 = 1.0f - wt1;
    if (it1 < 1) it1 = 12;
    if (it2 > 12) it2 = 1;
    *lai = wt1 * p.lai12m[it1 - 1] + wt2 * p.lai12m[it2 - 1];
    *sai = wt1 * p.sai12m[it1 - 1] + wt2 * p.sai12m[it2 - 1];
  }
  if (*sai < 0.05f) *sai = 0.0f;
  if (*lai < 0.05f || *sai == 0.0f) *lai = 0.0f;
  if (p.is_water || p.is_barren || p.is_ice_class || p.is_urban) {
    *lai = 0.0f;
    *sai = 0.0f;
  }
  float db = clampf(snowh - p.hvb, 0.0f, p.hvt - p.hvb);
  float fb = db / std::max(1.0e-6f, p.hvt - p.hvb);
  if (p.hvt > 0.0f && p.hvt <= 1.0f) {
    float snowhc = p.hvt * std::exp(-snowh / 0.2f);
    fb = std::min(snowh, snowhc) / std::max(snowhc, 1.0e-12f);
  }
  *elai = *lai * (1.0f - fb);
  *esai = *sai * (1.0f - fb);
  if (*esai < 0.05f) *esai = 0.0f;
  if (*elai < 0.05f || *esai == 0.0f) *elai = 0.0f;
  *igs = (tv > p.tmin) ? 1.0f : 0.0f;
  *htop = p.hvt;
}

float green_fraction(const ColParams& p, const Opts& o, float lai,
                     float sai, float elai, float esai) {
  float fveg;
  if (o.veg == 1) fveg = p.shdfac;
  else if (o.veg == 2 || o.veg == 3)
    fveg = 1.0f - std::exp(-0.52f * (lai + sai));
  else fveg = p.shdmax;
  fveg = std::max(fveg, 0.01f);
  if (p.is_urban || p.is_barren) fveg = 0.0f;
  if (elai + esai == 0.0f) fveg = 0.0f;
  return fveg;
}

// ----- thermal properties (physics/thermo.py) -----
float tdfcnd(const ColParams& p, float smc, float swc) {
  float satratio = smc / p.smcmax;
  float thks = std::pow(7.7f, p.quartz) * std::pow(2.0f, 1.0f - p.quartz);
  float xunfroz = swc / std::max(smc, MPE);
  float xu = xunfroz * p.smcmax;
  float thksat = std::pow(thks, 1.0f - p.smcmax) *
                 std::pow(TKICE, p.smcmax - xu) * std::pow(0.57f, xu);
  float gammd = (1.0f - p.smcmax) * 2700.0f;
  float thkdry = (0.135f * gammd + 64.7f) / (2700.0f - 0.947f * gammd);
  float ake;
  if ((swc + 0.0005f) < smc) {
    ake = satratio;
  } else {
    ake = (satratio > 0.1f) ? std::log10(satratio) + 1.0f : 0.0f;
  }
  return ake * (thksat - thkdry) + thkdry;
}

void thermoprop(const ColParams& p, const Opts&, const ColState& s,
                float dt, const float* dzsnso, float* df, float* hcpct,
                float* fact) {
  int top = MSNOW - s.nsnow;
  for (int i = 0; i < MSNOW; ++i) {
    float dz = std::max(dzsnso[i], MPE);
    float snicev = std::min(1.0f, s.snice[i] / (dz * DENICE));
    float epore = 1.0f - snicev;
    float snliqv = std::min(epore, s.snliq[i] / (dz * DENWAT));
    float bdsnoi = (s.snice[i] + s.snliq[i]) / dz;
    hcpct[i] = CICE * snicev + CWAT * snliqv;
    df[i] = 3.2217e-6f * bdsnoi * bdsnoi;
  }
  for (int k = 0; k < NSOIL; ++k) {
    int i = MSNOW + k;
    float sice = s.smc[k] - s.swc[k];
    hcpct[i] = s.swc[k] * CWAT + (1.0f - p.smcmax) * p.csoil +
               (p.smcmax - s.smc[k]) * CPAIR + sice * CICE;
    df[i] = tdfcnd(p, s.smc[k], s.swc[k]);
    if (p.is_urban) df[i] = 3.24f;
    if (p.ist == 2) {
      hcpct[i] = (s.stc[i] > TFRZ) ? CWAT : CICE;
      df[i] = (s.stc[i] > TFRZ) ? TKWAT : TKICE;
    }
  }
  for (int i = 0; i < NLEV; ++i)
    fact[i] = dt / (hcpct[i] * std::max(dzsnso[i], MPE));
  // snow/soil interface blending
  float dz1 = dzsnso[MSNOW];
  if (s.nsnow == 0) {
    df[MSNOW] = (df[MSNOW] * dz1 + 0.35f * s.snowh) / (s.snowh + dz1);
  } else {
    float dz0 = dzsnso[MSNOW - 1];
    df[MSNOW] = (df[MSNOW] * dz1 + df[MSNOW - 1] * dz0) /
                std::max(dz0 + dz1, MPE);
  }
}

// ----- radiation (physics/radiation.py) -----
struct RadOut {
  float fsun, laisun, laisha, parsun, parsha;
  float sav, sag, fsa, fsr, fsrv, fsrg, bgap, wgap;
  float albold, tauss;
};

void twostream(const ColParams& p, const Opts&, bool direct, float cosz,
               float vai, float fwet, float t, const float* albgrd,
               const float* albgri, const float* rho, const float* tau,
               float gap, float kopen, float* fab, float* fre,
               float* ftd, float* fti, float* gdir_out) {
  float coszi = std::max(0.001f, cosz);
  float chil = clampf(p.xl, -0.4f, 0.6f);
  if (std::fabs(chil) <= 0.01f) chil = 0.01f;
  float phi1 = 0.5f - 0.633f * chil - 0.330f * chil * chil;
  float phi2 = 0.877f * (1.0f - 2.0f * phi1);
  float gdir = phi1 + phi2 * coszi;
  float ext = gdir / coszi;
  float avmu = (1.0f - phi1 / phi2 * std::log((phi1 + phi2) / phi1)) / phi2;
  *gdir_out = gdir;
  for (int ib = 0; ib < NBAND; ++ib) {
    float omegal = rho[ib] + tau[ib];
    float tmp0 = gdir + phi2 * coszi;
    float tmp1 = phi1 * coszi;
    float asu = 0.5f * omegal * gdir / tmp0 *
                (1.0f - tmp1 / tmp0 * std::log((tmp1 + tmp0) / tmp1));
    float betadl = (1.0f + avmu * ext) / (omegal * avmu * ext) * asu;
    float betail = 0.5f *
                   (rho[ib] + tau[ib] +
                    (rho[ib] - tau[ib]) * std::pow((1.0f + chil) / 2.0f, 2.0f)) /
                   omegal;
    float omega, betad, betai;
    if (t > TFRZ) {
      omega = omegal;
      betad = betadl;
      betai = betail;
    } else {
      omega = (1.0f - fwet) * omegal + fwet * p.omegas[ib];
      betad = ((1.0f - fwet) * omegal * betadl +
               fwet * p.omegas[ib] * p.betads) / omega;
      betai = ((1.0f - fwet) * omegal * betail +
               fwet * p.omegas[ib] * p.betais) / omega;
    }
    float b = 1.0f - omega + omega * betai;
    float c = omega * betai;
    tmp0 = avmu * ext;
    float d = tmp0 * omega * betad;
    float fq = tmp0 * omega * (1.0f - betad);
    tmp1 = b * b - c * c;
    float h = std::sqrt(std::max(tmp1, MPE)) / avmu;
    float sigma = tmp0 * tmp0 - tmp1;
    if (std::fabs(sigma) < 1.0e-6f) sigma = (sigma >= 0 ? 1.0e-6f : -1.0e-6f);
    float p1 = b + avmu * h, p2 = b - avmu * h;
    float p3 = b + tmp0, p4 = b - tmp0;
    float s1 = std::exp(-std::min(h * vai, 50.0f));
    float s2 = std::exp(-std::min(ext * vai, 50.0f));
    float albg = direct ? albgrd[ib] : albgri[ib];
    float u1 = b - c / std::max(albg, MPE);
    float u2 = b - c * albg;
    float u3 = fq + c * albg;
    float tmp2 = u1 - avmu * h, tmp3 = u1 + avmu * h;
    float d1 = p1 * tmp2 / s1 - p2 * tmp3 * s1;
    float tmp4 = u2 + avmu * h, tmp5 = u2 - avmu * h;
    float d2 = tmp4 / s1 - tmp5 * s1;
    float h1 = -d * p4 - c * fq;
    float tmp6 = d - h1 * p3 / sigma;
    float tmp7 = (d - c - h1 / sigma * (u1 + tmp0)) * s2;
    float h2 = (tmp6 * tmp2 / s1 - p2 * tmp7) / d1;
    float h3 = -(tmp6 * tmp3 * s1 - p1 * tmp7) / d1;
    float h4 = -fq * p3 - c * d;
    float tmp8 = h4 / sigma;
    float tmp9 = (u3 - tmp8 * (u2 - tmp0)) * s2;
    float h5 = -(tmp8 * tmp4 / s1 + tmp9) / d2;
    float h6 = (tmp8 * tmp5 * s1 + tmp9) / d2;
    float h7 = (c * tmp2) / (d1 * s1);
    float h8 = (-c * tmp3 * s1) / d1;
    float h9 = tmp4 / (d2 * s1);
    float h10 = (-tmp5 * s1) / d2;
    float ftds, ftis, fres;
    if (direct) {
      ftds = s2 * (1.0f - gap) + gap;
      ftis = (h4 * s2 / sigma + h5 * s1 + h6 / s1) * (1.0f - gap);
      fres = (h1 / sigma + h2 + h3) * (1.0f - gap) + albgrd[ib] * gap;
    } else {
      ftds = 0.0f;
      ftis = (h9 * s1 + h10 / s1) * (1.0f - kopen) + kopen;
      fres = (h7 + h8) * (1.0f - kopen) + albgri[ib] * kopen;
    }
    ftd[ib] = ftds;
    fti[ib] = ftis;
    fre[ib] = fres;
    fab[ib] = 1.0f - fres - (1.0f - albgrd[ib]) * ftds -
              (1.0f - albgri[ib]) * ftis;
  }
}

RadOut radiation(const ColParams& p, const Opts& o, const ColState& s,
                 const Atm& a, const ColForcing& f, float dt, float fsno,
                 float elai, float esai, float fveg) {
  RadOut r{};
  r.albold = s.albold;
  r.tauss = s.tauss;
  float vai = elai + esai;

  // snow age (day and night state freeze mirrors the JAX module)
  float tauss = s.tauss, fage = 0.0f;
  {
    float dela0 = 1.0e-6f * dt;
    float arg = 5.0e3f * (1.0f / TFRZ - 1.0f / s.tg);
    float tage = std::exp(arg) + std::exp(std::min(0.0f, 10.0f * arg)) + 0.3f;
    float dela = dela0 * tage;
    float dels = std::max(0.0f, s.sneqv - s.sneqvo) / p.swemax;
    float sge = (tauss + dela) * (1.0f - dels);
    tauss = (s.sneqv <= 0.0f || s.sneqv > 800.0f) ? 0.0f
                                                  : std::max(0.0f, sge);
    fage = tauss / (tauss + 1.0f);
  }

  if (f.cosz <= 0.0f) {
    return r;  // nighttime: all-zero fluxes, frozen snow-age state
  }
  r.tauss = tauss;

  float wl = elai / std::max(vai, MPE);
  float ws = esai / std::max(vai, MPE);
  float rho[2], tau[2];
  for (int ib = 0; ib < 2; ++ib) {
    rho[ib] = std::max(p.rhol[ib] * wl + p.rhos[ib] * ws, MPE);
    tau[ib] = std::max(p.taul[ib] * wl + p.taus[ib] * ws, MPE);
  }

  float albsnd[2], albsni[2];
  if (o.alb == 1) {
    float sl = 2.0f;
    float cf1 = (1.0f + 1.0f / sl) / (1.0f + 2.0f * sl * f.cosz) - 1.0f / sl;
    float fzen = std::max(cf1, 0.0f);
    albsni[0] = 0.95f * (1.0f - 0.2f * fage);
    albsni[1] = 0.65f * (1.0f - 0.5f * fage);
    albsnd[0] = albsni[0] + 0.4f * fzen * (1.0f - albsni[0]);
    albsnd[1] = albsni[1] + 0.4f * fzen * (1.0f - albsni[1]);
  } else {
    float alb = 0.55f + (s.albold - 0.55f) * std::exp(-0.01f * dt / 3600.0f);
    if (s.qsnow > 0.0f)
      alb = alb + std::min(s.qsnow * dt, p.swemax) * (0.84f - alb) / p.swemax;
    albsnd[0] = albsnd[1] = albsni[0] = albsni[1] = alb;
    r.albold = alb;
  }

  float albgrd[2], albgri[2];
  for (int ib = 0; ib < 2; ++ib) {
    float inc = std::max(0.11f - 0.40f * s.smc[0], 0.0f);
    float albsod, albsoi;
    if (p.ist == 1) {
      albsod = std::min(p.albsat[ib] + inc, p.albdry[ib]);
      albsoi = albsod;
    } else if (s.tg > TFRZ) {
      albsod = 0.06f / (std::pow(std::max(0.01f, f.cosz), 1.7f) + 0.15f);
      albsoi = 0.06f;
    } else {
      albsod = p.alblake[ib];
      albsoi = albsod;
    }
    if (p.ist == 1 && p.isc == 9) {
      albsod += 0.10f;
      albsoi += 0.10f;
    }
    albgrd[ib] = albsod * (1.0f - fsno) + albsnd[ib] * fsno;
    albgri[ib] = albsoi * (1.0f - fsno) + albsni[ib] * fsno;
  }

  // gap probabilities
  float gap, kopen, bgap = 0.0f, wgap = 0.0f;
  const float pai = 3.14159265f;
  if (vai == 0.0f) {
    gap = 1.0f;
    kopen = 1.0f;
  } else if (o.rad == 1) {
    float rc = std::max(p.rcrown, MPE);
    float denfveg = -std::log(std::max(1.0f - fveg, 0.01f)) / (pai * rc * rc);
    float hd = p.hvt - p.hvb;
    float bb = 0.5f * hd;
    float thetap = std::atan(bb / rc * std::tan(std::acos(
        clampf(std::max(0.01f, f.cosz), -1.0f, 1.0f))));
    bgap = std::exp(-denfveg * pai * rc * rc / std::cos(thetap));
    float fa = vai / std::max(1.33f * pai * rc * rc * rc * (bb / rc) * denfveg,
                              MPE);
    float newvai = hd * fa;
    wgap = (1.0f - bgap) * std::exp(-0.5f * newvai /
                                    std::max(f.cosz, 0.001f));
    gap = std::min(1.0f - fveg, bgap + wgap);
    kopen = 0.05f;
  } else if (o.rad == 2) {
    gap = 0.0f;
    kopen = 0.0f;
  } else {
    gap = 1.0f - fveg;
    kopen = 1.0f - fveg;
  }
  r.bgap = bgap;
  r.wgap = wgap;

  float fabd[2], fabi[2], albd[2], albi[2], ftdd[2], ftid[2], ftdi[2],
      ftii[2], gdir;
  twostream(p, o, true, f.cosz, vai, s.fwet, s.tv, albgrd, albgri, rho,
            tau, gap, kopen, fabd, albd, ftdd, ftid, &gdir);
  twostream(p, o, false, f.cosz, vai, s.fwet, s.tv, albgrd, albgri, rho,
            tau, gap, kopen, fabi, albi, ftdi, ftii, &gdir);
  // direct-reflection split for fsrv/fsrg
  float frevd[2], fregd[2], frevi[2], fregi[2];
  for (int ib = 0; ib < 2; ++ib) {
    // recompute: for direct, veg part excludes the ground-gap term
    fregd[ib] = albgrd[ib] * gap;
    frevd[ib] = albd[ib] - fregd[ib];
    frevi[ib] = albi[ib];
    fregi[ib] = 0.0f;
  }

  float ext = gdir / std::max(f.cosz, 0.001f) *
              std::sqrt(std::max(1.0f - rho[0] - tau[0], 0.0f));
  float fsun = (1.0f - std::exp(-std::min(ext * vai, 50.0f))) /
               std::max(ext * vai, MPE);
  if (fsun < 0.01f) fsun = 0.0f;
  r.fsun = fsun;

  // surrad
  float fsha = 1.0f - fsun;
  r.laisun = elai * fsun;
  r.laisha = elai * fsha;
  float cad[2], cai[2];
  for (int ib = 0; ib < 2; ++ib) {
    cad[ib] = a.solad[ib] * fabd[ib];
    cai[ib] = a.solai[ib] * fabi[ib];
    r.sav += cad[ib] + cai[ib];
    float trd = a.solad[ib] * ftdd[ib];
    float tri = a.solad[ib] * ftid[ib] + a.solai[ib] * ftii[ib];
    r.sag += trd * (1.0f - albgrd[ib]) + tri * (1.0f - albgri[ib]);
  }
  r.fsa = r.sav + r.sag;
  float laifra = elai / std::max(vai, MPE);
  if (fsun > 0.0f) {
    r.parsun = (cad[0] + fsun * cai[0]) * laifra / std::max(r.laisun, MPE);
    r.parsha = (fsha * cai[0]) * laifra / std::max(r.laisha, MPE);
  } else {
    r.parsun = 0.0f;
    r.parsha = (cad[0] + cai[0]) * laifra / std::max(r.laisha, MPE);
  }
  r.fsr = albd[0] * a.solad[0] + albi[0] * a.solai[0] +
          albd[1] * a.solad[1] + albi[1] * a.solai[1];
  r.fsrv = frevd[0] * a.solad[0] + frevi[0] * a.solai[0] +
           frevd[1] * a.solad[1] + frevi[1] * a.solai[1];
  r.fsrg = fregd[0] * a.solad[0] + fregi[0] * a.solai[0] +
           fregd[1] * a.solad[1] + fregi[1] * a.solai[1];
  return r;
}

// ----- stability (physics/sfc.py) -----
struct Sfc1 {
  float moz = 0, fm = 0, fh = 0, fm2 = 0, fh2 = 0, fv = 0.1f;
  int mozsgn = 0;
};

void sfcdif1(bool first, Sfc1& c, float sfctmp, float rhoair, float h,
             float qair, float zlvl, float zpd, float z0m, float z0h,
             float ur, float* cm, float* ch) {
  float mozold = c.moz;
  float dz = std::max(zlvl - zpd, MPE);
  float tmpcm = std::log(dz / z0m);
  float tmpch = std::log(dz / z0h);
  float tmpcm2 = std::log((2.0f + z0m) / z0m);
  float tmpch2 = std::log((2.0f + z0h) / z0h);
  float moz, moz2;
  if (first) {
    moz = 0.0f;
    moz2 = 0.0f;
  } else {
    float tvir = (1.0f + 0.61f * qair) * sfctmp;
    float tmp1 = KARMAN * (GRAV / tvir) * h / (rhoair * CPAIR);
    if (std::fabs(tmp1) <= MPE) tmp1 = MPE;
    float mol = -1.0f * c.fv * c.fv * c.fv / tmp1;
    moz = std::min(dz / mol, 1.0f);
    moz2 = std::min((2.0f + z0h) / mol, 1.0f);
  }
  if (mozold * moz < 0.0f) c.mozsgn += 1;
  if (c.mozsgn >= 2) {
    moz = 0.0f;
    c.fm = 0.0f;
    c.fh = 0.0f;
    moz2 = 0.0f;
    c.fm2 = 0.0f;
    c.fh2 = 0.0f;
  }
  auto unstable = [](float m, float* fmn, float* fhn) {
    float t1 = std::pow(1.0f - 16.0f * std::min(m, 0.0f), 0.25f);
    float t2 = std::log((1.0f + t1 * t1) / 2.0f);
    float t3 = std::log((1.0f + t1) / 2.0f);
    *fmn = 2.0f * t3 + t2 - 2.0f * std::atan(t1) + 1.5707963f;
    *fhn = 2.0f * t2;
  };
  float fmnew, fhnew, fm2new, fh2new;
  if (moz < 0.0f) {
    unstable(moz, &fmnew, &fhnew);
    unstable(moz2, &fm2new, &fh2new);
  } else {
    fmnew = fhnew = -5.0f * moz;
    fm2new = fh2new = -5.0f * moz2;
  }
  if (first) {
    c.fm = fmnew;
    c.fh = fhnew;
    c.fm2 = fm2new;
    c.fh2 = fh2new;
  } else {
    c.fm = 0.5f * (c.fm + fmnew);
    c.fh = 0.5f * (c.fh + fhnew);
    c.fm2 = 0.5f * (c.fm2 + fm2new);
    c.fh2 = 0.5f * (c.fh2 + fh2new);
  }
  c.fh = std::min(c.fh, 0.9f * tmpch);
  c.fm = std::min(c.fm, 0.9f * tmpcm);
  c.fh2 = std::min(c.fh2, 0.9f * tmpch2);
  c.fm2 = std::min(c.fm2, 0.9f * tmpcm2);
  auto guard = [](float x) { return std::fabs(x) <= MPE ? MPE : x; };
  float cmfm = guard(tmpcm - c.fm);
  float chfh = guard(tmpch - c.fh);
  *cm = KARMAN * KARMAN / (cmfm * cmfm);
  *ch = KARMAN * KARMAN / (cmfm * chfh);
  c.fv = ur * std::sqrt(*cm);
  c.moz = moz;
}

struct Sfc2 {
  float akms, akhs, rlmo = 0, wstar2 = 0, ustar = 0.1f;
};

void sfcdif2(bool first, Sfc2& c, float z0, float thz0, float thlm,
             float sfcspd, float czil, float zlm) {
  const float vkrm = 0.40f, wwst2 = 1.44f, excm = 0.001f;
  const float btg = GRAV / 270.0f, elfc = vkrm * btg;
  const float wold = 0.15f, wnew = 0.85f, pihf = 3.14159265f / 2.0f;
  const float epsu2 = 1.0e-4f, epsust = 0.07f;
  const float ztmin = -5.0f, ztmax = 1.0f, hpbl = 1000.0f, sqvisc = 258.2f;
  auto pspmu = [&](float xx) {
    return -2.0f * std::log((xx + 1.0f) * 0.5f) -
           std::log((xx * xx + 1.0f) * 0.5f) + 2.0f * std::atan(xx) - pihf;
  };
  auto psphu = [](float xx) {
    return -2.0f * std::log((xx * xx + 1.0f) * 0.5f);
  };
  float zilfc = -czil * vkrm * sqvisc;
  float zu = z0;
  float rdz = 1.0f / zlm;
  float cxch = excm * rdz;
  float dthv = thlm - thz0;
  float du2 = std::max(sfcspd * sfcspd, epsu2);
  float btgh = btg * hpbl;
  if (first) {
    c.wstar2 = (btgh * c.akhs * dthv != 0.0f)
                   ? wwst2 * std::pow(std::fabs(btgh * c.akhs * dthv),
                                      2.0f / 3.0f)
                   : 0.0f;
    c.ustar = std::max(std::sqrt(c.akms * std::sqrt(du2 + c.wstar2)),
                       epsust);
    c.rlmo = elfc * c.akhs * dthv / (c.ustar * c.ustar * c.ustar);
  }
  float zt = std::max(1.0e-6f, std::exp(zilfc * std::sqrt(c.ustar * z0)) * z0);
  float zslu = zlm + zu;
  float zslt = zlm + zt;
  float rlogu = std::log(zslu / zu);
  float rlogt = std::log(zslt / zt);
  float zetalt = std::max(zslt * c.rlmo, ztmin);
  c.rlmo = zetalt / zslt;
  float zetalu = zslu * c.rlmo;
  float zetau = zu * c.rlmo;
  float zetat = zt * c.rlmo;
  float simm, simh;
  if (c.rlmo < 0.0f) {
    auto qr = [](float z) {
      return std::sqrt(std::sqrt(std::max(1.0f - 16.0f * z, MPE)));
    };
    simm = pspmu(qr(zetalu)) - pspmu(qr(zetau)) + rlogu;
    simh = psphu(qr(zetalt)) - psphu(qr(zetat)) + rlogt;
  } else {
    float zl_u = std::min(zetalu, ztmax);
    float zl_t = std::min(zetalt, ztmax);
    simm = 5.0f * zl_u - 5.0f * zetau + rlogu;
    simh = 5.0f * zl_t - 5.0f * zetat + rlogt;
  }
  c.ustar = std::max(std::sqrt(c.akms * std::sqrt(du2 + c.wstar2)), epsust);
  float ustark = c.ustar * vkrm;
  c.akms = std::max(ustark / simm, cxch);
  c.akhs = std::max(ustark / simh, cxch);
  c.wstar2 = (btgh * c.akhs * dthv != 0.0f)
                 ? wwst2 * std::pow(std::fabs(btgh * c.akhs * dthv),
                                    2.0f / 3.0f)
                 : 0.0f;
  float rlmn = elfc * c.akhs * dthv / (c.ustar * c.ustar * c.ustar);
  c.rlmo = c.rlmo * wold + rlmn * wnew;
}

void ragrb(const ColParams& p, bool first, float* mozg, float* fhg,
           float vai, float rhoair, float hg, float tah, float zpd,
           float z0mg, float z0hg, float hcan, float uc, float z0h,
           float fv, float cwp, float* rahg, float* rawg, float* rb) {
  float tmp1 = KARMAN * (GRAV / tah) * hg / (rhoair * CPAIR);
  if (std::fabs(tmp1) <= MPE) tmp1 = MPE;
  float molg = -1.0f * fv * fv * fv / tmp1;
  float mg = first ? 0.0f : std::min((zpd - z0mg) / molg, 1.0f);
  float fhgnew = (mg < 0.0f)
                     ? std::pow(1.0f - 15.0f * std::min(mg, 0.0f), -0.25f)
                     : 1.0f + 4.7f * mg;
  *fhg = first ? fhgnew : 0.5f * (*fhg + fhgnew);
  *mozg = mg;
  float cwpc = std::sqrt(std::max(cwp * vai * hcan * (*fhg), MPE));
  float t1 = std::exp(-cwpc * z0hg / hcan);
  float t2 = std::exp(-cwpc * (z0h + zpd) / hcan);
  float tmprah2 = hcan * std::exp(std::min(cwpc, 50.0f)) / cwpc * (t1 - t2);
  float kh = std::max(KARMAN * fv * (hcan - zpd), MPE);
  *rahg = tmprah2 / kh;
  *rawg = *rahg;
  float tmprb = cwpc * 50.0f / (1.0f - std::exp(-cwpc / 2.0f));
  *rb = tmprb * std::sqrt(p.dleaf / std::max(uc, MPE));
}

// ----- stomata / canres (physics/sfc.py) -----
void stomata(const ColParams& p, float igs, float sfcprs, float sfctmp,
             float apar, float tv, float ea, float ei, float o2,
             float co2, float foln, float btran, float rb, float* rs,
             float* psn) {
  float cf = sfcprs / (RGAS * sfctmp) * 1.0e6f;
  *rs = 1.0f / p.bp * cf;
  *psn = 0.0f;
  if (apar <= 0.0f) return;
  float fnf = std::min(foln / std::max(MPE, p.folnmx), 1.0f);
  float tc = tv - TFRZ;
  float ppf = 4.6f * apar;
  float j = ppf * p.qe25;
  float kc = p.kc25 * std::pow(p.akc, (tc - 25.0f) / 10.0f);
  float ko = p.ko25 * std::pow(p.ako, (tc - 25.0f) / 10.0f);
  float awc = kc * (1.0f + o2 / ko);
  float cp = 0.5f * kc / ko * o2 * 0.21f;
  float vcmx = p.vcmx25 /
               (1.0f + std::exp((-2.2e5f + 710.0f * (tc + TFRZ)) /
                                (8.314f * (tc + TFRZ)))) *
               fnf * btran * std::pow(p.avcmx, (tc - 25.0f) / 10.0f);
  float rlb = rb / cf;
  float cihigh = 1.5f * co2, cilow = 0.0f, ci = co2;
  for (int it = 0; it < 20; ++it) {
    ci = 0.5f * (cihigh + cilow);
    float wj, wc, we;
    if (p.c3c4 == 1) {
      wj = std::max(ci - cp, 0.0f) * j / (ci + 2.0f * cp);
      wc = std::max(ci - cp, 0.0f) * vcmx / (ci + awc);
      we = 0.5f * vcmx;
    } else {
      wj = j;
      wc = vcmx;
      we = 4000.0f * vcmx * ci / sfcprs;
    }
    float ps = std::min(std::min(wj, wc), we) * igs;
    float cs = std::max(co2 - 1.37f * rlb * sfcprs * ps, MPE);
    float aa = p.mp * ps * sfcprs * ea / (cs * ei) + p.bp;
    float bb = (p.mp * ps * sfcprs / cs + p.bp) * rlb - 1.0f;
    float cc = -rlb;
    float disc = std::sqrt(std::max(bb * bb - 4.0f * aa * cc, 0.0f));
    float q = (bb >= 0.0f) ? -0.5f * (bb + disc) : -0.5f * (bb - disc);
    float r1 = q / aa, r2 = cc / q;
    *rs = std::max(r1, r2);
    *psn = ps;
    float fci = std::max(cs - ps * sfcprs * 1.65f * (*rs), 0.0f);
    if ((cihigh - cilow) <= 5.0e-2f || std::fabs(fci - ci) <= MPE) break;
    if (fci > ci) cilow = ci;
    else cihigh = ci;
  }
  *rs = *rs * cf;
}

void calhum(float sfctmp, float sfcprs, float* q2sat, float* dqsdt2) {
  const float a2 = 17.67f, a3 = 273.15f, a4 = 29.65f;
  const float elwv = 2.501e6f, e0 = 0.611f, rv = 461.0f, eps = 0.622f;
  float es = e0 * std::exp(elwv / rv * (1.0f / a3 - 1.0f / sfctmp));
  float sfcprsx = sfcprs * 1.0e-3f;
  float q = eps * es / (sfcprsx - es) * 1.0e3f;
  *dqsdt2 = (q / (1.0f + q)) * (a2 * (a3 - a4)) /
            ((sfctmp - a4) * (sfctmp - a4));
  *q2sat = q * 1.0e-3f;
}

void canres(const ColParams& p, float sfcprs, float tv, float par,
            float eah, float btran, float* rs, float* psn) {
  float q2 = 0.622f * eah / (sfcprs - 0.378f * eah);
  q2 = q2 / (1.0f + q2);
  float q2sat, dq;
  calhum(tv, sfcprs, &q2sat, &dq);
  float ff = 2.0f * par / p.rgl;
  float rcs = clampf((ff + p.rsmin / p.rsmax) / (1.0f + ff), 0.0001f, 1.0f);
  float rct = clampf(1.0f - 0.0016f * (p.topt - tv) * (p.topt - tv),
                     0.0001f, 1.0f);
  float rcq = clampf(1.0f / (1.0f + p.hs * std::max(0.0f, q2sat - q2)),
                     0.01f, 1.0f);
  *rs = p.rsmin / (rcs * rct * rcq * std::max(btran, MPE));
  *psn = 0.0f;
}

}  // namespace
}  // namespace noahmp

// The step implementation continues in noahmp_ref2.cpp (energy/water/
// carbon drivers); shared internals are re-declared there via this
// include trick: both TUs compile together in one .so.
#include "noahmp_ref2.inc"
