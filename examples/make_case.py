"""Generate offline cases: domain, init, and hourly forcing files
(the reference repo references NetCDF inputs it does not ship —
run/case.nml:2-11; this produces equivalent self-contained cases).

Default: the 16-point quickstart (npz files next to case.nml).

--conus: a CONUS-flavored heterogeneous domain at any n — land-use
classes over all 27 USGS types including the special classes
(urban=1, water=16, barren=19, ice=24), soil textures over 1..19,
soil colors 1..9, lake points (ist=2), spatially varying NetCDF
forcing — the workload of BASELINE.md config 3/4.  Writes a ready
namelist next to the generated tree.

Usage:
    python examples/make_case.py                   # quickstart (n=16)
    python examples/make_case.py 100000 --conus    # heterogeneous case
"""

import argparse
import datetime
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def quickstart(n=16, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(HERE, "ldasin"), exist_ok=True)

    lat = np.deg2rad(rng.uniform(30.0, 45.0, n)).astype(np.float32)
    np.savez(os.path.join(HERE, "domain.npz"),
             lat=lat,
             lon=np.deg2rad(rng.uniform(-110, -80, n)).astype(np.float32),
             lutyp=rng.choice([2, 5, 7, 8, 11, 14], n).astype(np.int32),
             sltyp=rng.choice([3, 4, 6, 8, 9], n).astype(np.int32),
             slptyp=np.ones(n, np.int32),
             isc=rng.integers(1, 9, n).astype(np.int32),
             ist=np.ones(n, np.int32),
             ice=np.zeros(n, np.int32),
             shdfac=rng.uniform(0.3, 0.9, n).astype(np.float32),
             shdmax=rng.uniform(0.6, 0.95, n).astype(np.float32),
             tbot=np.full(n, 285.0, np.float32),
             zlvl=np.full(n, 10.0, np.float32),
             zsoil=np.array([-0.1, -0.4, -1.0, -2.0], np.float32))

    np.savez(os.path.join(HERE, "init.npz"),
             tg=np.full(n, 283.0, np.float32),
             tv=np.full(n, 283.0, np.float32),
             swc=np.full((n, 4), 0.28, np.float32),
             smc=np.full((n, 4), 0.28, np.float32))

    # hourly forcing for the day + one extra hour for interpolation
    t0 = datetime.datetime(2000, 1, 1)
    for h in range(26):
        when = t0 + datetime.timedelta(hours=h)
        tod = h % 24
        day = max(0.0, np.sin((tod - 6) / 12 * np.pi))
        np.savez(os.path.join(HERE, "ldasin",
                              when.strftime("%Y%m%d%H") + ".npz"),
                 sfctmp=np.full(n, 278.0 + 8.0 * day, np.float32),
                 sfcprs=np.full(n, 95000.0, np.float32),
                 q2=np.full(n, 0.005, np.float32),
                 uu=np.full(n, 3.0, np.float32),
                 vv=np.full(n, 1.0, np.float32),
                 soldn=np.full(n, 600.0 * day, np.float32),
                 lwdn=np.full(n, 300.0, np.float32),
                 prcp=np.full(n, 0.0005 if 10 <= tod < 14 else 0.0,
                              np.float32))
    print(f"wrote example case for {n} points under {HERE}")


# USGS special land-use classes (params/data/VEGPARMMP.TBL header)
ISURBAN, ISWATER, ISBARREN, ISICE = 1, 16, 19, 24
# SOILPARMMP STAS row 14 is 'WATER' (all-zero hydraulics): only valid
# for water-body points
SOIL_WATER = 14


def conus_domain(n, rng):
    """Heterogeneous per-point types with CONUS-flavored fractions:
    ~87% vegetated/bare land over every ordinary USGS class, 3% urban,
    3% barren, 2% glacier ice, 5% inland water (ist=2)."""
    lat_deg = rng.uniform(25.0, 49.0, n).astype(np.float32)
    lon_deg = rng.uniform(-124.0, -67.0, n).astype(np.float32)

    ordinary = [c for c in range(1, 28)
                if c not in (ISURBAN, ISWATER, ISBARREN, ISICE)]
    u = rng.random(n)
    lutyp = rng.choice(ordinary, n).astype(np.int32)
    lutyp = np.where(u < 0.03, ISURBAN, lutyp)
    lutyp = np.where((u >= 0.03) & (u < 0.06), ISBARREN, lutyp)
    lutyp = np.where((u >= 0.06) & (u < 0.08), ISICE, lutyp)
    water = (u >= 0.08) & (u < 0.13)
    lutyp = np.where(water, ISWATER, lutyp).astype(np.int32)

    soil_land = [s for s in range(1, 20) if s != SOIL_WATER]
    sltyp = rng.choice(soil_land, n).astype(np.int32)
    sltyp = np.where(water, SOIL_WATER, sltyp).astype(np.int32)

    ist = np.where(water, 2, 1).astype(np.int32)
    ice = np.where(lutyp == ISICE, 1, 0).astype(np.int32)

    return {
        "lat": np.deg2rad(lat_deg).astype(np.float32),
        "lon": np.deg2rad(lon_deg).astype(np.float32),
        "lutyp": lutyp, "sltyp": sltyp,
        "slptyp": rng.integers(1, 10, n).astype(np.int32),
        "isc": rng.integers(1, 10, n).astype(np.int32),
        "ist": ist, "ice": ice,
        "shdfac": rng.uniform(0.1, 0.95, n).astype(np.float32),
        "shdmax": rng.uniform(0.5, 0.98, n).astype(np.float32),
        "tbot": (287.0 - 0.4 * (lat_deg - 25.0)).astype(np.float32),
        "zlvl": np.full(n, 10.0, np.float32),
        "zsoil": np.array([-0.1, -0.4, -1.0, -2.0], np.float32),
    }


def conus(n, seed=0, days=1, outdir=None, start=None, fmt="nc"):
    from noahmp_jax.driver.io import save_arrays

    rng = np.random.default_rng(seed)
    outdir = outdir or os.path.join(HERE, "conus")
    indir = os.path.join(outdir, "ldasin")
    os.makedirs(indir, exist_ok=True)
    for sub in ("ldasout", "restart"):
        os.makedirs(os.path.join(outdir, sub), exist_ok=True)

    dom = conus_domain(n, rng)
    ext = ".nc" if fmt == "nc" else ".npz"
    save_arrays(os.path.join(outdir, "domain" + ext), dom)

    lat_deg = np.rad2deg(dom["lat"])
    tg0 = (290.0 - 0.45 * (lat_deg - 25.0)
           + rng.normal(0.0, 1.0, n)).astype(np.float32)
    # one draw for both: swc must equal smc at an ice-free cold start
    # (swc > smc would mean negative soil ice; swc < smc implies ice
    # in unfrozen soil — either breaks the water budget from step 0)
    sm0 = np.broadcast_to(
        rng.uniform(0.15, 0.35, (n, 1)).astype(np.float32), (n, 4))
    save_arrays(os.path.join(outdir, "init" + ext), {
        "tg": tg0, "tv": tg0,
        "swc": sm0,
        "smc": sm0,
        "sneqv": np.where(lat_deg > 44.0, 20.0, 0.0).astype(np.float32),
        "snowh": np.where(lat_deg > 44.0, 0.1, 0.0).astype(np.float32),
    })

    # hourly forcing with latitudinal + diurnal structure and a moving
    # precipitation band; files run two hours past the end, so a run
    # resumed from the final restart can go on for 8 steps
    start = start or datetime.datetime(2000, 7, 1)
    lon_deg = np.rad2deg(dom["lon"])
    for h in range(days * 24 + 3):
        when = start + datetime.timedelta(hours=h)
        tod = (h + lon_deg / 15.0) % 24.0   # local solar time-ish
        day = np.maximum(0.0, np.sin((tod - 6.0) / 12.0 * np.pi))
        tair = (302.0 - 0.5 * (lat_deg - 25.0) + 9.0 * (day - 0.3)
                + rng.normal(0.0, 0.3, n))
        band = np.abs(lon_deg + 100.0 - 0.8 * h) < 4.0
        prcp = np.where(band, 2.0e-3 * rng.random(n), 0.0)
        save_arrays(os.path.join(indir, when.strftime("%Y%m%d%H") + ext), {
            "sfctmp": tair.astype(np.float32),
            "sfcprs": np.full(n, 95000.0, np.float32),
            "q2": (0.006 + 0.004 * day).astype(np.float32),
            "uu": rng.uniform(0.5, 8.0, n).astype(np.float32),
            "vv": rng.uniform(-3.0, 3.0, n).astype(np.float32),
            "soldn": (950.0 * day).astype(np.float32),
            "lwdn": (300.0 + 60.0 * day).astype(np.float32),
            "prcp": prcp.astype(np.float32),
            "lon": dom["lon"],
        })

    end = start + datetime.timedelta(days=days)
    nml = os.path.join(outdir, "case.nml")
    rel = os.path.abspath(outdir)  # runnable from any cwd
    with open(nml, "w") as f:
        f.write(f"""&NOAHMP_OFFLINE
  ! generated by examples/make_case.py --conus (n={n}, seed={seed})
  static_parameter_file = '{rel}/domain{ext}'
  initialization_file = '{rel}/init{ext}'
  restart_file = 'restart.npz'

  input_directory = '{rel}/ldasin'
  input_frequency = '1 hour'
  output_directory = '{rel}/ldasout'
  output_frequency = '3 hour'
  restart_directory = '{rel}/restart'
  restart_frequency = '1 day'

  start_year = {start.year}
  start_month = {start.month}
  start_day = {start.day}
  start_hour = {start.hour}
  start_minute = 0
  start_second = 0

  end_year= {end.year}
  end_month = {end.month}
  end_day = {end.day}
  end_hour = {end.hour}
  end_minute = 0
  end_second = 0

  interval_seconds = 900

  opt_veg = 1
  opt_run = 1
  opt_btr = 1
  opt_rad = 1
  opt_tub = 1
  opt_can = 1
  opt_inf = 1
  opt_tbot = 1
  opt_snf = 1
/
""")
    print(f"wrote CONUS-flavored case: n={n}, {days} day(s), "
          f"fmt={fmt} under {outdir}\n  run: python -m "
          f"noahmp_jax.driver.cli {nml}")
    return outdir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("n", nargs="?", type=int, default=16)
    ap.add_argument("--conus", action="store_true",
                    help="heterogeneous CONUS-flavored case (NetCDF)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--days", type=int, default=1)
    ap.add_argument("--fmt", choices=("nc", "npz"), default="nc")
    ap.add_argument("--outdir", type=str, default=None)
    a = ap.parse_args(argv)
    if a.conus:
        conus(a.n, seed=a.seed, days=a.days, outdir=a.outdir, fmt=a.fmt)
    else:
        quickstart(a.n, seed=a.seed)


if __name__ == "__main__":
    main()
