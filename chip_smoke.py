"""Smoke run of the offline path on one GPU, through the entry points a
user calls.

    python chip_smoke.py              # all phases on one GPU
    python chip_smoke.py --four-gpu   # the sharded path on four GPUs,
                                      # against one GPU, and nothing else

Phases, each printing one JSON line:

- device: the GPU's name and power limit (nvidia-smi), the JAX version
  and the compile cache in use.  No GPU is an error: there is no CPU
  fallback.
- case: the CONUS-flavoured heterogeneous case (examples/make_case.py,
  BASELINE.md config 4: 2**20 points, all 27 USGS classes, lakes, ice,
  19 soils, hourly NetCDF forcing, 900 s step) run for one model day
  through ``python -m noahmp_jax.driver.cli case.nml --check-budgets
  strict``: 96 steps, 3-hourly ldasout, a daily restart.
- resume: 8 steps from the day-1 restart against one continuous run
  over the same 104 steps; the final states must be bitwise equal.
- oracle: 512 columns of the case's day-1 state under random weather,
  each step on the GPU checked against the serial C++ reference column
  on the host (native/oracle.py bounds), and the double-float S_NODE
  sweep of numerics/dfloat.py run on the GPU against its f64 reference.
- step: the jitted step of bench.py at 65,536 and 2**20 points, XLA's
  bytes per point-step, the bandwidth of a large copy timed in the
  same run, and the batched Thomas solve at 2**20 x 7.

Any failure exits non-zero.  The last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Every phase is a function that also runs on CPU at a small size
(tests/test_chip_smoke.py); only ``main`` refuses a non-GPU device.
"""

import argparse
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "examples"))

import jax  # noqa: E402

from noahmp_jax.driver import cli, io  # noqa: E402
from noahmp_jax.driver.config import Config  # noqa: E402
from noahmp_jax.driver.run import run_offline  # noqa: E402
from noahmp_jax.driver.step import make_step  # noqa: E402
from noahmp_jax.params import load_params  # noqa: E402
from noahmp_jax.utils import enable_compile_cache  # noqa: E402

N_CASE = 1 << 20            # BASELINE.md config 4, "CONUS-scale ~1M"
STEPS_PER_DAY = 96          # 900 s step
RESUME_STEPS = 8
ORACLE_COLUMNS = 512
ORACLE_STEPS = 24
BENCH_SIZES = (65536, 1 << 20)
WORKDIR = os.path.join(HERE, "build", "chip_smoke")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


class CompileWatch:
    """Compile seconds and persistent-cache hits and misses inside a
    ``with`` block, from jax.monitoring's events.  ``seconds`` counts
    backend compiles and cache loads, ``trace_seconds`` tracing and
    lowering to MLIR."""

    _TRACE = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration")

    def __enter__(self):
        self.seconds, self.trace_seconds = 0.0, 0.0
        self.hits, self.misses = 0, 0
        self._on_duration = self._duration
        self._on_event = self._event
        jax.monitoring.register_event_duration_secs_listener(
            self._on_duration)
        jax.monitoring.register_event_listener(self._on_event)
        return self

    def __exit__(self, *exc):
        jax.monitoring.unregister_event_duration_listener(
            self._on_duration)
        jax.monitoring.unregister_event_listener(self._on_event)

    def _duration(self, event, duration, **kw):
        if event == "/jax/core/compile/backend_compile_duration":
            self.seconds += duration
        elif event in self._TRACE:
            self.trace_seconds += duration

    def _event(self, event, **kw):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1

    @property
    def cache(self):
        if self.hits and not self.misses:
            return "warm"
        if self.misses and not self.hits:
            return "cold"
        return "mixed" if self.hits else "none"


def states_equal(a, b):
    """Bitwise equality of two State pytrees (NaN payloads included)."""
    return all(np.asarray(x).tobytes() == np.asarray(y).tobytes()
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def _edit_namelist(path, **fields):
    text = open(path).read()
    for key, val in fields.items():
        text, k = re.subn(rf"(\n\s*{key}\s*=\s*)[^\n]*",
                          lambda m: m.group(1) + str(val), text)
        if k != 1:
            raise ValueError(f"{path}: no single {key} entry")
    with open(path, "w") as f:
        f.write(text)


def make_case(workdir, n, steps=STEPS_PER_DAY):
    """Write the seeded CONUS case for ``n`` points under ``workdir``;
    a run shorter than a day restarts at its end and writes two output
    windows.  Returns the namelist path."""
    import make_case as mc

    case = os.path.join(workdir, f"conus_{n}")
    shutil.rmtree(case, ignore_errors=True)
    mc.conus(n, seed=0, days=1, outdir=case, fmt="nc")
    nml = os.path.join(case, "case.nml")
    if steps != STEPS_PER_DAY:
        cfg = Config.from_namelist(nml)
        end = cfg.begdatetime + steps * cfg.timestep
        minutes = int(steps * cfg.dt // 60)
        _edit_namelist(
            nml, end_year=end.year, end_month=end.month,
            end_day=end.day, end_hour=end.hour, end_minute=end.minute,
            restart_frequency=f"'{minutes} minute'",
            output_frequency=f"'{max(minutes // 2, 1)} minute'")
    return nml


def phase_case(workdir, n=N_CASE, steps=STEPS_PER_DAY):
    """Generate the case and run it through the CLI with the strict
    per-step budget check.  Returns (namelist, result)."""
    t0 = time.perf_counter()
    nml = make_case(workdir, n, steps)
    gen_s = time.perf_counter() - t0
    with CompileWatch() as cw:
        stats = cli.main([nml, "--check-budgets", "strict"])
    if stats["steps"] != steps or stats["points"] != n:
        raise RuntimeError(f"case ran {stats['steps']} steps x "
                           f"{stats['points']} points, not {steps} x {n}")
    for k in ("errsw", "erreng"):
        if not stats["max_abs_" + k] < 0.01:   # func:688-721
            raise RuntimeError(f"|{k}| {stats['max_abs_' + k]} >= 0.01")
    res = {"points": n, "steps": steps, "generate_s": gen_s,
           "wall_s": stats["seconds"],
           "point_steps_per_s_wall": n * steps / stats["seconds"],
           "compile_s": cw.seconds, "trace_s": cw.trace_seconds,
           "compile_cache": cw.cache,
           "max_abs_errsw_Wm2": stats["max_abs_errsw"],
           "max_abs_erreng_Wm2": stats["max_abs_erreng"],
           "max_abs_errwat_mm": stats["max_abs_errwat"]}
    emit("case", **res)
    return nml, res


def _restart_name(when):
    return "restart_" + when.strftime("%Y%m%d%H%M") + ".nc"


def phase_resume(nml, steps=RESUME_STEPS):
    """Advance ``steps`` from the case's final restart and compare with
    one continuous run from the initial state over the same steps."""
    cfg = Config.from_namelist(nml)
    case = os.path.dirname(nml)
    end = cfg.enddatetime + steps * cfg.timestep
    resumed = dataclasses.replace(
        cfg, restart=True, resfile=_restart_name(cfg.enddatetime),
        enddatetime=end, outdir=os.path.join(case, "ldasout_resumed"))
    continuous = dataclasses.replace(
        cfg, enddatetime=end,
        outdir=os.path.join(case, "ldasout_continuous"),
        resdir=os.path.join(case, "restart_continuous"))
    sr, sc = {}, {}
    st_r, _ = run_offline(resumed, check_budgets_every="strict",
                          stats=sr)
    st_c, _ = run_offline(continuous, check_budgets_every="strict",
                          stats=sc)
    if sr["steps"] != steps or sc["steps"] != cfg.nsteps + steps:
        raise RuntimeError(f"resume ran {sr['steps']} and "
                           f"{sc['steps']} steps")
    equal = states_equal(st_r, st_c)
    emit("resume", steps=steps, continuous_steps=sc["steps"],
         bitwise_equal=equal, resumed_wall_s=sr["seconds"],
         continuous_wall_s=sc["seconds"])
    if not equal:
        raise RuntimeError("resumed state differs from the continuous "
                           "run")


def phase_oracle(nml, ncols=ORACLE_COLUMNS, nsteps=ORACLE_STEPS, seed=0):
    """Resync fuzz of ``ncols`` columns of the case's day-1 state
    against the native reference, then the S_NODE double-float sweep,
    both with the model on the default device."""
    from noahmp_jax.native.oracle import (FUZZ_TIGHT, FUZZ_CAP,
                                          FUZZ_OUTLIER_FRAC,
                                          resync_fuzz, snode_sweep,
                                          ulp_distance)
    from noahmp_jax.numerics.dfloat import smpfz_f64_parity

    cfg = Config.from_namelist(nml)
    static_all = io.load_domain(cfg.constfile)
    state_all, _ = io.load_restart(
        os.path.join(cfg.resdir, _restart_name(cfg.enddatetime)))
    n = static_all.lat.shape[0]
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(n, size=min(ncols, n), replace=False))
    static, state = jax.tree.map(
        lambda x: np.ascontiguousarray(np.asarray(x)[idx]),
        (static_all, state_all))

    params = load_params(cfg.veg_scheme, cfg.soil_scheme)
    params_host = load_params(cfg.veg_scheme, cfg.soil_scheme,
                              to_device=False)
    step = make_step(params, cfg.options, cfg.dt, donate=False)
    fuzz = resync_fuzz(step, params_host, cfg.options, static, state,
                       rng, nsteps, dt=cfg.dt, label="oracle")

    s32, bexp, psisat, at_clip, ref = snode_sweep()
    out = np.asarray(jax.jit(smpfz_f64_parity)(s32, bexp, psisat,
                                               at_clip))
    exact = float((out == ref).mean())
    ulp = float(ulp_distance(out, ref).max())
    emit("oracle", columns=len(idx), steps=nsteps,
         max_deviation=fuzz["max"], tight=FUZZ_TIGHT, cap=FUZZ_CAP,
         outliers=fuzz["outliers"], column_steps=fuzz["column_steps"],
         outliers_allowed=FUZZ_OUTLIER_FRAC * fuzz["column_steps"],
         snode_exact_share=exact, snode_max_ulp=ulp)
    # the bounds of tests/test_numerics.py::test_snode_dfloat_bitexact
    if not (exact > 0.999 and ulp <= 1.0):
        raise RuntimeError(f"S_NODE double-float: exact share {exact}, "
                           f"max ulp {ulp}")


def phase_step(sizes=BENCH_SIZES, nsteps=20):
    """bench.py's jitted step at each size, against the bandwidth of a
    large copy timed in the same run; then the batched Thomas solve."""
    import bench

    bw = bench.copy_bandwidth()
    for n in sizes:
        r = bench.time_step(n, nsteps)
        r["copy_GBps"] = bw / 1e9
        r["bandwidth_share"] = (r["bytes_per_point_step"]
                                * r["point_steps_per_sec"] / bw)
        emit("step", **r)
        if not r["point_steps_per_sec"] > 0:
            raise RuntimeError(f"step rate {r['point_steps_per_sec']}")
    n = sizes[-1]
    sec, nbytes = bench.time_thomas(n, 7)
    emit("step", kernel="numerics.tridiag.thomas", n=n, L=7,
         ms=sec * 1e3, GBps=nbytes / sec / 1e9,
         copy_share=nbytes / sec / bw)


def phase_four(workdir, n=N_CASE, steps=STEPS_PER_DAY, ndev=4):
    """The case on a mesh of ``ndev`` devices (run_offline(mesh=...))
    and on one device, and one make_sharded_step step against
    make_step; each pair must agree bitwise."""
    from noahmp_jax.dist.mesh import (make_mesh, make_sharded_step,
                                      shard_batch)

    devs = jax.devices()
    if len(devs) < ndev:
        raise RuntimeError(f"need {ndev} devices, found {len(devs)}")
    mesh = make_mesh(devs[:ndev])
    nml = make_case(workdir, n, steps)
    cfg = Config.from_namelist(nml)
    case = os.path.dirname(nml)

    def on(tag):
        return dataclasses.replace(
            cfg, outdir=os.path.join(case, "ldasout_" + tag),
            resdir=os.path.join(case, "restart_" + tag))

    s1, s4 = {}, {}
    with CompileWatch() as c1:
        st1, _ = run_offline(on("1"), check_budgets_every="strict",
                             stats=s1)
    with CompileWatch() as c4:
        st4, _ = run_offline(on(str(ndev)), mesh=mesh, use_orbax=False,
                             check_budgets_every="strict", stats=s4)
    run_equal = states_equal(st1, st4)

    params = load_params(cfg.veg_scheme, cfg.soil_scheme)
    static = io.load_domain(cfg.constfile)
    state = io.load_init(cfg.initfile, n)
    forcing = io.FileForcing(cfg.indir, cfg.infreq, static)(
        cfg.begdatetime)
    one = make_step(params, cfg.options, cfg.dt, donate=False)(
        jax.device_put(static), forcing, state)[0]
    sharded = make_sharded_step(params, cfg.options, cfg.dt, mesh,
                                donate=False)
    four = sharded(*(shard_batch(t, mesh)
                     for t in (static, forcing, state)))[0]
    step_equal = states_equal(one, four)

    def rate(s, c):
        return {"wall_s": s["seconds"], "compile_s": c.seconds,
                "trace_s": c.trace_seconds,
                "point_steps_per_s_wall": n * s["steps"] / s["seconds"]}

    emit("four_gpu", devices=ndev, points=n, steps=s4["steps"],
         one_device=rate(s1, c1), mesh=rate(s4, c4),
         run_bitwise_equal=run_equal, step_bitwise_equal=step_equal)
    if not (run_equal and step_equal):
        raise RuntimeError("the sharded path differs from one device")


def phase_device():
    """Refuse anything but a GPU; report the card and the set-up."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU; JAX found {dev.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    emit("device", nvidia_smi=smi.splitlines(), jax=jax.__version__,
         compile_cache=enable_compile_cache(), kind=dev.device_kind,
         count=len(jax.devices()))
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpu", action="store_true",
                    help="run only the four-GPU sharded path and its "
                    "one-GPU comparison")
    args = ap.parse_args(argv)

    dev = phase_device()
    if args.four_gpu:
        phase_four(WORKDIR)
    else:
        nml, _ = phase_case(WORKDIR)
        phase_resume(nml)
        phase_oracle(nml)
        phase_step()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
