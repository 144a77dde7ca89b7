"""True multi-process SPMD validation on CPU (VERDICT r4 next #4).

Runs the reference workflow (examples/multihost.py -> driver.run_offline)
as a REAL ``jax.distributed`` job: 2 processes x 4 virtual CPU devices
on localhost, coordinator/process_index handshake, sharded step,
``process_slice`` per-host shard output, cooperative orbax restart
writes — the process_id>0 code path executing for real — then merges
the shard files (driver.merge) and asserts every ldasout variable is
BITWISE equal to a single-process (1 proc x 8 devices) run of the same
case.  The physics is deterministic and columns are independent, so
any difference is a sharding/IO bug.

Usage:
    python scripts/mp_spmd_cpu.py [--points 64] [--artifact OUT.json]

Prints the comparison's summary; writes it to OUT.json with --artifact.
"""

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "examples"))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(ndev):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + f" --xla_force_host_platform_device_count={ndev}"
                        ).strip()
    # each subprocess gets its own compile cache usage but shares the
    # repo-level persistent cache
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _rewrite_nml(src, dst, out_tag):
    """Copy the namelist, pointing output/restart dirs at fresh
    ``ldasout_<tag>`` / ``restart_<tag>`` directories."""
    txt = open(src).read()
    txt = txt.replace("/ldasout'", f"/ldasout_{out_tag}'")
    txt = txt.replace("/restart'", f"/restart_{out_tag}'")
    with open(dst, "w") as f:
        f.write(txt)
    base = os.path.dirname(os.path.abspath(src))
    for sub in (f"ldasout_{out_tag}", f"restart_{out_tag}"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    return dst


def run_case(workdir, n_points=64, timeout=1200, verbose=True):
    """Generate the case, run 1-proc and 2-proc jobs, merge, compare.
    Returns the artifact dict (raises on any mismatch)."""
    import make_case  # examples/

    t0 = time.time()
    os.makedirs(workdir, exist_ok=True)
    make_case.conus(n_points, seed=5, days=1, outdir=workdir, fmt="nc")
    nml = os.path.join(workdir, "case.nml")
    nml_1p = _rewrite_nml(nml, os.path.join(workdir, "case_1p.nml"), "1p")
    nml_2p = _rewrite_nml(nml, os.path.join(workdir, "case_2p.nml"), "2p")
    mh = os.path.join(_REPO, "examples", "multihost.py")

    if verbose:
        print(f"[mp] case generated (n={n_points}) in "
              f"{time.time()-t0:.1f}s; single-process baseline...",
              flush=True)

    r = subprocess.run(
        [sys.executable, mh, nml_1p], env=_env(8), timeout=timeout,
        capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"1-proc run failed:\n{r.stdout}\n{r.stderr}")

    if verbose:
        print(f"[mp] baseline done ({time.time()-t0:.1f}s); "
              f"launching 2-process jax.distributed job...", flush=True)

    port = _free_port()
    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, mh, nml_2p,
             f"--coordinator=127.0.0.1:{port}",
             "--num-processes=2", f"--process-id={pid}"],
            env=_env(4), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    deadline = time.time() + timeout
    for p in procs:
        out, _ = p.communicate(timeout=max(10.0, deadline - time.time()))
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"2-proc worker {pid} failed:\n{out}")

    if verbose:
        print(f"[mp] 2-proc job done ({time.time()-t0:.1f}s); "
              f"merging shards + comparing...", flush=True)

    out2 = os.path.join(workdir, "ldasout_2p")
    shards = [f for f in os.listdir(out2) if ".nc.p" in f]
    if not shards:
        raise RuntimeError(
            "2-proc run produced no per-host shard files — "
            "shard_output path did not engage")
    r = subprocess.run(
        [sys.executable, "-m", "noahmp_jax.driver.merge", out2],
        env=_env(1), timeout=300, capture_output=True, text=True,
        cwd=_REPO)
    if r.returncode != 0:
        raise RuntimeError(f"merge failed:\n{r.stdout}\n{r.stderr}")

    # bitwise comparison of every output variable in every window
    from noahmp_jax.driver.netcdf import read_arrays
    import numpy as np

    out1 = os.path.join(workdir, "ldasout_1p")
    files1 = sorted(f for f in os.listdir(out1) if f.endswith(".nc"))
    files2 = sorted(f for f in os.listdir(out2) if f.endswith(".nc"))
    assert files1 and files1 == files2, (files1, files2)
    nvars = 0
    for f in files1:
        a = read_arrays(os.path.join(out1, f))
        b = read_arrays(os.path.join(out2, f))
        assert set(a) == set(b), (f, set(a) ^ set(b))
        for k in a:
            if not np.array_equal(a[k], b[k]):
                d = np.max(np.abs(np.asarray(a[k], np.float64)
                                  - np.asarray(b[k], np.float64)))
                raise AssertionError(
                    f"{f}:{k} differs between 1-proc and 2-proc "
                    f"(max abs diff {d:.3g})")
            nvars += 1

    # cooperative orbax restart must exist and contain both hosts' work
    orbax2 = os.path.join(workdir, "restart_2p", "orbax")
    has_orbax = os.path.isdir(orbax2) and bool(os.listdir(orbax2))

    art = {
        "what": "2-process jax.distributed SPMD on CPU vs 1-process",
        "n_points": n_points,
        "processes": 2,
        "devices_per_process": 4,
        "output_files_compared": len(files1),
        "variables_compared": nvars,
        "bitwise_equal": True,
        "shard_files_merged": len(shards),
        "cooperative_orbax_restart": has_orbax,
        "wall_seconds": round(time.time() - t0, 1),
    }
    if verbose:
        print("[mp] OK: " + json.dumps(art), flush=True)
    return art


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=64)
    ap.add_argument("--workdir", default=os.path.join(
        _REPO, "build", "mp_spmd"))
    ap.add_argument("--artifact", default=None)
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()

    if os.path.isdir(args.workdir):
        shutil.rmtree(args.workdir)
    art = run_case(args.workdir, n_points=args.points)
    if args.artifact:
        with open(args.artifact, "w") as f:
            json.dump(art, f, indent=1)
            f.write("\n")
        print(f"wrote {args.artifact}")
    if not args.keep and os.path.isdir(args.workdir):
        shutil.rmtree(args.workdir)


if __name__ == "__main__":
    main()
