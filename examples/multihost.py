"""Multi-host SPMD launcher for the offline driver.

The reference is a serial single-column model; this is the scale-out
path it never had.  One JAX process per host, each seeing all of that
host's GPUs (a second process on the same GPU fails for want of memory:
JAX reserves most of a card when it first uses it).  JAX's distributed
runtime stitches the hosts into one global mesh and the land-point
axis is sharded across every GPU in the job
(SURVEY.md section 2.6: pure data parallelism, diagnostics-only
collectives).  Restarts go through the async orbax checkpointer, which
writes sharded arrays cooperatively from all hosts.

Single host (uses all local GPUs):

    python examples/multihost.py examples/case.nml

Multi-host (run once on every host, with that host's index as $WID):

    python examples/multihost.py examples/case.nml \
        --coordinator=10.0.0.2:8476 --num-processes=4 --process-id=$WID

On CPU for a dry run: JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python examples/multihost.py examples/case.nml
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("namelist", nargs="?",
                    default=os.path.join(HERE, "case.nml"))
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (multi-host only)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--points", type=int, default=None,
                    help="synthetic domain size when no domain file")
    args = ap.parse_args(argv)

    from noahmp_jax.dist.mesh import init_distributed, make_mesh
    init_distributed(args.coordinator, args.num_processes,
                     args.process_id)

    import jax
    from noahmp_jax.driver.config import Config
    from noahmp_jax.driver.run import run_offline

    mesh = make_mesh()  # 1-D over every device in the job
    ndev = len(jax.devices())
    if jax.process_index() == 0:
        print(f"mesh: {ndev} devices x {jax.process_count()} processes")

    cfg = Config.from_namelist(args.namelist)
    n_points = args.points or 64 * ndev
    # pad synthetic domains to a multiple of the device count
    n_points += (-n_points) % ndev

    state, files = run_offline(cfg, mesh=mesh, n_points=n_points,
                               verbose=jax.process_index() == 0)
    if jax.process_index() == 0:
        print(f"wrote {len(files)} output files")


if __name__ == "__main__":
    main()
