"""Command-line entry point (reference: run/main.py — which only parsed
the namelist and exited; here the time loop actually runs).

Usage: python -m noahmp_jax.driver.cli [case.nml] [--points N]
"""

import argparse

from .config import Config
from .run import run_offline

DEFAULT_NAMELIST_FILE = "case.nml"


def main(argv=None):
    """Run the case; returns the run's ``stats`` (see run_offline)."""
    parser = argparse.ArgumentParser(
        description="NoahMP-JAX land surface model (offline driver)")
    parser.add_argument("nmlfile", nargs="?", type=str,
                        default=DEFAULT_NAMELIST_FILE,
                        help="configuration namelist file")
    parser.add_argument("--points", type=int, default=None,
                        help="number of land points when no domain file "
                        "is present")
    def _budgets(v):
        return v if v == "strict" else int(v)
    parser.add_argument("--check-budgets", type=_budgets, default=0,
                        metavar="N|strict",
                        help="assert energy/water conservation every N "
                        "steps (0 = off); 'strict' reproduces the "
                        "reference's fatal per-step 0.01 W/m2 abort "
                        "(func:688-721), checked device-side every step")
    parser.add_argument("--no-compile-cache", action="store_true",
                        help="disable the persistent XLA compile cache")
    parser.add_argument("--dispatch", choices=("auto", "chunk", "step"),
                        default="auto",
                        help="chunk: one scanned device call per "
                        "output window (default); step: per-step loop")
    parser.add_argument("--chunk-steps", type=int, default=0,
                        metavar="T",
                        help="cap the scanned chunk length at T steps "
                        "(0 = no cap); T=1 keeps the async pipeline "
                        "but dispatches per step")
    args = parser.parse_args(argv)

    if not args.no_compile_cache:
        from ..utils import enable_compile_cache
        enable_compile_cache()
    cfg = Config.from_namelist(args.nmlfile)
    stats = {}
    run_offline(cfg, n_points=args.points,
                check_budgets_every=args.check_budgets,
                dispatch=args.dispatch, chunk_steps=args.chunk_steps,
                stats=stats)
    return stats


if __name__ == "__main__":
    main()
