"""Observability and debugging utilities (SURVEY.md section 5).

The reference has no tracing/profiling/sanitizers; its failure model is
print-and-stop.  The batched equivalents here:

- ``check_budgets``: host-side assertion on the batched conservation
  residuals (the reference's abort thresholds, applied after psum-style
  reductions instead of killing a whole batch for one column).
- ``nan_report``: locate NaN/Inf leaves in a state pytree.
- ``profile_step``: wrap a step in jax.profiler traces.
- ``StepTimer``: points/sec + step-time counters for host loops.
- ``enable_compile_cache``: the one persistent-compile-cache rule that
  every entry point (CLI, bench, benchmarks, tests) follows.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import numpy as np
import jax

# <checkout>/.jax_cache: a fixed path, so a cache written by one run of
# this checkout is found by the next (the path is part of the key)
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache for every compilation:
    JAX_COMPILATION_CACHE_DIR when it is set (JAX reads it itself, and
    no other directory is set here), else <checkout>/.jax_cache.
    Returns the directory in use."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return jax.config.jax_compilation_cache_dir


SW_TOL = 0.01     # W/m2 (reference abort threshold, func:691)
ENG_TOL = 0.05    # W/m2 (0.01 upstream; widened for f32 batch round-off)
WAT_TOL = 0.5     # mm/step


class ConservationError(AssertionError):
    pass


def check_budgets(flux, sw_tol=SW_TOL, eng_tol=ENG_TOL,
                  wat_tol=WAT_TOL, ist=None):
    """Assert the conservation residuals of a batched Flux.  Raises
    ConservationError naming the worst column."""
    for name, tol in (("errsw", sw_tol), ("erreng", eng_tol),
                      ("errwat", wat_tol)):
        arr = np.abs(np.asarray(getattr(flux, name)))
        if name == "errwat" and ist is not None:
            arr = np.where(np.asarray(ist) == 1, arr, 0.0)
        worst = int(np.argmax(arr))
        if arr[worst] > tol:
            raise ConservationError(
                f"{name} = {arr[worst]:.4g} at column {worst} "
                f"(tolerance {tol})")


def nan_report(tree, prefix="") -> Dict[str, int]:
    """Return {leaf_path: bad_count} for non-finite entries."""
    bad = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        arr = np.asarray(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        n = int(np.size(arr) - np.isfinite(arr).sum())
        if n:
            bad[prefix + jax.tree_util.keystr(path)] = n
    return bad


def assert_finite(tree, what="state"):
    bad = nan_report(tree)
    if bad:
        raise FloatingPointError(f"non-finite values in {what}: {bad}")


@contextlib.contextmanager
def profile_step(logdir: str):
    """jax.profiler trace around a block (view with TensorBoard or
    xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Step-time / points-per-second counter for host time loops."""

    def __init__(self, n_points: int):
        self.n = n_points
        self.steps = 0
        self.elapsed = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed += time.perf_counter() - self._t0
        self.steps += 1

    @property
    def points_per_sec(self):
        return self.n * self.steps / max(self.elapsed, 1e-12)

    @property
    def ms_per_step(self):
        return self.elapsed / max(self.steps, 1) * 1e3

    def summary(self) -> str:
        return (f"{self.steps} steps, {self.ms_per_step:.2f} ms/step, "
                f"{self.points_per_sec:,.0f} point-steps/s")
