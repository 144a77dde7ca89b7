"""Real multi-process jax.distributed SPMD on CPU (VERDICT r4 #4).

The heavyweight orchestration lives in scripts/mp_spmd_cpu.py (it also
runs standalone); this wrapper keeps it in CI via --runslow.  It spawns 2 OS processes x 4 virtual CPU
devices with a localhost coordinator, so jax.process_index()>0 code
(process_slice, shard-file output, cooperative orbax writes) actually
executes, then checks the merged output is bitwise equal to a
single-process run.
"""

import os
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_two_process_spmd_bitwise(tmp_path):
    sys.path.insert(0, os.path.join(_REPO, "scripts"))
    from mp_spmd_cpu import run_case

    art = run_case(str(tmp_path / "mp"), n_points=32, timeout=1200,
                   verbose=False)
    assert art["bitwise_equal"]
    assert art["shard_files_merged"] >= 2
    assert art["cooperative_orbax_restart"]
