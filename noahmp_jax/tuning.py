"""Performance tuning knobs.

HOT_LOOP_UNROLL: unroll the fixed-trip Newton/bisection loops
(canopy 19, bare 5, ground 5, stomata 20, frh2o 10).  Unrolling lets
XLA fuse across iterations and eliminates per-iteration carry
materialization (~40% fewer memory passes measured on CPU), at a
several-fold longer compile.  ``lax.fori_loop`` accepts an *int*
unroll factor, so besides False/True this can be 2/4/... for a partial
unroll that cuts carry materialization k-fold at ~k-fold body compile
cost.  Default off; set before building a step if you amortize one
compile over long runs.
"""

HOT_LOOP_UNROLL = False


def hot_loop_unroll():
    """bool or int unroll factor, passed straight to lax.fori_loop."""
    return HOT_LOOP_UNROLL


# Chen97 (opt_sfc=2) carry correction.  The reference divides the
# sfcdif2 conductances AKMS/AKHS by the wind speed after every call
# ("CM = CM / UR", func:2769-2771, 3155-3157) but feeds the now
# dimensionless CM/CH straight back in as conductances on the next
# iteration/timestep.  Default False reproduces that quirk bit-for-bit;
# True re-multiplies by UR when seeding the carry (dimensionally
# consistent Chen97).
CHEN97_FIXED_CARRY = False


def chen97_fixed_carry() -> bool:
    return CHEN97_FIXED_CARRY
