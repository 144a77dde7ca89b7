#!/usr/bin/env bash
# Build the reference Fortran core + golden driver (SURVEY.md section 7
# step 2).  Requires gfortran; this repo's test image has none, so
# the harness ships dormant and tests/test_golden_fortran.py skips when
# the binary is absent.
#
# Usage: validate/build_fortran.sh [REFERENCE_DIR] [OUT_DIR]
set -euo pipefail

REF="${1:-/root/reference}"
HERE="$(cd "$(dirname "$0")" && pwd)"
OUT="${2:-$HERE/build}"

if ! command -v gfortran >/dev/null 2>&1; then
  echo "build_fortran.sh: gfortran not found; cannot build the oracle" >&2
  exit 10
fi

mkdir -p "$OUT"
cd "$OUT"

FFLAGS="-O2 -g -fbacktrace -ffpe-trap=invalid,zero -fcheck=bounds"

# module dependency order (const -> global -> utils -> params -> func)
gfortran $FFLAGS -c "$REF/core/module_noahmp_const.f90"
gfortran $FFLAGS -c "$REF/core/module_noahmp_global.f90"
gfortran $FFLAGS -c "$REF/core/module_noahmp_utils.f90"
gfortran $FFLAGS -c "$REF/core/module_noahmp_veg_param.f90"
gfortran $FFLAGS -c "$REF/core/module_noahmp_soil_param.f90"
gfortran $FFLAGS -c "$REF/core/module_noahmp_gen_param.f90"
gfortran $FFLAGS -c "$REF/core/module_noahmp_type.f90"
gfortran $FFLAGS -c "$REF/core/module_noahmp_func.f90"
gfortran $FFLAGS -c "$HERE/wrf_stubs.f90"
gfortran $FFLAGS -c "$HERE/golden_driver.f90"
gfortran $FFLAGS -o golden_driver ./*.o

echo "built: $OUT/golden_driver"
echo "run with CWD = the .TBL directory, e.g.:"
echo "  cd $REF/tbl && $OUT/golden_driver case.cfg forcing.csv"
