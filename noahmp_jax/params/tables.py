"""Parameter tables as device arrays.

The reference keeps per-class parameters in Fortran module globals filled
from text tables (core/module_noahmp_veg_param.f90:19-74,
core/module_noahmp_soil_param.f90:13-28, core/module_noahmp_gen_param.f90:12-48).
Here each becomes a small replicated jnp array inside a NamedTuple pytree;
per-point lookups are ``table[lutyp]`` gathers on device.

Arrays are padded with a zero row at index 0 so the 1-based class indices
from the data files index directly.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from . import reader

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

VEG_SCHEMES = ("USGS", "MODIFIED_IGBP_MODIS_NOAH")
SOIL_SCHEMES = ("STAS", "STAS-RUC")


class VegParams(NamedTuple):
    """Vegetation parameters, indexed by 1-based land-use class."""
    # special land-use class indices (VEGPARMMP.TBL header scalars)
    isurban: jnp.ndarray
    iswater: jnp.ndarray
    isbarren: jnp.ndarray
    isice: jnp.ndarray
    isegblf: jnp.ndarray
    # radiation (RAD table)
    xl: jnp.ndarray        # leaf/stem orientation index
    rhol: jnp.ndarray      # (n, 2) leaf reflectance vis/nir
    rhos: jnp.ndarray      # (n, 2) stem reflectance
    taul: jnp.ndarray      # (n, 2) leaf transmittance
    taus: jnp.ndarray      # (n, 2) stem transmittance
    # monthly climatology
    lai12m: jnp.ndarray    # (n, 12)
    sai12m: jnp.ndarray    # (n, 12)
    # structure / physiology (PHYS table)
    nroot: jnp.ndarray     # rooting depth in layers (int)
    canwmxp: jnp.ndarray   # max intercepted water per LAI+SAI [mm]
    dleaf: jnp.ndarray     # characteristic leaf dimension [m]
    z0mvt: jnp.ndarray     # momentum roughness length [m]
    hvt: jnp.ndarray       # canopy top [m]
    hvb: jnp.ndarray       # canopy bottom [m]
    den: jnp.ndarray       # stem density [m-2]
    rcrown: jnp.ndarray    # crown radius [m]
    cwpvt: jnp.ndarray     # canopy wind parameter
    # dynamic vegetation (DVEG table)
    sla: jnp.ndarray       # single-side leaf area per kg [m2 kg-1]
    dilefc: jnp.ndarray    # cold-stress leaf death coefficient [s-1]
    dilefw: jnp.ndarray    # drought-stress leaf death coefficient [s-1]
    fragr: jnp.ndarray     # fraction of growth respiration
    ltovrc: jnp.ndarray    # leaf turnover [s-1]
    wrrat: jnp.ndarray     # wood-to-nonwood ratio
    wdpool: jnp.ndarray    # wood pool switch (0/1)
    tdlef: jnp.ndarray     # leaf freezing temperature [K]
    # photosynthesis / stomata (PHOTO table)
    c3c4: jnp.ndarray      # pathway: 1 C3, 2 C4 (int)
    rgl: jnp.ndarray       # Jarvis radiation stress parameter
    hs: jnp.ndarray        # Jarvis VPD parameter
    kc25: jnp.ndarray      # CO2 Michaelis-Menten at 25C [Pa]
    akc: jnp.ndarray       # Q10 for kc25
    ko25: jnp.ndarray      # O2 Michaelis-Menten at 25C [Pa]
    ako: jnp.ndarray       # Q10 for ko25
    vcmx25: jnp.ndarray    # max carboxylation at 25C [umol m-2 s-1]
    avcmx: jnp.ndarray     # Q10 for vcmx25
    bp: jnp.ndarray        # minimum leaf conductance [umol m-2 s-1]
    rsmax: jnp.ndarray     # maximum stomatal resistance [s m-1]
    rsmin: jnp.ndarray     # minimum canopy resistance [s m-1]
    mp: jnp.ndarray        # conductance-photosynthesis slope
    qe25: jnp.ndarray      # quantum efficiency at 25C
    aqe: jnp.ndarray       # Q10 for qe25
    rmf25: jnp.ndarray     # leaf maintenance respiration at 25C
    rms25: jnp.ndarray     # stem maintenance respiration at 25C
    rmr25: jnp.ndarray     # root maintenance respiration at 25C
    folnmx: jnp.ndarray    # foliage N concentration at f(N)=1 [%]
    topt: jnp.ndarray      # optimum transpiration temperature [K]
    tmin: jnp.ndarray      # min photosynthesis temperature [K]
    arm: jnp.ndarray       # Q10 for maintenance respiration
    mrp: jnp.ndarray       # microbial respiration parameter
    # VOC table
    slarea: jnp.ndarray
    eps: jnp.ndarray       # (n, 5)


class SoilParams(NamedTuple):
    """Soil hydraulic/thermal parameters indexed by 1-based soil type,
    plus albedos indexed by 1-based soil color class."""
    bexp: jnp.ndarray      # Clapp-Hornberger B
    smcmax: jnp.ndarray    # porosity [m3 m-3]
    smcref: jnp.ndarray    # field capacity [m3 m-3]
    smcwlt: jnp.ndarray    # wilting point [m3 m-3]
    psisat: jnp.ndarray    # saturated matric potential [m]
    dksat: jnp.ndarray     # saturated hydraulic conductivity [m s-1]
    dwsat: jnp.ndarray     # saturated hydraulic diffusivity [m2 s-1]
    quartz: jnp.ndarray    # quartz content
    kdt: jnp.ndarray       # derived infiltration parameter
    frzx: jnp.ndarray      # derived frozen-soil parameter
    albsat: jnp.ndarray    # (ncolor, 2) saturated soil albedo vis/nir
    albdry: jnp.ndarray    # (ncolor, 2) dry soil albedo vis/nir


class GenParams(NamedTuple):
    """General scalar parameters + slope table (GENPARMMP.TBL)."""
    slope: jnp.ndarray     # slope index by 1-based slope type
    csoil: jnp.ndarray     # soil volumetric heat capacity [J m-3 K-1]
    zbot: jnp.ndarray      # depth of soil temperature lower BC [m]
    czil: jnp.ndarray      # Zilitinkevich coefficient
    dkref: jnp.ndarray     # reference DKSAT for KDT scaling
    kdtref: jnp.ndarray    # reference KDT
    frzk: jnp.ndarray      # frozen-ground infiltration parameter
    timean: jnp.ndarray    # grid-mean topographic index
    fsatmax: jnp.ndarray   # max saturated fraction
    mltfct: jnp.ndarray    # snowmelt factor for snow-cover fraction
    z0sno: jnp.ndarray     # snow roughness length [m]
    ssi: jnp.ndarray       # irreducible snow liquid saturation
    swemax: jnp.ndarray    # fresh snow to refresh albedo [mm]
    albice: jnp.ndarray    # (2,) land-ice albedo vis/nir
    alblake: jnp.ndarray   # (2,) lake albedo vis/nir
    omegas: jnp.ndarray    # (2,) two-stream snow omega vis/nir
    betads: jnp.ndarray    # two-stream direct-beam snow parameter
    betais: jnp.ndarray    # two-stream diffuse snow parameter
    emssoil: jnp.ndarray   # soil emissivity
    emslake: jnp.ndarray   # lake emissivity


class Params(NamedTuple):
    veg: VegParams
    soil: SoilParams
    gen: GenParams


def _pad0(a: np.ndarray) -> np.ndarray:
    """Prepend a zero row so 1-based class indices index directly.

    Tables stay host-side (numpy): one device_put of the whole tree
    (load_params) replaces an eager transfer per array.
    """
    pad = np.zeros((1,) + a.shape[1:], dtype=a.dtype)
    return np.concatenate([pad, a], axis=0)


def load_veg_params(tag: str, tbl_dir: str = DATA_DIR) -> VegParams:
    sec = reader.parse_sections(os.path.join(tbl_dir, "VEGPARMMP.TBL"))

    def scalar_i(name):
        return np.int32(int(reader.read_scalar(sec, f"{name}#{tag}")))

    rad = reader.read_table(sec, f"RAD#{tag}", 9)
    lai = reader.read_table(sec, f"LAI12M#{tag}", 12)
    sai = reader.read_table(sec, f"SAI12M#{tag}", 12)
    dveg = reader.read_table(sec, f"DVEG#{tag}", 8)
    phys = reader.read_table(sec, f"PHYS#{tag}", 9)
    photo = reader.read_table(sec, f"PHOTO#{tag}", 23)
    voc = reader.read_table(sec, f"VOC#{tag}", 6)

    return VegParams(
        isurban=scalar_i("ISURBAN"), iswater=scalar_i("ISWATER"),
        isbarren=scalar_i("ISBARREN"), isice=scalar_i("ISICE"),
        isegblf=scalar_i("ISEGBLF"),
        xl=_pad0(rad[:, 0]),
        rhol=_pad0(rad[:, 1:3]), rhos=_pad0(rad[:, 3:5]),
        taul=_pad0(rad[:, 5:7]), taus=_pad0(rad[:, 7:9]),
        lai12m=_pad0(lai), sai12m=_pad0(sai),
        nroot=_pad0(phys[:, 0].astype(np.int32)),
        canwmxp=_pad0(phys[:, 1]), dleaf=_pad0(phys[:, 2]),
        z0mvt=_pad0(phys[:, 3]), hvt=_pad0(phys[:, 4]),
        hvb=_pad0(phys[:, 5]), den=_pad0(phys[:, 6]),
        rcrown=_pad0(phys[:, 7]), cwpvt=_pad0(phys[:, 8]),
        sla=_pad0(dveg[:, 0]), dilefc=_pad0(dveg[:, 1]),
        dilefw=_pad0(dveg[:, 2]), fragr=_pad0(dveg[:, 3]),
        ltovrc=_pad0(dveg[:, 4]), wrrat=_pad0(dveg[:, 5]),
        wdpool=_pad0(dveg[:, 6]), tdlef=_pad0(dveg[:, 7]),
        c3c4=_pad0(photo[:, 0].astype(np.int32)),
        rgl=_pad0(photo[:, 1]), hs=_pad0(photo[:, 2]),
        kc25=_pad0(photo[:, 3]), akc=_pad0(photo[:, 4]),
        ko25=_pad0(photo[:, 5]), ako=_pad0(photo[:, 6]),
        vcmx25=_pad0(photo[:, 7]), avcmx=_pad0(photo[:, 8]),
        bp=_pad0(photo[:, 9]), rsmax=_pad0(photo[:, 10]),
        rsmin=_pad0(photo[:, 11]), mp=_pad0(photo[:, 12]),
        qe25=_pad0(photo[:, 13]), aqe=_pad0(photo[:, 14]),
        rmf25=_pad0(photo[:, 15]), rms25=_pad0(photo[:, 16]),
        rmr25=_pad0(photo[:, 17]), folnmx=_pad0(photo[:, 18]),
        topt=_pad0(photo[:, 19]), tmin=_pad0(photo[:, 20]),
        arm=_pad0(photo[:, 21]), mrp=_pad0(photo[:, 22]),
        slarea=_pad0(voc[:, 0]), eps=_pad0(voc[:, 1:6]),
    )


def load_soil_params(tag: str, gen: GenParams,
                     tbl_dir: str = DATA_DIR,
                     frzx_compat: bool = True) -> SoilParams:
    """Load soil tables.

    ``frzx_compat=True`` reproduces the reference's FRZX expression
    ``0.412 / 0468`` (core/module_noahmp_soil_param.f90:60) where the
    Fortran literal ``0468`` is the *integer* 468, i.e. a factor of
    0.412/468 rather than the intended 0.412/0.468.  Pass False to use
    the corrected classic-Noah value.
    """
    sec = reader.parse_sections(os.path.join(tbl_dir, "SOILPARMMP.TBL"))
    parm = reader.read_table(sec, f"PARM#{tag}", 8)
    color = reader.read_table(sec, "COLOR", 4)

    dksat = parm[:, 5]
    smcmax = parm[:, 1]
    smcref = parm[:, 2]
    kdt = np.asarray(gen.kdtref) * dksat / np.asarray(gen.dkref)
    factor = 0.412 / 468.0 if frzx_compat else 0.412 / 0.468
    with np.errstate(divide="ignore", invalid="ignore"):
        frzx = np.where(smcref > 0.0,
                        np.asarray(gen.frzk) * (smcmax / smcref) * factor,
                        np.nan).astype(np.float32)

    return SoilParams(
        bexp=_pad0(parm[:, 0]), smcmax=_pad0(smcmax),
        smcref=_pad0(smcref), smcwlt=_pad0(parm[:, 3]),
        psisat=_pad0(parm[:, 4]), dksat=_pad0(dksat),
        dwsat=_pad0(parm[:, 6]), quartz=_pad0(parm[:, 7]),
        kdt=_pad0(kdt.astype(np.float32)), frzx=_pad0(frzx),
        albsat=_pad0(color[:, 0:2]), albdry=_pad0(color[:, 2:4]),
    )


def load_gen_params(tbl_dir: str = DATA_DIR) -> GenParams:
    sec = reader.parse_sections(os.path.join(tbl_dir, "GENPARMMP.TBL"))
    slope = reader.read_table(sec, "SLOPE", 1)[:, 0]

    def s(name):
        return np.float32(reader.read_scalar(sec, name))

    def v(name):
        return np.asarray(reader.read_vector(sec, name), np.float32)

    return GenParams(
        slope=_pad0(slope),
        csoil=s("CSOIL"), zbot=s("ZBOT"), czil=s("CZIL"),
        dkref=s("DKREF"), kdtref=s("KDTREF"), frzk=s("FRZK"),
        timean=s("TIMEAN"), fsatmax=s("FSATMAX"), mltfct=s("MLTFCT"),
        z0sno=s("Z0SNO"), ssi=s("SSI"), swemax=s("SWEMAX"),
        albice=v("ALBICE"), alblake=v("ALBLAKE"), omegas=v("OMEGAS"),
        betads=s("BETADS"), betais=s("BETAIS"),
        emssoil=s("EMSSOIL"), emslake=s("EMSLAKE"),
    )


def load_params(veg_scheme: str = "USGS", soil_scheme: str = "STAS",
                tbl_dir: str = DATA_DIR,
                frzx_compat: bool = True,
                to_device: bool = True) -> Params:
    """Load all parameter tables.  ``to_device=False`` returns host
    numpy leaves and never initializes a JAX backend (for table
    inspection / host-only tooling)."""
    gen = load_gen_params(tbl_dir)
    params = Params(
        veg=load_veg_params(veg_scheme, tbl_dir),
        soil=load_soil_params(soil_scheme, gen, tbl_dir, frzx_compat),
        gen=gen,
    )
    if not to_device:
        return params
    # One device_put for the whole tree: pure transfers, no per-leaf
    # eager compiles.  Device-resident params are then passed as
    # explicit jit arguments by make_step (never closed over: closure
    # constants force a device->host fetch at lowering time — see
    # driver/step.py).
    import jax
    return jax.device_put(params)
