"""Physical constants for the NoahMP-JAX land surface model.

Values match the reference model's constant set
(reference: core/module_noahmp_const.f90:14-35) so that prognostic
trajectories are comparable.  All floats are Python floats; inside jitted
code they are weakly typed and adopt the computation dtype (float32 by
default).
"""

MPE = 1.0e-6       # epsilon guarding divisions by zero

GRAV = 9.80616     # gravitational acceleration [m s-2]
SB = 5.67e-8       # Stefan-Boltzmann constant [W m-2 K-4]
RGAS = 8.3144598   # universal gas constant [J K-1 mol-1]
KARMAN = 0.40      # von Karman constant
TFRZ = 273.15      # freezing/melting point [K]
TTRI = 273.16      # triple point of water [K]
HSUB = 2.8440e6    # latent heat of sublimation [J kg-1]
HVAP = 2.5104e6    # latent heat of vaporization [J kg-1]
HFUS = 0.3336e6    # latent heat of fusion [J kg-1]
CWAT = 4.188e6     # volumetric heat capacity of water [J m-3 K-1]
CICE = 2.094e6     # volumetric heat capacity of ice [J m-3 K-1]
CPAIR = 1004.64    # heat capacity of dry air at const pressure [J kg-1 K-1]
TKWAT = 0.6        # thermal conductivity of water [W m-1 K-1]
TKICE = 2.2        # thermal conductivity of ice [W m-1 K-1]
TKAIR = 0.023      # thermal conductivity of air [W m-1 K-1]
RAIR = 287.04      # gas constant for dry air [J kg-1 K-1]
RVAP = 461.269     # gas constant for water vapor [J kg-1 K-1]
DENWAT = 1000.0    # density of water [kg m-3]
DENICE = 917.0     # density of ice [kg m-3]

# Model dimensions (reference: core/module_noahmp_global.f90:9-13).
NBAND = 2          # solar radiation bands: 0=vis, 1=nir
NSOIL = 4          # number of soil layers
MSNOW = 3          # maximum number of snow layers
NLEVELS = MSNOW + NSOIL  # total snow+soil column slots
