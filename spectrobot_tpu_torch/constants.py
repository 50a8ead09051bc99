"""Physical constants and unit conventions for spectrobot_tpu.

Unit conventions used throughout the framework
----------------------------------------------
* Spectroscopy (HITRAN conventions):
    - wavenumber ``nu``                [cm^-1]
    - line strength ``S``              [cm^-1 / (molec cm^-2)]
    - broadening coefficients ``gamma``[cm^-1 / atm]
    - column density ``u``             [molec cm^-2]
    - cross-section ``sigma``          [cm^2 / molec]
* Atmosphere / geometry (SI):
    - altitude, path length            [m]
    - pressure                         [Pa]
    - temperature                      [K]
    - number density                   [molec m^-3]
* Radiance: W / (m^2 sr cm^-1).

Conversions happen exactly once, at the opacity interface
(:mod:`spectrobot_tpu.ops.strengths`): ``u_cm2 = u_m2 * 1e-4`` and
``p_atm = p_Pa / ATM``.

Capability parity: the reference (fedef17/SpectRobot, see SURVEY.md section 1.2
"spect_base_module.py") keeps planet/physics constants in its base module; this
module is the TPU-native equivalent, with CODATA-2018 exact values.
"""

import math

# CODATA 2018 (exact, SI)
C_LIGHT = 2.99792458e8          # speed of light [m/s]
H_PLANCK = 6.62607015e-34       # Planck constant [J s]
K_BOLTZ = 1.380649e-23          # Boltzmann constant [J/K]
N_AVOGADRO = 6.02214076e23      # Avogadro number [1/mol]
AMU = 1.66053906660e-27         # atomic mass unit [kg]
G_NEWTON = 6.67430e-11          # gravitational constant [m^3 kg^-1 s^-2]

ATM = 101325.0                  # standard atmosphere [Pa]
T_REF = 296.0                   # HITRAN reference temperature [K]

# Second radiation constant c2 = h c / k_B, expressed in [cm K] so that
# c2 * nu[cm^-1] / T[K] is dimensionless.
C2 = H_PLANCK * C_LIGHT / K_BOLTZ * 100.0   # = 1.4387768775039337 cm K

# First radiation constant for spectral radiance per wavenumber:
#   B_nu(T) = C1B * nu^3 / (exp(C2 nu / T) - 1)   [W m^-2 sr^-1 (cm^-1)^-1]
# with nu in cm^-1.  C1B = 2 h c^2 * 1e8 (the 1e8 converts (m^-1)^3 per m^-1
# to (cm^-1)^3 per cm^-1).
C1B = 2.0 * H_PLANCK * C_LIGHT ** 2 * 1.0e8  # = 1.1910429723971881e-08

SQRT_LN2 = math.sqrt(math.log(2.0))
LN2 = math.log(2.0)
SQRT_PI = math.sqrt(math.pi)
INV_SQRT_PI = 1.0 / math.sqrt(math.pi)
# sqrt(ln2/pi): prefactor of the area-normalised Voigt profile.
SQRT_LN2_PI = math.sqrt(math.log(2.0) / math.pi)
