"""Physical constants and derived quantities for the CBET ray tracer.

Counterpart of ``cbet_raytracing_3d_tpu/constants.py`` (a copy: the values
must match bit for bit).  They mirror the physics-constant contract of the
reference mini-app (``def.cuh:60-114``) as plain Python floats evaluated at
import time.  All values are CGS unless noted.
"""

import math

# --- fundamental constants (def.cuh:60-64, 98, 108-109) ---
C_CMS = 29979245800.0          # speed of light [cm/s]
E0 = 8.85418782e-12            # vacuum permittivity [m^-3 kg^-1 s^4 A^2]
ME_KG = 9.10938356e-31         # electron mass [kg]
EC = 1.60217662e-19            # electron charge [C]
ESTAT = 4.80320427e-10         # electron charge [statC]
KB_ERG = 1.3806485279e-16      # Boltzmann constant [erg/K]
KB_J = 1.3806485279e-23        # Boltzmann constant [J/K]

# --- laser light (def.cuh:66-69): frequency-tripled "3w" UV light ---
LAMBDA_CM = 1.053e-4 / 3.0     # wavelength [cm]
FREQ = C_CMS / LAMBDA_CM       # frequency [Hz]
OMEGA = 2.0 * math.pi * FREQ   # angular frequency [rad/s]
# critical density [cm^-3]: omega == omega_pe
NCRIT = 1e-6 * OMEGA * OMEGA * ME_KG * E0 / (EC * EC)

# --- plasma / ion-acoustic constants for the CBET stage (def.cuh:99-114) ---
MACH = -1.0 * math.sqrt(2.0)   # Mach number for max resonance
Z_ION = 3.1                    # ionization state
MI_G = 10230.0 * (1.0e3 * ME_KG)    # ion mass [g]
MI_KG = 10230.0 * ME_KG             # ion mass [kg]
TE_K = 2.0e3 * 11604.5052      # electron temperature [K]
TE_EV = 2.0e3
TI_K = 1.0e3 * 11604.5052      # ion temperature [K]
TI_EV = 1.0e3
IAW = 0.2                      # ion-acoustic wave energy-damping rate (nu_ia/omega_s)

# CBET gain prefactor (def.cuh:111)
CONSTANT1 = (ESTAT ** 2) / (
    4.0 * (1.0e3 * ME_KG) * C_CMS * OMEGA * KB_ERG * TE_K * (1.0 + 3.0 * TI_K / (Z_ION * TE_K))
)

# ion-acoustic (sound) speed [cm/s] (def.cuh:113), approx 4e7 cm/s here
CS = 1e2 * math.sqrt(EC * (Z_ION * TE_EV + 3.0 * TI_EV) / MI_KG)

# --- absorption model constants (launch_ray_XZ.cu:299-300) ---
# eta = ETA_COEF * ETA_Z_FACTOR / Te^{3/2}; the reference hard-codes 10.0
# rather than Z=3.1 (launch_ray_XZ.cu:299) -- kept as a named constant so the
# quirk is explicit and overridable.
ETA_COEF = 5.2e-5
ETA_Z_FACTOR = 10.0
