"""cbet_raytracing_3d_tpu_torch — the PyTorch/CUDA port of
``cbet_raytracing_3d_tpu``: 3-D laser ray tracing with inverse-bremsstrahlung
absorption and trilinear energy deposition in spherically symmetric ICF
plasmas, on an NVIDIA GPU.

The JAX package stays the reference: module names mirror it, and the tests
hold every module of the port against its counterpart.  This package
imports torch and numpy, never jax.  Its kernels (the deposits, the CBET gain
reduction and the window-gain deposit, ``csrc/*.cu``) are CUDA C++ for
Hopper, built by ``nvcc`` at first use.
"""

from .config import Config, small_test_config
from .profiles import load_profiles, RadialProfiles
from .beams import load_beam_norms, power_table, init_rays
from .fields import build_fields, Fields
from .models.cbet import cbet_solve, CbetResult

__version__ = "0.1.0"

__all__ = [
    "Config", "small_test_config", "load_profiles", "RadialProfiles",
    "load_beam_norms", "power_table", "init_rays", "build_fields", "Fields",
    "cbet_solve", "CbetResult", "__version__",
]
