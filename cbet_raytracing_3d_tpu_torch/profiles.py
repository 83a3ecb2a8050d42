"""Radial plasma profile loading.

Counterpart of ``cbet_raytracing_3d_tpu/profiles.py``.  The data files are
read in place from the JAX package's ``data/`` directory.

The reference reads two whitespace-separated ``r value`` text files
(``main.cu:246-260``): electron temperature [eV] and electron density [cm^-3]
as functions of radius [cm].  Both files share the radius column; the reference
reads ``r`` twice and the second read (the ne file) wins (``main.cu:252,257``).
Only the first ``nr=443`` rows are read; the files have 444 (``def.cuh:33``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "cbet_raytracing_3d_tpu", "data")
DEFAULT_NE_FILE = os.path.join(DATA_DIR, "s83177_wCBET_t301_1p5ns_ne.txt")
DEFAULT_TE_FILE = os.path.join(DATA_DIR, "s83177_wCBET_t301_1p5ns_te.txt")


@dataclasses.dataclass(frozen=True)
class RadialProfiles:
    """1-D radial profiles: r [cm], ne [cm^-3], te [eV].  float64 numpy."""

    r: np.ndarray
    ne: np.ndarray
    te: np.ndarray

    def __post_init__(self):
        if not (self.r.shape == self.ne.shape == self.te.shape
                and self.r.ndim == 1):
            raise ValueError("profiles must be 1-D arrays of one length")


def load_profiles(ne_file: str = DEFAULT_NE_FILE,
                  te_file: str = DEFAULT_TE_FILE,
                  nr: int = 443) -> RadialProfiles:
    """Load the radial ne/te profiles, first ``nr`` rows of each file.

    Matches the reference's read order: te first, then ne whose radius column
    overwrites (main.cu:249-260) — hence ``r`` comes from the ne file.
    """
    from .utils.native import parse_profile
    _, te = parse_profile(te_file, nr)
    r, ne = parse_profile(ne_file, nr)
    return RadialProfiles(r=r, ne=ne, te=te)
