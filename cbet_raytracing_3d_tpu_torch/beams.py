"""OMEGA beam geometry and ray initialization.

Counterpart of ``cbet_raytracing_3d_tpu/beams.py`` (float64 NumPy, the same
formulas); the beam table is read in place from the JAX package's data.

Covers the reference's beam table (``omega_beams.h``), super-Gaussian beam
power profile (``main.cu:102-110``), and per-ray launch initialization
(``launch_ray_XZ.cu:65-115``): zone-blocked ray permutation, launch lattice
position, circular pupil mask, focal-plane placement, and the two Euler
rotations onto the beam axis.

Ray initialization is a one-time host-side setup step (the reference's "Init"
phase), so it is done in NumPy float64 in closed form — the reference builds
the same lattice by repeated addition purely for bit-compatibility with a CPU
ancestor (comments at ``launch_ray_XZ.cu:81-82,90-91``); the closed form is the
reference's own stated intent.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .config import Config
from .ops.interp import uniform_interp
from .profiles import DATA_DIR

DEFAULT_BEAMS_FILE = os.path.join(DATA_DIR, "omega_beams.txt")


def load_beam_norms(path: str = DEFAULT_BEAMS_FILE, nbeams: int | None = None) -> np.ndarray:
    """Load the beam port unit direction vectors, shape (nbeams, 3)."""
    arr = np.loadtxt(path, dtype=np.float64)
    arr = np.atleast_2d(arr)
    if nbeams is not None:
        if nbeams > arr.shape[0]:
            raise ValueError(
                f"requested {nbeams} beams but the beam table at {path} "
                f"has only {arr.shape[0]} ports")
        arr = arr[:nbeams]
    return np.ascontiguousarray(arr)


def power_table(cfg: Config) -> np.ndarray:
    """Super-Gaussian (order 5) beam power vs pupil radius (main.cu:102-110).

    ``pow_r[i] = exp(-((phase_r[i]/sigma)^2)^{5/2})`` over
    ``phase_r = linspace(0, pow_table_max, pow_table_len)``.
    """
    phase_r = np.linspace(0.0, cfg.pow_table_max, cfg.pow_table_len)
    return np.exp(-1.0 * ((phase_r / cfg.sigma) ** 2) ** 2.5)


def ray_permutation(cfg: Config, pre_raynum: np.ndarray) -> np.ndarray:
    """Zone-blocked thread-index -> lattice-site permutation
    (launch_ray_XZ.cu:69-74)."""
    rpz = cfg.rays_per_zone
    zones = cfg.zones_spanned
    b1 = pre_raynum // (rpz * rpz)
    b2 = pre_raynum % (rpz * rpz)
    ry = (b1 // zones) * rpz + b2 // rpz
    rx = (b1 % zones) * rpz + b2 % rpz
    return ry * cfg.nrays_x + rx


def lattice_xy(cfg: Config, rx, ry):
    """Focal-plane launch position from lattice coordinates
    (launch_ray_XZ.cu:76-97) — THE single definition of the lattice
    formula, including the reference's beam_min_x-for-y quirk."""
    span = cfg.beam_max_x - cfg.beam_min_x
    x0 = rx * (span / (cfg.nrays_x - 1)) + cfg.beam_min_x + cfg.dx / 2
    y0 = ry * (span / (cfg.nrays_y - 1)) + cfg.beam_min_x + cfg.dy / 2
    return x0, y0


@dataclasses.dataclass(frozen=True)
class RayInit:
    """Initial per-ray launch state for all beams, ordered by (beam, thread id).

    Shapes: pos (nbeams, nrays, 3); uray, mask (nbeams, nrays).  float64.
    ``mask`` combines the circular pupil (launch_ray_XZ.cu:114) and — in
    ``parity="reference"`` mode — the launch-grid ray truncation (main.cu:161).
    """

    pos: np.ndarray
    uray: np.ndarray
    mask: np.ndarray


def site_launch(cfg: Config, pow_r: np.ndarray):
    """Per thread id ``k`` of a beam (the same for every beam): the launch
    lattice position ``(x0, y0)``, the launch energy and the launch mask
    (the circular pupil, launch_ray_XZ.cu:114, and in ``parity=
    "reference"`` mode the launch-grid truncation, main.cu:161)."""
    k_idx = np.arange(cfg.nrays, dtype=np.int64)
    raynum = ray_permutation(cfg, k_idx)

    # Launch lattice in the focal plane (launch_ray_XZ.cu:76-97).
    x0, y0 = lattice_xy(cfg, raynum % cfg.nrays_x, raynum // cfg.nrays_x)
    ref = np.sqrt(x0 * x0 + y0 * y0)

    # Initial ray energy from the super-Gaussian pupil profile
    # (launch_ray_XZ.cu:113); the power table is uniformly spaced so the
    # interpolation is direct index arithmetic (ops/interp.uniform_interp).
    step = cfg.pow_table_max / (cfg.pow_table_len - 1)
    uray1 = cfg.uray_mult * uniform_interp(pow_r, 0.0, step, ref)

    mask1 = ref <= cfg.beam_max_x
    if cfg.parity == "reference":
        mask1 &= k_idx < cfg.traced_rays_per_beam
    return x0, y0, uray1, mask1


def init_rays(cfg: Config, beam_norm: np.ndarray, pow_r: np.ndarray) -> RayInit:
    x0, y0, uray1, mask1 = site_launch(cfg, pow_r)
    z0 = np.full_like(x0, cfg.focal_length - cfg.dz / 2)

    # Per-beam Euler rotations (launch_ray_XZ.cu:99-111).
    nb = beam_norm.shape[0]
    theta1 = np.arccos(beam_norm[:, 2])
    theta2 = np.arctan2(beam_norm[:, 1] * cfg.focal_length,
                        cfg.focal_length * beam_norm[:, 0])
    c1, s1 = np.cos(theta1), np.sin(theta1)
    c2, s2 = np.cos(theta2), np.sin(theta2)

    # first rotation (about y): x' = x c1 + z s1 ; z' = z c1 - x s1
    xa = x0[None, :] * c1[:, None] + z0[None, :] * s1[:, None]
    za = z0[None, :] * c1[:, None] - x0[None, :] * s1[:, None]
    ya = np.broadcast_to(y0[None, :], (nb, cfg.nrays))
    # second rotation (about z): x'' = x' c2 - y s2 ; y'' = y c2 + x' s2
    xb = xa * c2[:, None] - ya * s2[:, None]
    yb = ya * c2[:, None] + xa * s2[:, None]

    pos = np.stack([xb, yb, np.broadcast_to(za, xb.shape)], axis=-1)
    uray = np.broadcast_to(uray1[None, :], (nb, cfg.nrays)).copy()
    mask = np.broadcast_to(mask1[None, :], (nb, cfg.nrays)).copy()
    return RayInit(pos=np.ascontiguousarray(pos), uray=uray, mask=mask)
