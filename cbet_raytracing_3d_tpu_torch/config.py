"""Runtime configuration of the PyTorch port.

Counterpart of ``cbet_raytracing_3d_tpu/config.py``: the same fields, the
same defaults and the same derived-quantity formulas (``def.cuh:25-131``), so
a config round-trips between the two packages field by field.  A frozen
dataclass keeps configs hashable.

Two behavioral modes:

* ``parity="clean"`` (default): all ``nrays`` rays per beam are traced.
* ``parity="reference"``: reproduces the reference's silent truncation of
  rays — the CUDA launch grid uses ``threads_per_beam // threads_per_block``
  blocks, dropping ``nrays % 256`` (=144) rays per beam
  (``main.cu:161``, ``def.cuh:127-129``).

Knobs of the TPU kernels and of paths the port does not run yet are kept so
configs round-trip; the port does not read them (each says why).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

from . import constants as k


@dataclasses.dataclass(frozen=True)
class Config:
    # --- grid (def.cuh:33-53) ---
    nx: int = 100
    ny: int = 100
    nz: int = 100
    xmin: float = -0.13
    xmax: float = 0.13
    ymin: float = -0.13
    ymax: float = 0.13
    zmin: float = -0.13
    zmax: float = 0.13
    nr: int = 443                     # radial profile table length (def.cuh:33)

    # --- beams / rays (def.cuh:55-58, 71-78, 89-92, 119) ---
    nbeams: int = 60
    beam_min_x: float = -450.0e-4
    beam_max_x: float = 450.0e-4
    rays_per_zone: int = 4
    sigma: float = 0.0375             # super-Gaussian width of beam power
    intensity: float = 1.0e14         # beam intensity [W/cm^2]
    focal_length: float = 0.1
    offset: float = 0.5e-4            # unused by the reference kernel; kept for parity

    # --- time stepping (def.cuh:80-87) ---
    courant_mult: float = 0.5

    # --- physics toggles (def.cuh:118; launch_ray_XZ.cu:299-311) ---
    absorption: bool = True
    # The reference hard-codes 10.0 in eta instead of Z=3.1
    # (launch_ray_XZ.cu:299 vs def.cuh:100); override here if desired.
    eta_z_factor: float = k.ETA_Z_FACTOR
    # termination threshold: ray stops below this fraction of initial energy
    # (launch_ray_XZ.cu:351)
    stop_fraction: float = 0.05
    # cell-search tolerance "half" (launch_ray_XZ.cu:132, 164)
    cell_tol: float = 0.5001

    # --- power-profile table (main.cu:102-110) ---
    pow_table_len: int = 2001
    pow_table_max: float = 0.1

    # --- CBET stage (def.cuh:94-114; models/cbet.py) ---
    cbet_max_iters: int = 30
    cbet_tol: float = 5e-3
    cbet_relax: float = 0.9
    # "anderson": Anderson(m=1) mixing of the fixed-point iterates (opt-in)
    cbet_accel: Literal["none", "anderson"] = "none"
    machnum: float = k.MACH           # flow Mach number (def.cuh:99)
    ncrossings_mult: int = 3          # ncrossings = mult*nx (def.cuh:96)
    # 1, or deposit_batch_steps: one gain lookup per deposit window at the
    # window-entry cell (another model; needs the batched lookup)
    cbet_gain_stride: int = 1
    # "lookup" and "kernel_cell" (the same model); "kernel" (the trilinear
    # window model, another model, opt-in)
    cbet_gain_mode: Literal["lookup", "kernel", "kernel_cell"] = "lookup"
    # not read: TPU gather-layout choices of the lookup with identical
    # values (per-beam row slices, value-duplicated 2-wide rows)
    cbet_gain_sliced: bool = True
    cbet_gain_rows2: bool | None = None
    # not read: the mesh's beam-sharded gain table (ROADMAP M11)
    cbet_gain_sharded: bool | None = None
    # True: the fixed-point iterations skip the edep deposit and one full
    # trace follows (needs the batched path); None (auto) and False: off
    cbet_light_iterations: bool | None = None
    cbet_seed_zero_gain: bool = True
    # True: each CBET trace drops dead tiles at chunk boundaries, per beam
    # (models/tileplan.py); the values do not change
    cbet_segmented: bool = False
    # accepted and reported (stats["plan_headroom"]) as in the JAX package,
    # and inert: the port's compaction reads the trace's own alive mask,
    # exact at any headroom, where the JAX package plans liveness ahead
    cbet_plan_headroom: float = 0.0
    cbet_grid_downsample: int = 1

    # --- execution ---
    parity: Literal["clean", "reference"] = "clean"
    dtype: Literal["float32", "float64"] = "float32"
    edep_dtype: Literal["float32", "float64"] = "float64"
    chunk_steps: int = 25             # chunk length for f32 -> f64 promotion
    # deposition backend: "cuda" (the hand-written kernel, csrc/deposit.cu;
    # raises without CUDA tensors), "torch" (the plain index_add_ version,
    # CPU tensors only), or "auto" (the kernel for CUDA tensors, the plain
    # version for CPU tensors)
    deposit_backend: Literal["auto", "cuda", "torch"] = "auto"
    # launch-tile edge in zones (4 -> 256 rays/tile): rays are ordered by
    # tile so neighbouring deposit threads hit nearby grid nodes
    tile_zones: int = 4
    # Knobs of the TPU deposit kernel (box edges, boundary mode, tiles per
    # grid step).  Kept so configs round-trip; the port does not read them:
    # its kernels accumulate with atomics in the whole grid and are exact on
    # boundary exit rows.  tiles_per_block is read only as the padding of
    # the slot layouts (build_tile_layout, models/cbet.live_tile_slots), so
    # slots match the JAX package's one for one; deposit_batch_steps
    # is the window of every trace: the plain trace and the CBET lookup
    # deposit once per window where it divides the chunk lengths (else every
    # step), and the kernel gain modes need it to.
    deposit_box_x: int = 32
    deposit_box_y: int = 32
    deposit_box_z: int = 32
    deposit_boundary_exact: bool = False
    tiles_per_block: int = 16
    deposit_batch_steps: int = 5

    @property
    def deposit_box(self) -> tuple:
        return (self.deposit_box_x, self.deposit_box_y, self.deposit_box_z)

    # ===== derived quantities (formulas identical to def.cuh) =====
    @property
    def dx(self) -> float:
        return (self.xmax - self.xmin) / (self.nx - 1)

    @property
    def dy(self) -> float:
        return (self.ymax - self.ymin) / (self.ny - 1)

    @property
    def dz(self) -> float:
        return (self.zmax - self.zmin) / (self.nz - 1)

    @property
    def nrays_x(self) -> int:
        # def.cuh:75
        return int(self.rays_per_zone * math.ceil((self.beam_max_x - self.beam_min_x) / self.dx))

    @property
    def nrays_y(self) -> int:
        # def.cuh:76
        return int(self.rays_per_zone * math.ceil((self.beam_max_x - self.beam_min_x) / self.dy))

    @property
    def nrays(self) -> int:
        return self.nrays_x * self.nrays_y

    @property
    def zones_spanned(self) -> int:
        # launch_ray_XZ.cu:69
        return int(math.ceil((self.beam_max_x - self.beam_min_x) / self.dx))

    @property
    def dt(self) -> float:
        # def.cuh:81
        return self.courant_mult * min(self.dx, self.dz) / k.C_CMS

    @property
    def nt(self) -> int:
        # def.cuh:83-87
        return int((1.0 / self.courant_mult) * max(self.nx, self.nz) * 2.0)

    @property
    def uray_mult(self) -> float:
        # def.cuh:92
        return self.intensity * self.courant_mult / float(self.rays_per_zone ** 2)

    @property
    def ncrossings(self) -> int:
        # def.cuh:96
        return self.ncrossings_mult * self.nx

    @property
    def numstored(self) -> int:
        # per-cell crossing capacity contract (def.cuh:94)
        return 5 * self.rays_per_zone

    @property
    def traced_rays_per_beam(self) -> int:
        """Rays actually traced per beam.

        ``parity="reference"`` reproduces the launch-grid truncation: only
        ``(nrays // 256) * 256`` threads are launched per beam
        (main.cu:161, def.cuh:127-129).
        """
        if self.parity == "reference":
            return (self.nrays // 256) * 256
        return self.nrays

    @property
    def grad_const(self) -> float:
        # main.cu:156
        return (k.C_CMS ** 2) / (2.0 * k.NCRIT) * self.dt * 0.5

    @property
    def dedx_const(self) -> float:
        return self.grad_const / self.dx

    @property
    def dedy_const(self) -> float:
        return self.grad_const / self.dy

    @property
    def dedz_const(self) -> float:
        return self.grad_const / self.dz

    @property
    def cbet_grid_shape(self) -> tuple:
        """Node counts of the (possibly coarsened) CBET intensity/gain grid:
        ceil(n/s) nodes cover full-grid node indices 0, s, ..., exactly the
        stride-``s`` subsample of the full node grid."""
        s = self.cbet_grid_downsample
        return (-(-self.nx // s), -(-self.ny // s), -(-self.nz // s))

    @property
    def edep_shape(self) -> tuple:
        # node-centered grid with one ghost layer per side (def.cuh:131)
        return (self.nx + 2, self.ny + 2, self.nz + 2)

    @property
    def total_rays(self) -> int:
        return self.nbeams * self.nrays

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def small_test_config(**kw) -> Config:
    """A shrunken config for fast tests: one beam, few rays, coarse grid."""
    defaults = dict(nbeams=1, rays_per_zone=1, nx=40, ny=40, nz=40, dtype="float64")
    defaults.update(kw)
    return Config(**defaults)
