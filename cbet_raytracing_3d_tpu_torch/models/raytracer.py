"""The ray-trace integrator in PyTorch.

Counterpart of ``cbet_raytracing_3d_tpu/models/raytracer.py``: the reference's
one-CUDA-thread-per-ray time loop (``launch_ray_XZ.cu:117-359``) as batched
tensor steps over all rays of all beams:

* rays form one flat batch axis ordered by *launch tile* (a patch of adjacent
  launch-lattice sites), so consecutive rays stay spatially coherent through
  the trace — neighbouring deposit threads then hit nearby grid nodes,
* the per-step radial interpolations are one row gather from the
  precomputed ``(P, 4)`` node-field table (``fields.py``; the gradient kick
  is carried one step in the ray state),
* deposition is the CUDA kernel on the card and its plain ``index_add_``
  version on the CPU (``ops/deposit.py``), once per window of
  ``deposit_batch_steps`` steps where the windows divide the chunks
  (:func:`batched`), else once per step,
* early ray termination (the CUDA ``break``, launch_ray_XZ.cu:351-356) is an
  ``alive`` mask with frozen state, and the trace stops at the first chunk
  boundary where no ray is alive; optionally it drops dead tiles there
  (``models/tileplan.py``),
* the initial state is built on the host (``prepare``, float64 NumPy) or on
  the card (``prepare_device``, float64 torch), with equal values.

Every per-ray tensor is 1-D (structure of arrays).  Positions are carried
cell-relative (``cell + frac``), so float32 rounding stays at the scale of
one cell; the deposits accumulate into a grid of the ray dtype for
``chunk_steps`` steps, then promote into a float64 master grid.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .. import constants as k
from ..beams import init_rays, load_beam_norms, power_table, site_launch
from ..config import Config
from ..fields import Fields, build_fields
from ..ops.deposit import deposit, deposit_reference
from ..profiles import RadialProfiles, load_profiles
from .tileplan import TileCompactor

DEPOSIT_BACKENDS = ("auto", "cuda", "torch")


@dataclasses.dataclass
class RayState:
    """Per-ray integrator state: tuples of per-axis 1-D tensors, shape (N,).

    Positions are stored cell-relative (``cell`` + ``frac``) so float32
    rounding stays at the scale of one cell rather than of the whole grid."""

    frac: tuple     # (fx, fy, fz) position relative to the cell node, grid units
    vel: tuple      # (vx, vy, vz) displacement per step, grid units
    kick: tuple     # (kx, ky, kz) gradient kick at the current cell — carried
                    # from the previous step's single row gather (see step fn)
    uray: torch.Tensor       # (N,) ray energy
    uray_init: torch.Tensor  # (N,) launch energy (for the 5% stop rule)
    cell: tuple     # (cx, cy, cz) int32 current cell
    alive: torch.Tensor      # (N,) bool — still stepping

    @property
    def n(self) -> int:
        return self.uray.shape[0]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "RayState":
        """Apply ``fn`` to every tensor of the state."""
        return RayState(
            frac=tuple(fn(a) for a in self.frac),
            vel=tuple(fn(a) for a in self.vel),
            kick=tuple(fn(a) for a in self.kick),
            uray=fn(self.uray), uray_init=fn(self.uray_init),
            cell=tuple(fn(a) for a in self.cell), alive=fn(self.alive))

    def to(self, device) -> "RayState":
        return self.map(lambda a: a.to(device))


def initial_cell(cfg: Config, t: np.ndarray) -> np.ndarray:
    """Closed form of the reference's linear first-match cell scan
    (launch_ray_XZ.cu:162-183): the smallest node index within
    ``0.5001`` cells of the position; 0 if none matches."""
    nvec = (cfg.nx, cfg.ny, cfg.nz)
    tol = cfg.cell_tol
    out = np.zeros(t.shape, np.int32)
    for ax in range(t.shape[1]):
        ta = np.ascontiguousarray(t[:, ax])
        # first integer in [ta - tol, ta + tol] is ceil(ta - tol); the +1
        # candidate covers float rounding where ceil lands one below
        c0 = np.ceil(ta - tol).astype(np.int32)
        oa = out[:, ax]
        for cand in (c0 + 1, c0):       # later write (c0) wins: first match
            ok = (cand >= 0) & (cand <= nvec[ax] - 1)
            ok &= np.abs(cand - ta) <= tol
            np.copyto(oa, cand, where=ok)
    return out


@dataclasses.dataclass(frozen=True)
class TileLayout:
    """Tile-major ray ordering.

    ``slot_of[beam, pre_raynum]`` maps a reference thread id to its slot in
    the flat ray axis; slots not covered by any ray are permanent dead
    padding."""

    rays_per_tile: int
    tiles_per_beam: int
    n_slots: int
    slot_of: np.ndarray       # (nbeams, nrays) int64


def build_tile_layout(cfg: Config) -> TileLayout:
    """The JAX package's layout, including its per-beam tile count padded to
    a ``tiles_per_block`` multiple, so slots match one for one (the padding
    tiles are dead and never traced: see ``live_slots``)."""
    rpz = cfg.rays_per_zone
    zones = cfg.zones_spanned
    tz = cfg.tile_zones
    side = tz * rpz                       # rays per tile edge (16)
    rays_per_tile = side * side           # 256
    ntiles_axis = -(-zones // tz)         # ceil
    tpb = ntiles_axis * ntiles_axis
    tiles_per_beam = -(-tpb // cfg.tiles_per_block) * cfg.tiles_per_block

    kk = np.arange(cfg.nrays, dtype=np.int64)
    b1, b2 = kk // (rpz * rpz), kk % (rpz * rpz)
    zy, zx = b1 // zones, b1 % zones
    ry2, rx2 = b2 // rpz, b2 % rpz
    tx, ty = zx // tz, zy // tz
    lx = (zx % tz) * rpz + rx2
    ly = (zy % tz) * rpz + ry2
    tile = ty * ntiles_axis + tx
    slot_in_beam = tile * rays_per_tile + ly * side + lx
    slot_of = (np.arange(cfg.nbeams, dtype=np.int64)[:, None]
               * tiles_per_beam * rays_per_tile + slot_in_beam[None, :])
    n_slots = cfg.nbeams * tiles_per_beam * rays_per_tile
    return TileLayout(rays_per_tile=rays_per_tile, tiles_per_beam=tiles_per_beam,
                      n_slots=n_slots, slot_of=slot_of)


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Everything needed to run a trace: static config + tensors.

    From :func:`prepare`: ``field4`` and ``state0`` are CPU tensors over the
    full slot layout, which a run subsets (``live_slots``) and uploads once.
    From :func:`prepare_device` (``compact=True``): both already live on the
    device, ``state0`` in the live-tile, per-beam block-padded layout of
    :func:`live_tile_ids`, and ``live_slots`` spans all of it."""

    cfg: Config
    prof: RadialProfiles
    beam_norm: np.ndarray        # (nbeams, 3) float64
    fields: Fields               # float64 node fields
    rays: Any                    # beams.RayInit: float64 launch state (None
                                 # after prepare_device)
    layout: TileLayout
    field4: torch.Tensor         # (P, 4) rows [kick_x, kick_y, kick_z, absorb]
    state0: RayState             # tile-ordered initial state
    beam_id: np.ndarray          # (state0.n,) int32 beam of each slot (-1 padding)
    live_slots: np.ndarray       # slots of tiles with >=1 launched ray;
                                 # the other tiles never contribute
    compact: bool = False        # state0 is already the traced layout


def rays_per_tile(cfg: Config) -> int:
    """Rays of one launch tile: ``(tile_zones * rays_per_zone)^2``."""
    return (cfg.tile_zones * cfg.rays_per_zone) ** 2


def _live_slots_of(mask_slots: np.ndarray, rpt: int) -> np.ndarray:
    tile_live = mask_slots.reshape(-1, rpt).any(axis=1)
    return tile_slots(np.nonzero(tile_live)[0], rpt)


def tile_slots(tiles: np.ndarray, rpt: int) -> np.ndarray:
    """The slots of ``tiles`` (global tile ids), tile by tile."""
    return (np.asarray(tiles, np.int64)[:, None] * rpt
            + np.arange(rpt)[None, :]).reshape(-1)


def live_tile_ids(cfg: Config,
                  layout: TileLayout) -> tuple[np.ndarray, np.ndarray]:
    """Global ids of the tiles with >= 1 pupil-accepted ray, in traced order,
    each beam's padded to a ``tiles_per_block`` multiple with that beam's
    own dead tiles; returns ``(tile_ids int32, tile_valid bool)``
    (``models/raytracer.py:527``).  Every beam then owns the same
    block-aligned tile count, the beam-contiguous layout the grouped CBET
    kernels read by position.  The pupil pattern is beam-independent, so
    this is O(nrays) host work.  THE one definition of the layout: the
    on-card init builds its state in it, and ``models.cbet.live_tile_slots``
    selects the host state's slots by it."""
    rpz, zones, tz = cfg.rays_per_zone, cfg.zones_spanned, cfg.tile_zones
    ntiles_axis = -(-zones // tz)
    kk = np.arange(cfg.nrays, dtype=np.int64)
    ok = site_launch(cfg, power_table(cfg))[3]
    zx = kk // (rpz * rpz) % zones
    zy = kk // (rpz * rpz) // zones
    tile = (zy // tz) * ntiles_axis + (zx // tz)
    live_pattern = np.zeros(layout.tiles_per_beam, bool)
    np.logical_or.at(live_pattern, tile, ok)
    live = np.nonzero(live_pattern)[0]
    dead = np.nonzero(~live_pattern)[0]
    pad = (-len(live)) % cfg.tiles_per_block
    # too few dead tiles: repeat one (its rays are masked by tile_valid)
    fill = dead[:pad] if len(dead) >= pad else np.repeat(
        (dead[:1] if len(dead) else live[:1]), pad)
    per_beam = np.concatenate([live, fill])
    valid1 = np.zeros(len(per_beam), bool)
    valid1[:len(live)] = True
    ids = np.concatenate([b * layout.tiles_per_beam + per_beam
                          for b in range(cfg.nbeams)])
    return ids.astype(np.int32), np.tile(valid1, cfg.nbeams)


def _field_table(cfg: Config, fields: Fields) -> np.ndarray:
    """The hot fields interleaved as float64 (P, 4) rows [kick_x, kick_y,
    kick_z, absorb], so the per-step lookup is one row gather."""
    d = np.array([cfg.dx, cfg.dy, cfg.dz])
    kick = fields.fgrad * cfg.dt / d          # (nx,ny,nz,3) grid units/step
    return np.concatenate([kick.reshape(-1, 3),
                           fields.absorb.reshape(-1, 1)], axis=1)


def prepare(cfg: Config, prof: RadialProfiles | None = None,
            beam_norm: np.ndarray | None = None) -> TraceContext:
    """Host-side setup ("Init" phase): profiles, fields, rays, initial state,
    in float64 NumPy, cast once to the config's dtype.  The JAX package's
    ``prepare(host_state=True)`` without its disk cache."""
    if prof is None:
        prof = load_profiles(nr=cfg.nr)
    if beam_norm is None:
        beam_norm = load_beam_norms(nbeams=cfg.nbeams)

    fields = build_fields(cfg, prof)
    pow_r = power_table(cfg)
    rays = init_rays(cfg, beam_norm, pow_r)
    layout = build_tile_layout(cfg)

    np_dtype = np.dtype(cfg.dtype)
    d = np.array([cfg.dx, cfg.dy, cfg.dz])
    origin = np.array([cfg.xmin, cfg.ymin, cfg.zmin])
    f4 = _field_table(cfg, fields)

    # --- initial ray state (float64 on host, cast once) ---
    pos = rays.pos.reshape(-1, 3)                     # (nbeams*nrays, 3) cm
    t0 = (pos - origin) / d                           # grid units
    cell0 = initial_cell(cfg, t0)

    # dispersion relation at the launch cell node (launch_ray_XZ.cu:186-204)
    flat0 = (cell0[:, 0] * cfg.ny + cell0[:, 1]) * cfg.nz + cell0[:, 2]
    wsq = fields.wsq_term.reshape(-1)[flat0]
    w = np.sqrt(np.maximum(k.OMEGA ** 2 - wsq, 0.0)) / k.C_CMS
    bn = beam_norm / np.linalg.norm(beam_norm, axis=1, keepdims=True)
    ray_beam = np.repeat(np.arange(cfg.nbeams, dtype=np.int32), cfg.nrays)
    v = -(k.C_CMS ** 2) * bn[ray_beam] * (w / k.OMEGA)[:, None]  # cm/s
    vel0 = v * cfg.dt / d                                        # grid units/step

    # scatter ray data into tile-ordered slots; uncovered slots stay dead
    slots = layout.slot_of.reshape(-1)
    ns = layout.n_slots
    frac0 = t0 - cell0
    kick0 = f4[flat0, :3]        # gradient kick at the launch cell (step 0)
    fmat = np.zeros((11, ns), np_dtype)
    fmat[10] = 1.0     # padding slots: uray_init=1 keeps the 5% rule defined
    for i in range(3):
        fmat[i, slots] = np.ascontiguousarray(frac0[:, i]).astype(np_dtype)
        fmat[3 + i, slots] = np.ascontiguousarray(vel0[:, i]).astype(np_dtype)
        fmat[6 + i, slots] = np.ascontiguousarray(kick0[:, i]).astype(np_dtype)
    fmat[9, slots] = rays.uray.reshape(-1).astype(np_dtype)
    fmat[10, slots] = fmat[9, slots]
    imat = np.zeros((3, ns), np.int32)
    for i in range(3):
        imat[i, slots] = cell0[:, i]
    mask_slots = np.zeros((ns,), bool)
    mask_slots[slots] = rays.mask.reshape(-1)
    beam_id = np.full((ns,), -1, np.int32)
    beam_id[slots] = ray_beam

    f = [torch.from_numpy(fmat[i]) for i in range(11)]
    c = [torch.from_numpy(imat[i]) for i in range(3)]
    state0 = RayState(frac=(f[0], f[1], f[2]), vel=(f[3], f[4], f[5]),
                      kick=(f[6], f[7], f[8]), uray=f[9], uray_init=f[10],
                      cell=(c[0], c[1], c[2]),
                      alive=torch.from_numpy(mask_slots))
    return TraceContext(
        cfg=cfg, prof=prof, beam_norm=beam_norm, fields=fields, rays=rays,
        layout=layout, field4=torch.from_numpy(f4.astype(np_dtype)),
        state0=state0, beam_id=beam_id,
        live_slots=_live_slots_of(mask_slots, layout.rays_per_tile))


def _div(a: torch.Tensor, s: float) -> torch.Tensor:
    """``a / s`` correctly rounded on every device: dividing by a CPU scalar
    multiplies by its reciprocal on the card, one rounding more than the
    host NumPy division the on-card init reproduces."""
    return a / torch.tensor(s, dtype=a.dtype, device=a.device)


def make_device_init(cfg: Config, layout: TileLayout):
    """On-card ray initialization (``models/raytracer.py:407``), the
    counterpart of the reference's GPU-side ``init()``
    (launch_ray_XZ.cu:65-115): ``init(field4, w_node, beam_tab, site,
    site_mask, tile_ids, tile_valid) -> RayState`` over ``T *
    rays_per_tile`` slots, every argument a tensor on the target device.

    It computes in float64 whatever the device, with the host
    :func:`prepare`'s operations in its order (``_div`` keeps the divisions
    exact), so the state equals the host's for every launched ray; the
    caller casts it to the config's dtype.  The JAX kernel computes in the
    field table's dtype only because the TPU lacks float64.  The two square
    roots come from host tables, because PyTorch's CPU ``sqrt`` is not
    correctly rounded: ``site`` (nrays, 3) holds each thread id's lattice
    position and launch energy and ``site_mask`` its launch mask
    (``beams.site_launch``), ``w_node`` (P,) the dispersion relation's
    ``sqrt(omega^2 - wsq) / c`` at each node.  ``beam_tab`` is (nbeams, 7):
    [c1, s1, c2, s2, bnx, bny, bnz].  Only these O(grid + nrays) tables
    cross to the device; the per-ray state is born there."""
    rpz = cfg.rays_per_zone
    zones = cfg.zones_spanned
    tz = cfg.tile_zones
    side = tz * rpz
    rpt = layout.rays_per_tile
    tpb = layout.tiles_per_beam
    ntiles_axis = -(-zones // tz)
    tpb_real = ntiles_axis * ntiles_axis
    d = (cfg.dx, cfg.dy, cfg.dz)
    origin = (cfg.xmin, cfg.ymin, cfg.zmin)
    nvec = (cfg.nx, cfg.ny, cfg.nz)
    tol = cfg.cell_tol

    def initial_cell_t(t, n):
        c0 = torch.ceil(t - tol).to(torch.int32)
        out = torch.zeros_like(c0)
        for cand in (c0 + 1, c0):     # later write (c0) wins: first match
            ok = (cand >= 0) & (cand <= n - 1) & ((cand - t).abs() <= tol)
            out = torch.where(ok, cand, out)
        return out

    def init(field4, w_node, beam_tab, site, site_mask, tile_ids,
             tile_valid):
        dev = tile_ids.device
        s = torch.arange(tile_ids.shape[0] * rpt, dtype=torch.int64,
                         device=dev)
        ti, rit = s // rpt, s % rpt
        gtile = tile_ids.to(torch.int64).index_select(0, ti)
        beam, tile = gtile // tpb, gtile % tpb
        ty, tx = tile // ntiles_axis, tile % ntiles_axis
        ly, lx = rit // side, rit % side
        zy = ty * tz + ly // rpz
        zx = tx * tz + lx // rpz
        in_lat = (tile < tpb_real) & (zx < zones) & (zy < zones)
        # the thread id of the slot's lattice site (launch_ray_XZ.cu:69-74)
        kk = torch.where(in_lat, (zy * zones + zx) * (rpz * rpz)
                         + (ly % rpz) * rpz + lx % rpz, 0)

        # launch lattice in the focal plane, energy and mask of the site
        x0, y0, uray = (site[:, i].index_select(0, kk) for i in range(3))
        z0 = cfg.focal_length - cfg.dz / 2
        mask = (in_lat & site_mask.index_select(0, kk)
                & tile_valid.index_select(0, ti))

        # the two Euler rotations (launch_ray_XZ.cu:99-111)
        col = [beam_tab[:, i].index_select(0, beam) for i in range(7)]
        c1, s1, c2, s2 = col[:4]
        xa = x0 * c1 + z0 * s1
        za = z0 * c1 - x0 * s1
        xb = xa * c2 - y0 * s2
        yb = y0 * c2 + xa * s2

        # grid coordinates, initial cell, dispersion velocity, launch kick
        cell, frac = [], []
        for ax, p in enumerate((xb, yb, za)):
            t = _div(p - origin[ax], d[ax])
            c = initial_cell_t(t, nvec[ax])
            cell.append(c)
            frac.append(t - c.to(t.dtype))
        flat = ((cell[0].to(torch.int64) * cfg.ny + cell[1]) * cfg.nz
                + cell[2])
        wk = _div(w_node.index_select(0, flat), k.OMEGA)
        vel = tuple(_div((-(k.C_CMS ** 2) * col[4 + ax]) * wk * cfg.dt, d[ax])
                    for ax in range(3))
        rows = field4.index_select(0, flat)
        return RayState(
            frac=tuple(frac), vel=vel,
            kick=tuple(rows[:, ax] for ax in range(3)),
            uray=torch.where(mask, uray, 0.0),
            uray_init=torch.where(mask, uray, 1.0),
            cell=tuple(cell), alive=mask)

    return init


def prepare_device(cfg: Config, prof: RadialProfiles | None = None,
                   beam_norm: np.ndarray | None = None,
                   device=None) -> TraceContext:
    """On-card Init (``models/raytracer.py:566``): like :func:`prepare`,
    but the per-ray state is built on ``device`` (default: the card,
    :func:`default_device`) by :func:`make_device_init`, in float64, and
    cast once to the config's dtype.  ``state0`` is already the live-tile,
    per-beam block-padded traced state of :func:`live_tile_ids`,
    ``live_slots`` spans all of it, ``beam_id`` is -1 on pad slots and
    ``compact`` is True.  Host work is O(grid + nrays), not
    O(nbeams * nrays)."""
    device = torch.device(device) if device is not None else default_device()
    if prof is None:
        prof = load_profiles(nr=cfg.nr)
    if beam_norm is None:
        beam_norm = load_beam_norms(nbeams=cfg.nbeams)
    fields = build_fields(cfg, prof)
    layout = build_tile_layout(cfg)
    f4 = _field_table(cfg, fields)

    bn = beam_norm / np.linalg.norm(beam_norm, axis=1, keepdims=True)
    theta1 = np.arccos(beam_norm[:, 2])
    theta2 = np.arctan2(beam_norm[:, 1] * cfg.focal_length,
                        cfg.focal_length * beam_norm[:, 0])
    beam_tab = np.stack([np.cos(theta1), np.sin(theta1),
                         np.cos(theta2), np.sin(theta2),
                         bn[:, 0], bn[:, 1], bn[:, 2]], axis=1)
    ids, valid = live_tile_ids(cfg, layout)
    x0, y0, uray1, mask1 = site_launch(cfg, power_table(cfg))
    w_node = np.sqrt(np.maximum(k.OMEGA ** 2 - fields.wsq_term.reshape(-1),
                                0.0)) / k.C_CMS

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    field4_64 = up(f4)
    state = make_device_init(cfg, layout)(
        field4_64, up(w_node), up(beam_tab),
        up(np.stack([x0, y0, uray1], axis=1)), up(mask1), up(ids),
        up(valid))
    dtype = getattr(torch, cfg.dtype)
    state0 = state.map(lambda a: (a.to(dtype) if a.is_floating_point()
                                  else a).contiguous())
    beam_id = np.repeat(np.where(valid, ids // layout.tiles_per_beam, -1),
                        layout.rays_per_tile).astype(np.int32)
    return TraceContext(
        cfg=cfg, prof=prof, beam_norm=beam_norm, fields=fields, rays=None,
        layout=layout, field4=field4_64.to(dtype), state0=state0,
        beam_id=beam_id, live_slots=np.arange(state0.n, dtype=np.int64),
        compact=True)


def select_rays(state: RayState, indices) -> RayState:
    """Subset the ray batch by slot indices (on the state's device)."""
    idx = torch.as_tensor(np.asarray(indices, np.int64),
                          device=state.uray.device)
    return state.map(lambda a: a.index_select(0, idx))


def _reindex_axis(cell, frac, n: int, tol: float):
    """Countdown cell re-index (launch_ray_XZ.cu:282-292): of the candidates
    {cell-1, cell, cell+1} clipped to [0, n-1], the *smallest* within ``tol``
    of the position wins (the countdown loop's last write); else unchanged.

    Cell-relative: candidate offset d matches iff ``|d - frac| < tol``.
    Returns the chosen offset; no-match coincides with offset 0."""
    dsel = torch.zeros_like(cell)
    for dlt in (1, 0, -1):
        ok = (dlt - frac).abs() < tol
        if dlt == 1:
            ok &= cell + 1 <= n - 1
        elif dlt == -1:
            ok &= cell - 1 >= 0
        dsel = torch.where(ok, dlt, dsel)
    return dsel


def make_deferred_step_fn(cfg: Config):
    """The step physics (one iteration of the reference time loop,
    launch_ray_XZ.cu:207-357, over the whole ray batch): advances the state
    and returns the deposit inputs (cell, frac, masked increment).  The
    gradient kick at the current cell was gathered by the previous step;
    the one gather per step fetches kick-for-next-step + absorption at the
    new cell in one (N, 4) row.

    ``step(state, field4, out=None)``: ``out``, seven (N,) tensors (three
    int32 cells, three fracs and the increment, of the ray dtype), receives
    the deposit inputs in place of new tensors, so a window's rows land in
    one buffer without a copy; the values are the same."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    tol = cfg.cell_tol
    stop_frac = cfg.stop_fraction
    absorption = cfg.absorption
    nvec = (nx, ny, nz)
    zero = {}       # (dtype, device) -> 0-dim zero: where(out=) takes tensors

    def step(state: RayState, field4: torch.Tensor, out=None):
        o = out if out is not None else (None,) * 7
        vel = tuple(state.vel[ax] - state.kick[ax] for ax in range(3))
        frac = tuple(state.frac[ax] + vel[ax] for ax in range(3))
        dsel = tuple(_reindex_axis(state.cell[ax], frac[ax], nvec[ax], tol)
                     for ax in range(3))
        cell = tuple(torch.add(state.cell[ax], dsel[ax], out=o[ax])
                     for ax in range(3))
        frac = tuple(torch.sub(frac[ax], dsel[ax].to(frac[ax].dtype),
                               out=o[3 + ax]) for ax in range(3))
        flat2 = ((cell[0].to(torch.int64) * ny + cell[1]) * nz + cell[2])
        rows = field4.index_select(0, flat2)
        kick = tuple(rows[:, ax] for ax in range(3))
        if absorption:
            increment = rows[:, 3] * state.uray
            uray = state.uray - increment
        else:
            increment = state.uray
            uray = state.uray
        # the OLD alive: a ray deposits on the step it dies
        if out is None:
            inc_masked = torch.where(state.alive, increment, 0.0)
        else:
            key = (increment.dtype, increment.device)
            if key not in zero:
                zero[key] = torch.zeros((), dtype=key[0], device=key[1])
            inc_masked = torch.where(state.alive, increment, zero[key],
                                     out=o[6])
        left = torch.zeros_like(state.alive)
        for ax in range(3):
            t = cell[ax].to(frac[ax].dtype) + frac[ax]
            left |= (t < -0.5) | (t > nvec[ax] - 0.5)
        dead = (uray <= stop_frac * state.uray_init) | left
        alive = state.alive & ~dead
        keep = state.alive          # a dead ray's whole state is frozen
        new_state = RayState(
            frac=tuple(torch.where(keep, frac[ax], state.frac[ax]) for ax in range(3)),
            vel=tuple(torch.where(keep, vel[ax], state.vel[ax]) for ax in range(3)),
            kick=tuple(torch.where(keep, kick[ax], state.kick[ax]) for ax in range(3)),
            uray=torch.where(keep, uray, state.uray),
            uray_init=state.uray_init,
            cell=tuple(torch.where(keep, cell[ax], state.cell[ax]) for ax in range(3)),
            alive=alive,
        )
        return new_state, (cell, frac, inc_masked)

    return step


def default_device() -> torch.device:
    """The card.  Raises when there is none: the entry points never pick
    the CPU on their own, a CPU run is asked for with ``device="cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False): pass "
            "device=\"cpu\" (on the command line --device cpu) for a CPU run")
    return torch.device("cuda")


def resolve_deposit_fn(cfg: Config, device) -> Callable:
    """The deposit function for ``cfg.deposit_backend`` on ``device``:
    "auto" is the wrapper (the kernel for CUDA tensors, the plain version
    for CPU tensors); "cuda" is the kernel and raises off the card; "torch"
    is the plain version, for CPU tensors only.  No choice falls back."""
    device = torch.device(device)
    backend = cfg.deposit_backend
    if backend not in DEPOSIT_BACKENDS:
        raise ValueError(f"unknown deposit_backend {backend!r} "
                         f"(expected one of {DEPOSIT_BACKENDS})")
    if backend == "cuda" and device.type != "cuda":
        raise RuntimeError("deposit_backend='cuda' needs tensors on a CUDA "
                           f"device, got {device}")
    if backend == "torch":
        if device.type != "cpu":
            raise RuntimeError("deposit_backend='torch' runs on the CPU only; "
                               "on the card the deposit is the CUDA kernel")
        return deposit_reference
    return deposit


def chunk_lengths(cfg: Config) -> tuple[int, int, int]:
    """``(chunk, n_chunks, last_chunk)``: the trace's chunk lengths."""
    chunk = max(1, min(cfg.chunk_steps, cfg.nt))
    n_chunks = -(-cfg.nt // chunk)          # ceil
    return chunk, n_chunks, cfg.nt - (n_chunks - 1) * chunk


def batched(cfg: Config) -> bool:
    """Whether the traces advance whole windows of ``deposit_batch_steps``
    steps between deposits: the batch is > 1 and divides both chunk lengths
    (``models/raytracer.py:793-795``, ``models/cbet.py:491-494``); else they
    deposit every step."""
    chunk, _, last = chunk_lengths(cfg)
    b = cfg.deposit_batch_steps
    return b > 1 and not (chunk % b or last % b)


def _window_rows(batch: int, n: int, dtype, device):
    """The deposit inputs of a window of ``batch`` steps of ``n`` rays:
    ``rows[j]`` are step j's seven (n,) output tensors for the step
    function, ``flat`` the seven step-major (batch * n,) tensors over the
    same memory for the deposit."""
    bufs = ([torch.empty((batch, n), dtype=torch.int32, device=device)
             for _ in range(3)]
            + [torch.empty((batch, n), dtype=dtype, device=device)
               for _ in range(4)])
    rows = [tuple(b[j] for b in bufs) for j in range(batch)]
    return rows, tuple(b.view(-1) for b in bufs)


@dataclasses.dataclass
class TraceCarry:
    """What the chunk loop carries from one chunk to the next, and what a
    checkpoint of a trace holds (all but the window buffers)."""

    state: RayState
    master: torch.Tensor            # the ``edep_dtype`` grid so far
    oflow: torch.Tensor             # 0-dim int32
    steps: int = 0                  # steps executed
    chunk: int = 0                  # index of the next chunk
    comp: TileCompactor | None = None
    rows: Any = None                # the window's buffers, re-made when the
    flat: tuple = ()                # ray count changes; never saved


class ChunkedTrace:
    """THE chunk loop of the plain trace, one chunk at a time over an
    explicit :class:`TraceCarry`: :func:`make_trace_fn` runs it from chunk 0
    to the end, the resumable runners (``runner.run_resumable``,
    ``runner.run_composed``) from a checkpoint's chunk.

    ``start(state0)`` makes the carry of a fresh trace, ``resume(...)`` the
    carry of a saved one; ``advance(field4, carry)`` runs the next chunk
    (compaction at its boundary, its windows or steps, the promotion of its
    grid into the master) and returns False, doing nothing, when the trace
    is over: ``nt`` steps done or no ray alive (one device sync per chunk);
    ``finish(carry)`` returns ``(edep, final_state, overflow, steps)`` with
    the state in ``state0``'s layout.

    A carry between two chunks is always *before* the next boundary's
    gather, so a checkpoint taken there resumes the same way whether or not
    that boundary compacts."""

    def __init__(self, cfg: Config, deposit_fn: Callable | None = None,
                 compact: bool = False):
        self.cfg = cfg
        self.deposit_fn = deposit_fn
        self.compact = compact
        self.step = make_deferred_step_fn(cfg)
        self.chunk, self.n_chunks, _ = chunk_lengths(cfg)
        self.batch = cfg.deposit_batch_steps if batched(cfg) else 1
        self.master_dtype = getattr(torch, cfg.edep_dtype)

    def start(self, state0: RayState) -> TraceCarry:
        device = state0.uray.device
        return TraceCarry(
            state=state0,
            master=torch.zeros(self.cfg.edep_shape, dtype=self.master_dtype,
                               device=device),
            oflow=torch.zeros((), dtype=torch.int32, device=device),
            comp=(TileCompactor(state0, rays_per_tile(self.cfg))
                  if self.compact else None))

    def resume(self, state0: RayState, state: RayState,
               master: torch.Tensor, oflow: int, steps: int, chunk: int,
               compactor: dict | None = None) -> TraceCarry:
        """The carry of a trace over ``state0`` saved after ``chunk``
        chunks; ``compactor`` is the saved ``TileCompactor.state_dict()``
        of a compacted trace."""
        if self.compact != (compactor is not None):
            raise ValueError("a compacted trace resumes from a compactor's "
                             "state, an uncompacted one without")
        device = state0.uray.device
        comp = (TileCompactor.from_state_dict(
            state0, rays_per_tile(self.cfg), compactor)
            if compactor is not None else None)
        n = comp.tiles.shape[0] * comp.rpt if comp is not None else state0.n
        if state.n != n or tuple(master.shape) != tuple(self.cfg.edep_shape):
            raise ValueError(
                f"the saved state has {state.n} slots and a master "
                f"{tuple(master.shape)}; this trace expects {n} and "
                f"{tuple(self.cfg.edep_shape)}")
        return TraceCarry(
            state=state, master=master.to(device, self.master_dtype),
            oflow=torch.full((), int(oflow), dtype=torch.int32,
                             device=device),
            steps=int(steps), chunk=int(chunk), comp=comp)

    def advance(self, field4: torch.Tensor, c: TraceCarry) -> bool:
        cfg, batch = self.cfg, self.batch
        if c.chunk >= self.n_chunks or not bool(c.state.alive.any()):
            return False
        state = c.state
        device, compute_dtype = state.uray.device, state.uray.dtype
        dep = self.deposit_fn or resolve_deposit_fn(cfg, device)
        if c.comp is not None:
            state, _ = c.comp.update(state, first=c.chunk == 0)
        n_steps = min(self.chunk, cfg.nt - c.chunk * self.chunk)
        edep = torch.zeros(cfg.edep_shape, dtype=compute_dtype, device=device)
        if batch > 1:
            if c.rows is None or c.rows[0][0].shape[0] != state.n:
                c.rows, c.flat = _window_rows(batch, state.n, compute_dtype,
                                              device)
            for _ in range(n_steps // batch):
                for out in c.rows:
                    state, _ = self.step(state, field4, out)
                edep, of = dep(edep, *c.flat, state.n)
                c.oflow += of
        else:
            for _ in range(n_steps):
                state, (cell, frac, inc) = self.step(state, field4)
                edep, of = dep(edep, *cell, *frac, inc)
                c.oflow += of
        c.state = state
        c.steps += n_steps
        c.chunk += 1
        c.master += edep.to(self.master_dtype)
        return True

    def finish(self, c: TraceCarry, widths=None):
        state = c.state
        if c.comp is not None:
            state = c.comp.final(state)
            if widths is not None:
                widths.extend(c.comp.widths)
        return c.master, state, c.oflow, c.steps


def make_trace_fn(cfg: Config, deposit_fn: Callable | None = None,
                  compact: bool = False):
    """Build the full-trace function
    ``(field4, state0, widths=None) -> (edep, final_state, overflow, steps)``.

    Runs ``nt`` steps in chunks of ``chunk_steps`` (:class:`ChunkedTrace`);
    each chunk deposits into a grid of the ray dtype and promotes it into an
    ``edep_dtype`` master between chunks.  The trace stops at the first
    chunk boundary where no ray is alive (the CUDA ``break`` at chunk
    granularity; one device sync per chunk).  ``overflow`` is the 0-dim
    int32 count of deposits outside the grid (0 in any valid
    configuration); ``steps`` the number of steps executed.

    Where :func:`batched`, the trace advances ``deposit_batch_steps`` steps,
    each writing its deposit inputs into its row of one preallocated window
    buffer (no copy), then deposits the step-major window in one call,
    ``deposit_fn(edep, *rows, n_rays)``: ``steps / deposit_batch_steps``
    deposit calls.  Else it deposits every step.  The ray count is fixed
    inside a window: compaction happens at chunk boundaries only.

    ``compact`` drops dead tiles at chunk boundaries
    (``models/tileplan.py``; ``state0`` must be whole tiles): the same edep,
    and the same final state, written back to ``state0``'s layout.  A list
    passed as ``widths`` receives the tile counts before the trace and after
    each compaction.

    ``deposit_fn`` overrides the config's deposit (used to time or compare
    the kernel against its plain version); by default it is resolved from
    ``cfg.deposit_backend`` and the device of ``state0``."""
    chunks = ChunkedTrace(cfg, deposit_fn, compact)

    def trace(field4: torch.Tensor, state0: RayState, widths=None):
        carry = chunks.start(state0)
        while chunks.advance(field4, carry):
            pass
        return chunks.finish(carry, widths)

    return trace


def traced_state(ctx: TraceContext, device) -> RayState:
    """The state a run traces on ``device``: a compact context's state0 as
    it is, else the live-tile slots of the host state, padded to whole
    tiles."""
    if ctx.compact:
        return ctx.state0.to(device)
    from ..parallel.sharding import pad_rays
    return pad_rays(select_rays(ctx.state0, ctx.live_slots),
                    ctx.layout.rays_per_tile).to(device)


def trace(ctx: TraceContext, device=None, compact: bool = False):
    """Convenience full trace of the live tiles on ``device`` (default: the
    card, :func:`default_device`; ``"cpu"`` for a CPU run), compacted
    mid-trace with ``compact``.  Returns (edep [np.f64 padded], final
    RayState over the traced slots)."""
    device = torch.device(device) if device is not None else default_device()
    edep, state, oflow, _ = make_trace_fn(ctx.cfg, compact=compact)(
        ctx.field4.to(device), traced_state(ctx, device))
    check_overflow(int(oflow), ctx.cfg)
    return edep.to("cpu", torch.float64).numpy(), state


def check_overflow(oflow: int, cfg: Config) -> None:
    """Raise on deposits outside the grid — silent data loss must never
    pass.  A RuntimeError (not ``assert``) so the guard survives
    ``python -O``."""
    if oflow:
        raise RuntimeError(
            f"deposit overflow: {oflow} live rows had a corner outside the "
            f"{cfg.edep_shape} grid and were not deposited")


def trace_stats(ctx: TraceContext, state: RayState,
                state0: RayState | None = None) -> dict[str, Any]:
    """Run metrics the reference lacks (SURVEY.md §5.5): launch/termination
    accounting and energy bookkeeping.

    ``state0`` is the initial state actually traced (it may be a live-tile
    subset of ``ctx.state0``, possibly padded); defaults to ``ctx.state0``,
    which a compact context (``prepare_device``) traces as it is.  The two
    states must have the same slot count; a compacted trace returns its
    final state in its ``state0``'s layout, so it needs no slot map."""
    if state0 is None:
        state0 = ctx.state0
    if state0.n != state.n:
        raise ValueError(
            f"final state has {state.n} slots but state0 has {state0.n}: "
            "slot-for-slot accounting needs the same layout")
    launched_mask = state0.alive.cpu().numpy()
    launched = int(launched_mask.sum())
    alive_end = int(state.alive.sum())
    uray = state.uray.to("cpu", torch.float64).numpy()
    uinit = state.uray_init.to("cpu", torch.float64).numpy()
    absorbed = float(np.sum((uinit - uray)[launched_mask]))
    return {
        "rays_total": int(ctx.cfg.total_rays),
        "rays_launched": launched,
        "rays_alive_at_end": alive_end,
        "rays_terminated": launched - alive_end,
        "energy_launched": float(np.sum(uinit[launched_mask])),
        "energy_absorbed": absorbed,
    }
