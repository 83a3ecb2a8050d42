"""Ray trajectory and cell-crossing diagnostics.

Counterpart of ``cbet_raytracing_3d_tpu/models/tracker.py``.  The reference
scaffolds these as dormant compile-time hooks (``RAY_TRACKER_DIAGNOSTICS`` /
``INTERSECTION_DIAGNOSTICS``, def.cuh:26-27, both 0 and unreferenced); here
a selected subset of rays is traced through the production step physics
(``raytracer.make_deferred_step_fn``) recording the full per-step history
(cell, physical position, energy), and per-ray cell-crossing lists are
extracted, bounded by the reference's ``ncrossings = 3*nx`` (def.cuh:96).

Recording matches the oracle's ``trace_ray(record_path=True)``: one entry
per executed step, post-update, including the terminating step
(oracle.py:249-256 appends then breaks).  Pupil-rejected rays
(launch_ray_XZ.cu:114,181-182) record zero steps.

Dropped from the JAX module, with the reason: the padding of the tracked
batch to 128 lanes (``_LANES``), which keeps a TPU scan off partial lanes;
the tracked rays here are a plain (K,) batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from .raytracer import (RayState, TraceContext, default_device,
                        live_tile_ids, make_deferred_step_fn, prepare_device,
                        select_rays, slots_of_rays)


@dataclasses.dataclass(frozen=True)
class RayTrajectories:
    """Per-step history of K tracked rays over nt steps.

    ``recorded[t, i]`` marks entries that correspond to an executed step of
    ray i (the ray was alive entering step t); history values outside that
    mask are frozen at the ray's terminal state and should be ignored."""

    beams: np.ndarray      # (K,) int32 beam index of each tracked ray
    ray_ids: np.ndarray    # (K,) int32 reference thread id (pre_raynum)
    launched: np.ndarray   # (K,) bool: False is pupil-rejected, no steps
    steps: np.ndarray      # (K,) int32 number of executed (recorded) steps
    uray_init: np.ndarray  # (K,) float launch energy (the 5% stop scale)
    cell: np.ndarray       # (nt, K, 3) int32 cell index after each step
    pos: np.ndarray        # (nt, K, 3) float physical position [cm]
    uray: np.ndarray       # (nt, K) float ray energy after each step
    recorded: np.ndarray   # (nt, K) bool: see the class docstring

    @property
    def n(self) -> int:
        return self.beams.shape[0]

    def path(self, i: int) -> list[tuple]:
        """Ray i's history in the oracle's path-tuple format
        ``(cx, cy, cz, x, y, z, uray)`` (oracle.py:250)."""
        return [(int(self.cell[t, i, 0]), int(self.cell[t, i, 1]),
                 int(self.cell[t, i, 2]), float(self.pos[t, i, 0]),
                 float(self.pos[t, i, 1]), float(self.pos[t, i, 2]),
                 float(self.uray[t, i]))
                for t in np.nonzero(self.recorded[:, i])[0]]

    def crossings(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Ray i's cell-crossing list ``(step_idx, cells)``: the (C, 3)
        sequence of distinct cells entered, entry 0 the cell after the first
        step, then every step whose post-step cell differs from the previous
        step's."""
        m = self.recorded[:, i]
        cells = self.cell[m, i, :]
        if cells.shape[0] == 0:
            return (np.zeros((0,), np.int64), np.zeros((0, 3), np.int32))
        changed = np.ones((cells.shape[0],), bool)
        changed[1:] = (cells[1:] != cells[:-1]).any(axis=1)
        steps = np.nonzero(m)[0][changed]
        return steps, cells[changed]

    def crossing_counts(self) -> np.ndarray:
        """(K,) number of distinct-cell entries per ray (INTERSECTION
        diagnostics); compare against ``cfg.ncrossings``."""
        return np.array([self.crossings(i)[0].shape[0]
                         for i in range(self.n)])

    def save_npz(self, path: str) -> None:
        np.savez(path, **{f.name: getattr(self, f.name)
                          for f in dataclasses.fields(self)})

    @staticmethod
    def load_npz(path: str) -> "RayTrajectories":
        with np.load(path) as z:
            return RayTrajectories(**{f.name: z[f.name]
                                      for f in dataclasses.fields(
                                          RayTrajectories)})


def make_track_fn(cfg: Config):
    """``track(field4, state0) -> (final_state, (cell (nt, K, 3),
    pos (nt, K, 3), uray (nt, K), recorded (nt, K)))``: ``nt`` steps of the
    deferred step function, each recorded after it runs; positions in
    physical cm, recording per the module docstring."""
    step = make_deferred_step_fn(cfg)
    d = (cfg.dx, cfg.dy, cfg.dz)
    origin = (cfg.xmin, cfg.ymin, cfg.zmin)

    def track(field4: torch.Tensor, state0: RayState):
        k, dev = state0.n, state0.uray.device
        dtype = state0.uray.dtype
        cell = torch.empty((cfg.nt, k, 3), dtype=torch.int32, device=dev)
        pos = torch.empty((cfg.nt, k, 3), dtype=dtype, device=dev)
        uray = torch.empty((cfg.nt, k), dtype=dtype, device=dev)
        recorded = torch.empty((cfg.nt, k), dtype=torch.bool, device=dev)
        state = state0
        for t in range(cfg.nt):
            recorded[t] = state.alive
            state, _ = step(state, field4)
            for ax in range(3):
                cell[t, :, ax] = state.cell[ax]
                pos[t, :, ax] = ((state.cell[ax].to(dtype) + state.frac[ax])
                                 * d[ax] + origin[ax])
            uray[t] = state.uray
        return state, (cell, pos, uray, recorded)

    return track


def track_rays(cfg: Config, beams, ray_ids, ctx: TraceContext | None = None,
               prof=None, beam_norm=None, device=None) -> RayTrajectories:
    """Trace the (beam, pre_raynum) pairs with full per-step recording on
    ``device`` (default: the card, ``raytracer.default_device``; ``"cpu"``
    for a CPU run).

    ``beams`` / ``ray_ids`` are parallel sequences (reference thread ids,
    launch_ray_XZ.cu:123-134).  Without a ``ctx`` the scene is initialized
    on ``device`` (``prepare_device``: O(grid + nrays) host work).  Slots
    come in closed form (``raytracer.slots_of_rays``); in a compact context
    the global tile maps through the traced tile order
    (``live_tile_ids``), and rays whose tile is absent from it lie in
    pupil-dead tiles: they record zero steps, as any unlaunched ray."""
    device = torch.device(device) if device is not None else default_device()
    beams = np.atleast_1d(np.asarray(beams, np.int32))
    ray_ids = np.atleast_1d(np.asarray(ray_ids, np.int32))
    if beams.shape != ray_ids.shape:
        raise ValueError("beams and ray_ids must be parallel sequences")
    if (beams.min() < 0 or beams.max() >= cfg.nbeams
            or ray_ids.min() < 0 or ray_ids.max() >= cfg.nrays):
        raise ValueError("beam or ray id out of range")
    if ctx is None:
        ctx = prepare_device(cfg, prof=prof, beam_norm=beam_norm,
                             device=device)
    elif ctx.cfg != cfg:
        # the step's flat field4 indices and the slot formula are built from
        # cfg; a context prepared under another config would be read with
        # the wrong strides
        raise ValueError(
            "track_rays: cfg does not match ctx.cfg; pass the context's "
            "own config or rebuild the context for this one")
    rpt = ctx.layout.rays_per_tile
    gtile, rit = slots_of_rays(cfg, beams, ray_ids)
    found = None
    if ctx.compact:
        # traced position of each global tile in the compact layout; on
        # duplicate ids (dead-tile block padding) the valid occurrence wins
        ids, valid = live_tile_ids(cfg, ctx.layout)
        pos_of = np.full(cfg.nbeams * ctx.layout.tiles_per_beam, -1,
                         np.int64)
        order = np.argsort(valid.astype(np.int8), kind="stable")
        pos_of[ids[order]] = np.arange(len(ids), dtype=np.int64)[order]
        pos = pos_of[gtile]
        found = pos >= 0
        slots = np.where(found, pos, 0) * rpt + rit
    else:
        slots = gtile * rpt + rit

    state0 = select_rays(ctx.state0, slots).to(device)
    if found is not None and not found.all():
        m = torch.from_numpy(found).to(device)
        state0 = dataclasses.replace(
            state0, alive=state0.alive & m,
            uray=torch.where(m, state0.uray, 0.0),
            uray_init=torch.where(m, state0.uray_init, 1.0))
    _, (cell, pos, uray, recorded) = make_track_fn(cfg)(
        ctx.field4.to(device), state0)
    recorded = recorded.cpu().numpy()
    k = beams.shape[0]
    return RayTrajectories(
        beams=beams, ray_ids=ray_ids,
        launched=recorded[0] if cfg.nt > 0 else np.zeros((k,), bool),
        steps=recorded.sum(axis=0).astype(np.int32),
        uray_init=state0.uray_init.cpu().numpy(),
        cell=cell.cpu().numpy(), pos=pos.cpu().numpy(),
        uray=uray.cpu().numpy(), recorded=recorded)
