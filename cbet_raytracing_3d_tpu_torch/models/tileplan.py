"""Mid-trace tile compaction, decided by the trace's own ``alive`` mask.

Counterpart of ``cbet_raytracing_3d_tpu/models/tileplan.py`` and of the
segmented traces built on it (``raytracer.make_segmented_trace_fn`` /
``segment_slot_origins``, the segmented branch of ``cbet.make_cbet_trace_fn``
with ``tileplan.build_beam_segments``).  The JAX package compacts by a
*static plan*: jitted scans need static shapes, so it measures the per-chunk
tile liveness with a pre-trace, caches it by a config + scene fingerprint,
and gathers the ray state down at the plan's segment boundaries; for CBET it
measures a gain-proof plan (``stop_fraction=0``, or a ``cbet_plan_headroom``
scaled stop rule with a retry).

Eager PyTorch needs none of that.  The trace already syncs at every chunk
boundary for its all-dead early exit, so there the trace's own ``alive`` mask
decides which tiles survive: a tile is kept while any of its rays is alive.
Per-ray ``alive`` never returns to True once False, so this liveness is
monotone and exact under any gain -- no plan, no pre-trace, no fingerprint
cache, no gain-proof plan and no headroom retry.

CAUTION (kept from the JAX package): per-chunk *deposit activity* is not
monotone -- live rays can cross near-vacuum where the absorption increment is
exactly zero for a whole chunk and deposit again later.  The JAX plan
therefore takes the suffix-OR of its per-chunk liveness; here liveness is
``alive`` itself, never "deposited in this chunk", so a coasting ray's tile is
never dropped.

The rules kept from the JAX package:

* re-gather only when the live tile count falls below ``SHRINK`` (0.9) x the
  current width (``tileplan.py:172``), and once more before chunk 0 to drop
  the block padding and the tiles without a launched ray;
* the dropped-alive-ray hard error (:class:`DroppedAliveRaysError`): 0 by
  construction, counted all the same;
* the final state is written back to the uncompacted layout at each
  compaction (``track_final_state``), so a compacted trace returns the same
  final state as the plain one.

Grouped mode (the CBET trace): the grouped intensity deposit and the
window-gain deposit find a row's beam from its *position*, so the state
stays beam-contiguous with one uniform width per beam: the width is the
largest live tile count over the beams, each beam keeps its live tiles in
order and pads to the width with its own dead tiles (a fully dead beam keeps
width-many dead tiles), and ``rays_per_group`` becomes ``width * rpt``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

if TYPE_CHECKING:
    from .raytracer import RayState

#: re-gather when the live tiles fall below this share of the current width
SHRINK = 0.9


class DroppedAliveRaysError(RuntimeError):
    """A compaction dropped a still-alive ray (``models/cbet.py:68``).  Never
    expected: tiles are dropped only when none of their rays is alive."""


def _take_tiles(a: torch.Tensor, n_tiles: int, idx: torch.Tensor):
    return a.view(n_tiles, -1).index_select(0, idx).reshape(-1)


class TileCompactor:
    """The compaction of one trace over ``state0`` (``rays_per_tile``-row
    tiles; ``n_groups`` beam-contiguous groups of equal width in grouped
    mode, else ``None``).

    Call :meth:`update` at each chunk boundary where a ray is alive; it
    returns the state and the extra per-ray tensors, gathered when the rule
    says so.  :meth:`final` returns the final state in ``state0``'s layout.
    ``widths`` records the width (tiles, per group in grouped mode) before
    the trace and after each compaction.  ``state0`` is never written."""

    def __init__(self, state0: RayState, rays_per_tile: int,
                 n_groups: int | None = None, shrink: float = SHRINK):
        n_tiles, rem = divmod(state0.n, rays_per_tile)
        if rem or (n_groups is not None and n_tiles % n_groups):
            raise ValueError(
                f"{state0.n} slots are not whole tiles of {rays_per_tile}"
                + ("" if n_groups is None else f" in {n_groups} groups"))
        self.state0 = state0
        self.rpt = rays_per_tile
        self.groups = n_groups
        self.shrink = shrink
        self.tiles = torch.arange(n_tiles, device=state0.uray.device)
        self.full: RayState | None = None
        self.widths = [self.width]

    @property
    def width(self) -> int:
        """Tiles now traced (per group in grouped mode)."""
        n = self.tiles.shape[0]
        return n if self.groups is None else n // self.groups

    def keep(self, alive: torch.Tensor, first: bool) -> torch.Tensor | None:
        """Indices of the current tiles to keep, or None when the rule keeps
        them all: ``first`` (before chunk 0) drops any dead tile, later
        boundaries only when the width would fall below ``shrink``x."""
        live = alive.view(-1, self.rpt).any(dim=1)
        w = self.width
        if self.groups is None:
            kept = torch.nonzero(live).reshape(-1)
            new_w = kept.shape[0]
        else:
            live = live.view(self.groups, w)
            new_w = int(live.sum(dim=1).max())
            # each group: its live tiles in order, then its dead ones
            order = torch.argsort((~live).to(torch.int8), dim=1, stable=True)
            base = torch.arange(self.groups, device=alive.device)[:, None] * w
            kept = (order[:, :new_w] + base).reshape(-1)
        if not (new_w < w if first else new_w < self.shrink * w):
            return None
        return kept

    def gather(self, state: RayState, extras: tuple, kept: torch.Tensor):
        """Write the state back, then keep the tiles ``kept``: the state and
        every tensor of ``extras`` (per-ray, the state's layout).  Raises
        :class:`DroppedAliveRaysError` if a dropped tile holds an alive ray."""
        self._write_back(state)
        n = self.tiles.shape[0]
        alive_before = state.alive.sum()
        state = state.map(lambda a: _take_tiles(a, n, kept))
        dropped = int(alive_before - state.alive.sum())
        if dropped:
            raise DroppedAliveRaysError(
                f"tile compaction dropped {dropped} still-alive rays")
        self.tiles = self.tiles.index_select(0, kept)
        self.widths.append(self.width)
        return state, tuple(_take_tiles(e, n, kept) for e in extras)

    def update(self, state: RayState, extras: tuple = (), first=False):
        """One chunk boundary: ``(state, extras)``, compacted when the rule
        says so."""
        kept = self.keep(state.alive, first)
        if kept is None:
            return state, extras
        return self.gather(state, extras, kept)

    def final(self, state: RayState) -> RayState:
        """The final state in ``state0``'s layout."""
        if self.full is None:
            return state
        self._write_back(state)
        return self.full

    def _write_back(self, state: RayState) -> None:
        if self.full is None:
            self.full = self.state0.map(torch.clone)
        rows = (self.tiles[:, None] * self.rpt
                + torch.arange(self.rpt, device=self.tiles.device)
                ).reshape(-1)
        for dst, src in zip(_fields(self.full), _fields(state)):
            dst.index_copy_(0, rows, src)


def _fields(state: RayState) -> list:
    return [*state.frac, *state.vel, *state.kick, state.uray,
            state.uray_init, *state.cell, state.alive]
