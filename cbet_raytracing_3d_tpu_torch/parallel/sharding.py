"""Multi-device execution: the slot axis split over ``torch.distributed``
ranks, one device each, and the grids summed across them.

Counterpart of ``cbet_raytracing_3d_tpu/parallel/sharding.py``.  The JAX
package shards the flat ray (slot) axis over a 1-D mesh with ``shard_map``
and ``psum``s the deposition grid over ICI; the reference splits beams over
its GPUs and sums replicated grids on the host (``main.cu:133-210``).  Here
each rank traces its own contiguous slot range on its own device, and one
``all_reduce`` sums the float64 master grids (NCCL between cards, gloo on
the CPU or between ranks that share a card).  The ranges are cut at tile
boundaries, so every rank's deposit windows see whole tiles.

``make_mesh`` is the run's process group (:class:`Ranks`; one rank without
one).  The collectives the port needs are here, once: :func:`all_reduce_sum`
(and its max) and :func:`all_gather_rows`.  Each accumulates its
synchronized seconds in ``Ranks.collective_seconds``.

Compaction per rank replaces the static per-device plan.  The JAX
package's ``make_sharded_segmented_trace_fn``, ``device_major_state`` and
``tileplan.build_device_segments`` exist to give ``shard_map`` equal
per-device shapes from a plan measured ahead of the trace; the port has no
plan (``models/tileplan.py``), so each rank compacts its own slots by its
own ``alive`` mask and writes its final state back to its own range.  Rays
are not rebalanced between ranks: each rank's tile widths and busy seconds
are reported instead (:func:`rank_rows`), so the imbalance is a number.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from ..models.raytracer import RayState


@dataclasses.dataclass
class Ranks:
    """The ranks of a run: ``torch.distributed``'s process group (``group``
    None: the default group), or one rank without one (``backend``
    "none")."""

    group: Any
    world: int
    rank: int
    backend: str
    collective_seconds: float = 0.0

    @property
    def key(self) -> tuple:
        return (self.world, self.rank, self.backend, id(self.group))

    @property
    def distributed(self) -> bool:
        """Whether a process group exists: then the collectives run, at
        one rank too (``torchrun --nproc-per-node 1``)."""
        return self.backend != "none"


def make_mesh(group=None) -> Ranks:
    """The run's ranks: ``group`` (default: the default process group)
    when ``torch.distributed`` is initialized, else world size 1."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        if group is not None:
            raise ValueError("a process group was passed but "
                             "torch.distributed is not initialized")
        return Ranks(None, 1, 0, "none")
    return Ranks(group, dist.get_world_size(group), dist.get_rank(group),
                 str(dist.get_backend(group)))


def single_rank_only(entry: str) -> None:
    """Refuse a process group of several ranks: for the entry points that
    take no mesh in the JAX package (the resumable forms, ``runner.py:259``,
    :334, ``cbet_composed.py:232``)."""
    world = make_mesh().world
    if world > 1:
        raise ValueError(f"{entry} runs on one device; this process group "
                         f"has {world} ranks (use runner.run)")


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _reduce(t: torch.Tensor, mesh: Ranks, op: str) -> torch.Tensor:
    if not mesh.distributed:
        return t
    import torch.distributed as dist
    _sync(t)
    t0 = time.perf_counter()
    dist.all_reduce(t, op=getattr(dist.ReduceOp, op), group=mesh.group)
    _sync(t)
    mesh.collective_seconds += time.perf_counter() - t0
    return t


def all_reduce_sum(t: torch.Tensor, mesh: Ranks) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; every rank gets the same values.
    Returns ``t``."""
    return _reduce(t, mesh, "SUM")


def all_reduce_max(t: torch.Tensor, mesh: Ranks) -> torch.Tensor:
    """The elementwise maximum over the ranks, in place.  Returns ``t``."""
    return _reduce(t, mesh, "MAX")


def all_gather_rows(rows: torch.Tensor, mesh: Ranks,
                    counts: list[int]) -> torch.Tensor:
    """The ranks' row blocks stacked in rank order: rank ``r`` passes
    ``counts[r]`` rows (every rank knows ``counts``).  ``all_gather`` needs
    one shape on every rank, so the blocks travel padded to the largest
    count; the padding is a detail of the collective and is dropped.  At
    one rank the rows are the whole: ``rows`` as they are."""
    if not mesh.distributed or mesh.world == 1:
        return rows
    import torch.distributed as dist
    if rows.shape[0] != counts[mesh.rank]:
        raise ValueError(f"rank {mesh.rank} passes {rows.shape[0]} rows, "
                         f"counts say {counts[mesh.rank]}")
    most = max(counts)
    pad = torch.zeros((most,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device)
    pad[:rows.shape[0]] = rows
    parts = [torch.empty_like(pad) for _ in range(mesh.world)]
    _sync(pad)
    t0 = time.perf_counter()
    dist.all_gather(parts, pad, group=mesh.group)
    _sync(pad)
    mesh.collective_seconds += time.perf_counter() - t0
    return torch.cat([p[:c] for p, c in zip(parts, counts)])


def barrier(mesh: Ranks) -> None:
    """Wait until every rank arrives, so that timed work starts together.
    Nothing without a process group."""
    if not mesh.distributed:
        return
    import torch.distributed as dist
    kw = ({"device_ids": [torch.cuda.current_device()]}
          if mesh.backend == "nccl" else {})
    dist.barrier(group=mesh.group, **kw)


def rank_rows(values: list, mesh: Ranks) -> list[list]:
    """Every rank's list of numbers, in rank order, on every rank: the
    per-rank widths and seconds that the stats report."""
    if not mesh.distributed:
        return [list(values)]
    n = _on(torch.tensor([len(values)], dtype=torch.float64), mesh)
    n = int(all_reduce_max(n, mesh))
    row = torch.full((1, n + 1), float("nan"), dtype=torch.float64)
    row[0, 0] = len(values)
    row[0, 1:len(values) + 1] = torch.as_tensor(values, dtype=torch.float64)
    got = all_gather_rows(_on(row, mesh), mesh, [1] * mesh.world).cpu()
    return [got[r, 1:1 + int(got[r, 0])].tolist() for r in range(mesh.world)]


def _on(t: torch.Tensor, mesh: Ranks) -> torch.Tensor:
    """A host tensor where the backend reduces it: NCCL takes CUDA tensors
    only (the rank's current card)."""
    return t.cuda() if mesh.backend == "nccl" else t


def pad_rays(state: RayState, multiple: int) -> RayState:
    """Pad the slot axis to a multiple of ``multiple`` with dead rays; for
    a sharded trace ``n_ranks * rays_per_tile * tiles_per_block`` so that
    every rank's range is whole tiles."""
    pad = (-state.n) % multiple
    if pad == 0:
        return state

    def pad0(x, fill=0):
        tail = torch.full((pad,), fill, dtype=x.dtype, device=x.device)
        return torch.cat([x, tail])

    return RayState(
        frac=tuple(pad0(a) for a in state.frac),
        vel=tuple(pad0(a) for a in state.vel),
        kick=tuple(pad0(a) for a in state.kick),
        uray=pad0(state.uray),
        # avoid 0 <= stop_frac*0 edge cases in the termination rule
        uray_init=pad0(state.uray_init, fill=1),
        cell=tuple(pad0(a) for a in state.cell),
        alive=pad0(state.alive, fill=False),
    )


def local_state(state0: RayState, mesh: Ranks, multiple: int) -> RayState:
    """The rank's slot range of ``state0`` padded to ``mesh.world *
    multiple`` slots (``multihost.local_slot_slice``), as contiguous
    tensors of its own: the rest of the state can be freed.  At one rank,
    ``state0`` as it is."""
    if mesh.world == 1:
        return state0
    from .multihost import local_slot_slice
    padded = pad_rays(state0, mesh.world * multiple)
    sl = local_slot_slice(padded.n, mesh.world, mesh.rank)
    return padded.map(lambda a: a[sl].clone())


def make_sharded_trace_fn(cfg, mesh: Ranks, compact: bool = False,
                          deposit_fn=None):
    """The rank's trace (``sharding.py:70``): ``trace(field4, state,
    widths=None) -> (edep, state, overflow, steps, local)``.

    ``raytracer.make_trace_fn`` over the rank's slots (compacted by its own
    ``alive`` mask with ``compact``), then one ``all_reduce`` of the
    ``edep_dtype`` master and of the overflow count: every rank returns the
    whole grid.  ``steps`` is the most any rank executed (the single-rank
    trace's count: it runs until no ray of any rank is alive); ``local``
    holds the rank's own ``steps`` and ``busy_seconds``, its trace before
    the collectives."""
    from ..models.raytracer import make_trace_fn
    trace1 = make_trace_fn(cfg, deposit_fn, compact)

    def trace(field4, state0, widths=None):
        dev = state0.uray.device
        _sync(state0.uray)
        t0 = time.perf_counter()
        edep, state, oflow, steps = trace1(field4, state0, widths)
        _sync(edep)
        local = {"steps": steps, "busy_seconds": time.perf_counter() - t0}
        edep = all_reduce_sum(edep, mesh)
        oflow = int(all_reduce_sum(oflow.reshape(1).to(torch.int64), mesh))
        steps = int(all_reduce_max(torch.tensor([steps], device=dev), mesh))
        return edep, state, oflow, steps, local

    return trace


def reduce_trace_stats(stats: dict, mesh: Ranks, device) -> dict:
    """``raytracer.trace_stats`` of the rank's slots summed over the ranks:
    the counts exactly, the energies in float64 (the single-rank sums to
    rounding).  No state is gathered."""
    if not mesh.distributed:
        return stats
    keys = ("rays_launched", "rays_alive_at_end", "energy_launched",
            "energy_absorbed")
    vals = torch.tensor([float(stats[k]) for k in keys], dtype=torch.float64,
                        device=device)
    vals = all_reduce_sum(vals, mesh).tolist()
    out = dict(stats)
    for k, v in zip(keys, vals):
        out[k] = int(round(v)) if k.startswith("rays_") else v
    out["rays_terminated"] = out["rays_launched"] - out["rays_alive_at_end"]
    return out


def rank_stats(mesh: Ranks, widths: list, busy: float, **per_rank) -> dict:
    """The stats of a run with a process group that show its balance: the
    backend, every rank's tile widths and busy seconds, slowest over mean,
    the seconds in collectives, and any other per-rank number as
    ``rank_<name>``.  Empty without a group."""
    if not mesh.distributed:
        return {}
    busy_all = [r[0] for r in rank_rows([busy], mesh)]
    out = {"dist_backend": mesh.backend,
           "rank_tile_widths": [[int(w) for w in r]
                                for r in rank_rows(widths, mesh)],
           "rank_busy_seconds": busy_all,
           "busy_slowest_over_mean": max(busy_all) / (sum(busy_all)
                                                      / len(busy_all))}
    for name, v in per_rank.items():
        out[f"rank_{name}"] = [type(v)(r[0]) for r in rank_rows([v], mesh)]
    out["collective_seconds"] = mesh.collective_seconds
    return out


def run_sharded_state(cfg, field4, state0: RayState, rays_per_tile: int,
                      mesh: Ranks, compact: bool = False):
    """Pad, keep the rank's range, trace, sum: ``(edep np.float64, the
    rank's final state)`` on every rank."""
    from ..models.raytracer import check_overflow
    state = local_state(state0, mesh, rays_per_tile * cfg.tiles_per_block)
    fn = make_sharded_trace_fn(cfg, mesh, compact=compact)
    edep, state, oflow, _, _ = fn(field4.to(state.uray.device), state)
    check_overflow(oflow, cfg)
    return edep.to("cpu", torch.float64).numpy(), state


def run_sharded(ctx, group=None, device=None, compact: bool = False):
    """Convenience entry (``sharding.py:231``): the context's traced state
    (``raytracer.traced_state``) over the ranks of ``group``, each on
    ``device`` (default: the card, ``raytracer.default_device``).  Returns
    ``(edep np.float64, the rank's final state)``."""
    from ..models import raytracer as rt
    device = torch.device(device) if device is not None else \
        rt.default_device()
    return run_sharded_state(ctx.cfg, ctx.field4, rt.traced_state(ctx, device),
                             ctx.layout.rays_per_tile, make_mesh(group),
                             compact=compact)


def rank_beams(nbeams: int, world: int) -> list[tuple[int, int]]:
    """``(first beam, beam count)`` of each rank: whole beams, in rank
    order, ``ceil(B / W)`` or ``floor(B / W)`` each; ranks beyond the beam
    count own none."""
    base, extra = divmod(nbeams, world)
    out, b0 = [], 0
    for r in range(world):
        n = base + (r < extra)
        out.append((b0, n))
        b0 += n
    return out


__all__ = ["Ranks", "make_mesh", "all_reduce_sum", "all_reduce_max",
           "all_gather_rows", "rank_rows", "pad_rays", "local_state",
           "make_sharded_trace_fn", "reduce_trace_stats", "rank_stats",
           "run_sharded",
           "run_sharded_state", "rank_beams", "single_rank_only", "barrier"]
