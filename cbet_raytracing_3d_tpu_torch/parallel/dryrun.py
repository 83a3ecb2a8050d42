"""Multi-rank dry run on the CPU: the port's counterpart of
``__graft_entry__.py::dryrun_multichip`` (:30-160).

    python -m cbet_raytracing_3d_tpu_torch.parallel.dryrun 4

spawns N gloo ranks on the CPU (``multihost.spawn_ranks``) and runs the
slice's parallel paths on the small scene, as the JAX dry run's
``_dryrun_body`` does:

* the plain and the compacted sharded trace (``runner.run`` without and with
  a cache dir): compacted = plain within float64 rounding, the same
  ``trace_stats``;
* the CBET layouts: lookup and kernel_cell with whole beams per rank
  (``nbeams == N``, compacted), lookup with uneven beams (N + 1 beams: where
  the JAX mesh solve falls back to its scatter layout) and more ranks than
  beams (one beam on N ranks: the others own none).

Every rank must return the same finite result.  One rank (N = 1) runs the
single-device solves of the JAX dry run instead.  Prints ``DRYRUN_OK``.
"""

from __future__ import annotations

import sys

import numpy as np

from ..config import Config


def small_config(**kw) -> Config:
    """The JAX dry run's scene (``__graft_entry__._small_cfg``): 4 beams,
    one ray per zone on a 24^3 grid, 96 steps in chunks of 8; float64 here,
    so the compacted trace can be held to the plain one."""
    return Config(nbeams=4, rays_per_zone=1, nx=24, ny=24, nz=24,
                  chunk_steps=8, dtype="float64").replace(**kw)


def cbet_cases(world: int) -> list[tuple[int, str, bool]]:
    """``(beams, gain mode, compacted)`` of each CBET case on ``world``
    ranks (``__graft_entry__.py:94-101``)."""
    if world == 1:
        return [(2, "kernel_cell", False), (1, "lookup", False)]
    return [(world + 1, "lookup", False), (world, "lookup", True),
            (world, "kernel_cell", True), (1, "lookup", False)]


def _rank(rank: int, world: int) -> list:
    import torch
    torch.set_num_threads(1)
    from ..models import raytracer as rt
    from ..models.cbet import cbet_solve
    from ..runner import run

    cfg = small_config()
    plain = run(cfg, device="cpu", verbose=False)
    comp = run(cfg, device="cpu", verbose=False, cache_dir="unused")
    ref = np.linalg.norm(plain.edep)
    rel = float(np.linalg.norm(comp.edep - plain.edep) / ref)
    keys = ("rays_launched", "rays_alive_at_end", "rays_terminated")
    if not (ref > 0 and rel < 1e-12 and plain.stats["devices"] == world
            and all(plain.stats[k] == comp.stats[k] for k in keys)):
        raise RuntimeError(f"rank {rank}: compacted vs plain trace rel-L2 "
                           f"{rel}, stats {plain.stats} / {comp.stats}")
    out = [float(plain.edep.sum()), float(comp.edep.sum())]
    for nb, mode, seg in cbet_cases(world):
        c = small_config(nbeams=nb, cbet_max_iters=2, cbet_segmented=seg,
                         tiles_per_block=1, cbet_gain_mode=mode,
                         deposit_batch_steps=4 if mode == "kernel_cell"
                         else 1)
        res = cbet_solve(c, rt.prepare(c), "cpu")
        want = "beam_sharded" if world > 1 else "grouped"
        if not (res.stats["intensity_mode"] == want
                and np.isfinite(res.edep).all() and res.edep.sum() > 0
                and np.isfinite(res.intensity).all()
                and res.intensity.sum() > 0):
            raise RuntimeError(f"rank {rank}: CBET case {(nb, mode, seg)} "
                               f"gave mode {res.stats['intensity_mode']}, "
                               f"edep sum {res.edep.sum()}")
        out += [float(res.edep.sum()), float(res.intensity.sum())]
    return out


def dryrun_multichip(n: int, timeout: float = 600.0) -> list:
    """Run the dry run on ``n`` gloo CPU ranks; raise unless every rank
    passed and all returned the same sums.  Returns rank 0's sums."""
    from .multihost import spawn_ranks
    sums = spawn_ranks(_rank, n, timeout=timeout)
    if any(s != sums[0] for s in sums[1:]):
        raise RuntimeError(f"the ranks disagree: {sums}")
    return sums[0]


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
    print("DRYRUN_OK")
