"""Two-process multi-host smoke of the port: each process is one "host" with
one CPU device; gloo collectives over localhost TCP stand in for the
network between hosts.  The port's counterpart of the JAX package's
``scripts/smoke_multihost.py``.

    python -m cbet_raytracing_3d_tpu_torch.scripts.smoke_multihost \\
        <process_id> <num_processes> <port>

Each process joins the group at ``tcp://127.0.0.1:<port>``
(``parallel.multihost.initialize_multihost``), traces its share of a tiny
scene through the multi-host entry (``run_sharded_multihost``), then
recomputes the whole scene alone and checks that the summed grid matches to
float64 rounding.  Prints ``MULTIHOST OK ...`` on success.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..models import raytracer as rt
from ..parallel import multihost as mhost


def main(pid: int, nproc: int, port: int) -> int:
    torch.set_num_threads(1)
    mhost.initialize_multihost(f"127.0.0.1:{port}", nproc, pid,
                               backend="gloo", timeout_seconds=120)
    try:
        if dist.get_world_size() != nproc:
            raise RuntimeError(f"process group did not form: "
                               f"{dist.get_world_size()} != {nproc}")
        cfg = Config(nbeams=2, rays_per_zone=1, nx=40, ny=40, nz=40,
                     dtype="float64", tiles_per_block=1)
        ctx = rt.prepare(cfg)
        rpt = ctx.layout.rays_per_tile
        # a few whole live tiles, the same on every process
        tiles = np.unique(ctx.live_slots // rpt)[: 2 * nproc]
        state0 = rt.select_rays(ctx.state0, rt.tile_slots(tiles, rpt))
        edep_mh, _ = mhost.run_sharded_multihost(cfg, ctx.field4, state0,
                                                 rpt)
        edep_1, _, of1, _ = rt.make_trace_fn(cfg)(ctx.field4, state0)
        edep_1 = edep_1.numpy()
        den = np.linalg.norm(edep_1)
        rel = float(np.linalg.norm(edep_mh - edep_1) / den)
        if not (int(of1) == 0 and den > 0 and rel < 1e-12):
            raise RuntimeError(f"multi-host grid mismatch: rel-L2 {rel}")
        print(f"MULTIHOST OK proc={pid}/{nproc} "
              f"devices={dist.get_world_size()} "
              f"edep_total={edep_mh.sum():.17g} rel_l2={rel:.3g}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(*(int(a) for a in sys.argv[1:4])))
