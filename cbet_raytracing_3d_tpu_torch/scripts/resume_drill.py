"""A resume drill of the port's resumable paths at BASELINE config 4 (200^3,
64,273,500 rays, nt = 800, f32) on one NVIDIA card, from the root of a
checkout:

    python -m cbet_raytracing_3d_tpu_torch.scripts.resume_drill [--stop 12]

``runner.run_composed`` is stopped after ``--stop`` chunks with a
checkpoint, the checkpoint is read and written once more for its seconds
and bytes, and the run is resumed to the end (seconds, peak device memory
against ``runner.estimate_device_bytes``, ``edep_total`` against
``energy_absorbed``).  Then ``cbet_solve_composed`` runs iteration 0 and 1
(``cbet_max_iters=1``) on the same scene with 4 serial beam groups and with
1.  These are the calls ``cli run --composed [--cbet --cbet-only]`` makes;
the peak memory is read in-process.  Checkpoints go to ``out/c4/`` (several
GB) and are removed.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from .. import runner
from ..config import Config
from ..models.cbet_composed import cbet_solve_composed
from ..utils import checkpoint as ckm
from .bench_mma_shapes import card_line

GiB = 2 ** 30


def timed(fn):
    """(result, seconds, peak GiB allocated) of ``fn``, synchronized."""
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t, torch.cuda.max_memory_allocated() / GiB


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stop", type=int, default=12,
                    help="chunks before the interruption")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("resume_drill: no CUDA device", file=sys.stderr)
        return 1
    cfg = Config(nx=200, ny=200, nz=200, rays_per_zone=15, tile_zones=2,
                 deposit_box_x=24, deposit_box_y=24, deposit_box_z=24,
                 cbet_grid_downsample=2, cbet_max_iters=1)
    dev = torch.device("cuda")
    os.makedirs("out/c4", exist_ok=True)
    ck = "out/c4/trace.ckpt.npz"
    est = [runner.estimate_device_bytes(cfg) / GiB] + [
        runner.estimate_device_bytes(cfg, True, g, False) / GiB
        for g in (1, 4)]
    print(f"card {card_line()}; nt {cfg.nt}, rays {cfg.total_rays}, estimate "
          f"trace {est[0]:.2f} GiB, cbet alone 1 group {est[1]:.2f}, 4 groups "
          f"{est[2]:.2f}", flush=True)

    _, t_a, p_a = timed(lambda: runner.run_composed(
        cfg, device=dev, verbose=True, checkpoint_path=ck,
        stop_after_chunks=args.stop))
    print(f"A: stopped after {args.stop} chunks: {t_a:.2f} s, peak "
          f"{p_a:.2f} GiB, checkpoint {os.path.getsize(ck)} bytes",
          flush=True)
    fp = ckm.run_fingerprint(cfg, dev, "composed")
    t = time.perf_counter()
    loaded = ckm.load_composed_checkpoint(ck, fp, dev)
    torch.cuda.synchronize()
    t_r = time.perf_counter() - t
    t = time.perf_counter()
    ckm.save_composed_checkpoint("out/c4/again.npz", fp, *loaded)
    t_w = time.perf_counter() - t
    print(f"checkpoint of chunk {loaded[0]}: state {loaded[3].n} slots, "
          f"read {t_r:.2f} s, write {t_w:.2f} s", flush=True)
    del loaded
    os.remove("out/c4/again.npz")

    res, t_b, p_b = timed(lambda: runner.run_composed(
        cfg, device=dev, verbose=True, checkpoint_path=ck, resume=True))
    st = res.stats
    print(f"B: resumed: {t_b:.2f} s, peak {p_b:.2f} GiB, timings "
          f"{res.timings}; edep_total {st['edep_total']:.10e} "
          f"energy_absorbed {st['energy_absorbed']:.10e} rel "
          f"{abs(st['edep_total'] / st['energy_absorbed'] - 1):.3e}; stats "
          f"{st}", flush=True)
    ctx = res.ctx
    del res
    os.remove(ck)

    for g in (4, 1):
        path = f"out/c4/cbet{g}.ckpt.npz"
        try:
            r, t_c, p_c = timed(lambda: cbet_solve_composed(
                cfg, ctx, device=dev, beam_groups=g, checkpoint_path=path,
                verbose=True))
        except (RuntimeError, torch.cuda.OutOfMemoryError) as e:
            print(f"C: cbet composed, {g} groups FAILED: "
                  f"{type(e).__name__}: {str(e)[:500]}", flush=True)
        else:
            print(f"C: cbet composed, {g} groups: {t_c:.2f} s, peak "
                  f"{p_c:.2f} GiB, iter_seconds {r.stats['iter_seconds']}, "
                  f"history {r.history}, edep_total "
                  f"{r.stats['edep_total']:.10e}, energy_absorbed "
                  f"{r.stats['energy_absorbed']:.10e}, checkpoint "
                  f"{os.path.getsize(path)} bytes", flush=True)
            del r
            os.remove(path)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
