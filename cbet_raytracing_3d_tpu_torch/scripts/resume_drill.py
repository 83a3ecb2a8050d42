"""A resume drill of the port's resumable trace at BASELINE config 4
(``scripts/config4.CONFIG4``: 200^3, 64,273,500 rays, nt = 800, f32, a
deposit per step) on one NVIDIA card, from the root of a checkout:

    python -m cbet_raytracing_3d_tpu_torch.scripts.resume_drill [--stop 12]

``runner.run_composed`` is stopped after ``--stop`` chunks with a
checkpoint, the checkpoint is read and written once more for its seconds
and bytes, and the run is resumed to the end (seconds, peak device memory
against ``runner.estimate_device_bytes``, ``edep_total`` against
``energy_absorbed``).  These are the calls ``cli run --composed
--checkpoint PATH [--resume]`` makes; the peak memory is read in-process.
The converged coupled solve of config 4 is ``scripts/config4.py --stage
cbet``.  Checkpoints go to ``out/c4/`` (several GB) and are removed.  Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from .. import runner
from ..utils import checkpoint as ckm
from .bench_mma_shapes import card_line
from .config4 import CONFIG4

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
    cfg = CONFIG4
    dev = torch.device("cuda")
    os.makedirs("out/c4", exist_ok=True)
    ck = "out/c4/trace.ckpt.npz"
    est = runner.estimate_device_bytes(cfg) / GiB
    print(f"card {card_line()}; nt {cfg.nt}, rays {cfg.total_rays}, estimate "
          f"{est:.2f} GiB", flush=True)

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
    del res
    os.remove(ck)
    return 0


if __name__ == "__main__":
    sys.exit(main())
