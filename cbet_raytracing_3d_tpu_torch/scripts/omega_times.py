"""Seconds of the OMEGA traces and the seeded kernel_cell CBET solve of the
checkout in the current directory, on one NVIDIA card:

    python3 cbet_raytracing_3d_tpu_torch/scripts/omega_times.py TAG

Each line is ``TAG what (median, [the 3 readings])`` after one warm-up call,
every reading synchronized: the uncompacted and the compacted trace
(``make_trace_fn``), then the seeded solve uncompacted and compacted
(``cbet_solve``) with its iterations.  It imports the package from the
current directory, so one copy of this file can time two checkouts in turns
(``cd`` into each: a process each, say parent, change, change, parent), which
is how two revisions are compared inside one call on one card.
"""

import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from cbet_raytracing_3d_tpu_torch.config import Config  # noqa: E402
from cbet_raytracing_3d_tpu_torch.models import cbet  # noqa: E402
from cbet_raytracing_3d_tpu_torch.models import raytracer as rt  # noqa: E402


def med(fn, n=3):
    fn()
    xs = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        xs.append(time.perf_counter() - t)
    return statistics.median(xs), [round(x, 4) for x in xs]


def main() -> int:
    tag = sys.argv[1] if len(sys.argv) > 1 else "tree"
    if not torch.cuda.is_available():
        print("omega_times: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = Config()
    ctx = rt.prepare_device(cfg, device=dev)
    plain = rt.make_trace_fn(cfg)
    comp = rt.make_trace_fn(cfg, compact=True)
    print(tag, "trace uncompacted",
          med(lambda: plain(ctx.field4, ctx.state0)), flush=True)
    print(tag, "trace compacted",
          med(lambda: comp(ctx.field4, ctx.state0)), flush=True)
    for seg in (False, True):
        c = cfg.replace(cbet_gain_mode="kernel_cell", cbet_segmented=seg,
                        cbet_plan_headroom=0.5)
        cbet.cbet_solve(c.replace(cbet_max_iters=1), ctx, dev)
        its = []
        print(tag, "kernel_cell solve seeded",
              "compacted" if seg else "uncompacted",
              med(lambda: its.append(cbet.cbet_solve(c, ctx, dev).iterations)),
              its[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
