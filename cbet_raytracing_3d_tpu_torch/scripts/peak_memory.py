"""Peak device memory of the on-card init, of every chunk of the compacted
trace and of the composed CBET solve, beside ``runner.estimate_device_bytes``,
on one NVIDIA card, from the root of a checkout:

    python -m cbet_raytracing_3d_tpu_torch.scripts.peak_memory [--config4]
        [--cbet]

Scenes: OMEGA (``Config()``) in float32 and float64; with ``--config4`` also
BASELINE config 4 (``scripts/config4.CONFIG4``: 200^3, 64,273,500 rays,
nt = 800, float32, a deposit per step).  For each: the peak of
``prepare_device`` and, chunk by chunk over ``raytracer.ChunkedTrace`` (the
loop ``runner.run_composed`` runs), the slots traced and the peak of that
chunk (``torch.cuda.max_memory_allocated``, reset before each), in bytes and
in bytes per slot of the traced state, then the largest of them against the
estimate.  With ``--cbet``, for each float32 scene, the converged
``cbet_solve_composed`` on that prepared scene with 1 and with 4 serial beam
groups: its peak above what the scene holds, against the estimate of the
CBET stage alone (``trace=False``).  These are the measurements the
estimate's per-slot terms are fitted to.  Exits non-zero without a CUDA
device, and 2 if a peak exceeds the estimate.
"""

from __future__ import annotations

import argparse
import gc
import sys

import torch

from .. import runner
from ..config import Config
from ..models import raytracer as rt
from ..models.cbet_composed import cbet_solve_composed
from .bench_mma_shapes import card_line
from .config4 import CONFIG4

GiB = 2 ** 30


def _mark() -> None:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _peak() -> int:
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def measure(name: str, cfg: Config, dev, cbet: bool = False) -> bool:
    est = runner.estimate_device_bytes(cfg)
    _mark()
    base = torch.cuda.memory_allocated()
    ctx = rt.prepare_device(cfg, device=dev)
    p_init = _peak() - base
    n0 = ctx.state0.n
    print(f"{name}: {n0} slots traced; init peak {p_init} bytes = "
          f"{p_init / n0:.1f} per slot; held after init "
          f"{torch.cuda.memory_allocated() - base}", flush=True)
    chunks = rt.ChunkedTrace(cfg, compact=True)
    carry = chunks.start(rt.traced_state(ctx, dev))
    worst = p_init
    _mark()
    while chunks.advance(ctx.field4, carry):
        p = _peak() - base
        worst = max(worst, p)
        held = torch.cuda.memory_allocated() - base
        print(f"  chunk {carry.chunk}: {carry.state.n} slots "
              f"({carry.comp.width} tiles), peak {p} bytes = {p / n0:.1f} per "
              f"slot of the init's state, held {held}", flush=True)
        _mark()
    chunks.finish(carry)
    worst = max(worst, _peak() - base)
    ok = worst <= est
    print(f"{name}: peak {worst / GiB:.3f} GiB, estimate_device_bytes "
          f"{est / GiB:.3f} GiB: {'ok' if ok else 'the estimate is low'}",
          flush=True)
    del carry, chunks
    if cbet and cfg.dtype == "float32":
        for groups in (1, 4):
            ok &= measure_cbet(name, cfg, ctx, dev, groups)
    del ctx
    return ok


def measure_cbet(name: str, cfg: Config, ctx, dev, groups: int) -> bool:
    """The converged composed solve on ``ctx`` in ``groups`` beam groups:
    its peak above what is held before it, against the estimate."""
    est = runner.estimate_device_bytes(cfg, True, groups, trace=False)
    _mark()
    base = torch.cuda.memory_allocated()
    r = cbet_solve_composed(cfg, ctx, device=dev, beam_groups=groups,
                            verbose=False)
    peak = _peak() - base
    n = ctx.state0.n
    ok = peak <= est
    print(f"{name} CBET, {groups} groups: {r.iterations} iterations; peak "
          f"{peak} bytes ({peak / GiB:.3f} GiB) above the {base} held, "
          f"{peak / (n // groups):.1f} per slot of a group of {n // groups}; "
          f"estimate_device_bytes {est} ({est / GiB:.3f} GiB): "
          f"{peak / est:.4f} of it, "
          f"{'ok' if ok else 'the estimate is low'}", flush=True)
    del r
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config4", action="store_true",
                    help="also BASELINE config 4 (about 25 GiB)")
    ap.add_argument("--cbet", action="store_true",
                    help="also the composed CBET solve of each float32 "
                         "scene, 1 and 4 beam groups")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("peak_memory: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"card {card_line()}", flush=True)
    scenes = [("OMEGA f32", Config()),
              ("OMEGA f64", Config(dtype="float64"))]
    if args.config4:
        scenes.append(("config 4 f32", CONFIG4))
    ok = [measure(name, cfg, dev, args.cbet) for name, cfg in scenes]
    return 0 if all(ok) else 2


if __name__ == "__main__":
    sys.exit(main())
