"""The one-step deposit kernel on BASELINE config 4's steps.

    python -m cbet_raytracing_3d_tpu_torch.scripts.step_sweep [--reps 10]

Captures the rows of two steps of config 4's composed trace
(``scripts/config4.CONFIG4``; :class:`Capture` over the trace's own chunk
loop): the first step (54,000,000 rows) and the first step after the trace's
width halved (a compacted mid-trace chunk), and one step of the OMEGA trace
150 steps in (``scripts/box_sweep.trace_window``).  On each it prints the
tile box's volume per block of 256 rays (quantiles over the blocks with
rows), then times, with CUDA events over ``--reps`` calls in two passes
(forward, then backward; the OMEGA step's calls queued behind a device-side
sleep, since it takes less time on the card than its launch), the one-step
kernel (``deposit``'s path), the window kernel at one step
(``_launch(one_step=False)``: the tile box a float step took before the
one-step kernel), the direct kernel (one thread per row) and the plain
version.

Each line carries its rel-L2 from the plain version, the blocks that took
the box, and the energy balance: the grid's float64 sum against the float64
sum of the rows' float32 corner values.  The card's name and power limit
head the output.  Exits 1 when a result misses 1e-6 rel-L2 from the plain
version, 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..config import Config
from ..models import raytracer as rt
from ..ops import deposit as dep
from .bench_mma_shapes import card_line
from .box_sweep import trace_window
from .config4 import CONFIG4

#: the bar against the plain version (rel-L2, float32)
TOL = 1e-6


class Capture:
    """A deposit entry point (``fn(grid, *rows)``) that keeps device copies
    of the rows of its first call and of the first call with fewer than
    half as many rows (the first step after the trace's width has halved:
    a compacted mid-trace chunk), then stops the trace (:class:`Done`).
    ``got`` holds ``(rows, call index)``: the call index is the step."""

    class Done(Exception):
        pass

    def __init__(self, fn):
        self.fn, self.calls, self.got = fn, 0, []

    def __call__(self, grid, *rows):
        n = rows[0].shape[0]
        if not self.got or n < self.got[0][0][0].shape[0] // 2:
            self.got.append((tuple(a.clone() if torch.is_tensor(a) else a
                                   for a in rows), self.calls))
        self.calls += 1
        out = self.fn(grid, *rows)
        if len(self.got) == 2:
            raise self.Done
        return out


def capture_config4(cfg, ctx, device):
    """The rows of config 4's two steps (:class:`Capture` over
    ``raytracer.ChunkedTrace``, which deposits through ``deposit``):
    ``[(rows, step), (rows, step)]``."""
    cap = Capture(dep.deposit)
    chunks = rt.ChunkedTrace(cfg, cap, compact=True)
    carry = chunks.start(rt.traced_state(ctx, device))
    try:
        while chunks.advance(ctx.field4, carry):
            pass
    except Capture.Done:
        pass
    if len(cap.got) != 2:
        raise RuntimeError(f"config 4's steps not captured ({cap.calls} "
                           "calls)")
    return cap.got


def box_volumes(rows, shape) -> list:
    """Nodes of each block's box (the bounds of its live in-grid rows'
    corners) for the one-step kernel's blocks of 256 consecutive rows, over
    the blocks with such rows."""
    threads = 256
    cells, fracs, inc = rows[:3], rows[3:6], rows[6]
    n = inc.shape[0]
    blocks = -(-n // threads)
    live = inc != 0
    lo, hi = [], []
    for c, f, size in zip(cells, fracs, shape):
        s = torch.where(f < 0.5, -1, 1).to(torch.int32)
        a, b = c + 1 + torch.clamp(s, max=0), c + 1 + torch.clamp(s, min=0)
        live &= (a >= 0) & (b < size)
        lo.append(a)
        hi.append(b)
    vol = torch.ones(blocks, dtype=torch.int64, device=inc.device)
    pad = blocks * threads - n
    keep = torch.nn.functional.pad(live, (0, pad)).view(blocks, threads)
    for a, b in zip(lo, hi):
        a = torch.nn.functional.pad(a, (0, pad)).view(blocks, threads)
        b = torch.nn.functional.pad(b, (0, pad)).view(blocks, threads)
        big = torch.iinfo(torch.int32).max
        amin = torch.where(keep, a, big).amin(1)
        bmax = torch.where(keep, b, -big).amax(1)
        vol *= (bmax - amin + 1).clamp(min=0).to(torch.int64)
    return vol[keep.any(1)].tolist()


def quantiles(vals: list) -> str:
    s = sorted(vals)
    pick = {q: s[min(len(s) - 1, int(q * len(s)))] for q in (0.5, 0.9, 0.99)}
    return (f"median {pick[0.5]}, p90 {pick[0.9]}, p99 {pick[0.99]}, max "
            f"{s[-1]} ({len(s)} blocks)")


def corner_total(rows, shape) -> float:
    """The float64 sum of the rows' float32 corner values (live in-grid
    rows): what a grid from zeros must hold in all."""
    idx, val, ok = dep._corner_parts(*rows, shape)
    return float(val[ok & (rows[6] != 0)].double().sum())


def cuda_ms(fn, reps: int, queued: bool) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, CUDA events after
    a warm-up call; ``queued`` holds the stream with a device-side sleep
    (~25 ms) while the host enqueues the calls, so that calls shorter than
    their launch run back to back."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def sweep(name, rows, shape, reps, device, out, queued=False) -> list:
    """Times every launch on one step (``queued`` as in :func:`cuda_ms`)
    and prints a line each; returns the names of the launches that missed
    the bar."""
    n = rows[0].shape[0]
    live = int((rows[6] != 0).sum())
    want, _ = dep.deposit_reference(
        torch.zeros(shape, dtype=torch.float32, device=device), *rows)
    total = corner_total(rows, shape)
    out(f"{name}: {n} rows ({live} live) into {tuple(shape)}; box volume "
        f"per block of 256 rays: {quantiles(box_volumes(rows, shape))}")
    cases = {
        "one-step kernel (deposit)": lambda g, tally=None: dep._launch(
            g, *rows, tally=tally),
        "window kernel at one step": lambda g, tally=None: dep._launch(
            g, *rows, tally=tally, one_step=False),
        "direct kernel": lambda g, tally=None: dep._launch(
            g, *rows, box_nodes=0),
        "plain": lambda g, tally=None: dep.deposit_reference(g, *rows),
    }
    missed = []
    grid = torch.zeros(shape, dtype=torch.float32, device=device)
    ms = {k: [] for k in cases}
    for order in (list(cases), list(cases)[::-1]):
        for k in order:
            ms[k].append(cuda_ms(lambda: cases[k](grid), reps, queued))
    for k, fn in cases.items():
        g = torch.zeros(shape, dtype=torch.float32, device=device)
        tally = torch.zeros(2, dtype=torch.int32, device=device)
        fn(g, tally)
        torch.cuda.synchronize()
        err = float(torch.linalg.vector_norm((g - want).double())
                    / torch.linalg.vector_norm(want.double()))
        bal = float(g.double().sum()) / total - 1
        if not err < TOL:
            missed.append(f"{name}: {k}")
        out(f"{name}: {k}: {sum(ms[k]) / 2:.4f} ms ({ms[k][0]:.4f} / "
            f"{ms[k][1]:.4f}); rel-L2 vs plain {err:.3e}; energy balance "
            f"{bal:.3e}; blocks in the box {int(tally[1])} of "
            f"{int(tally[0])}")
    return missed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")

    def out(msg):
        print(msg, flush=True)
    out(f"device={torch.cuda.get_device_name(0)}; nvidia-smi: "
        f"{card_line()}; torch {torch.__version__}")
    t0 = time.perf_counter()
    missed = []
    ctx = rt.prepare_device(CONFIG4, device=dev)
    steps = capture_config4(CONFIG4, ctx, dev)
    del ctx
    for case, (rows, step) in zip(("config 4 first step", "config 4 "
                                   "mid-trace"), steps):
        missed += sweep(f"{case} (step {step})", rows, CONFIG4.edep_shape,
                        args.reps, dev, out)
    del steps
    cfg = Config()
    *flat, n = trace_window(cfg, rt.prepare(cfg), dev, 3 * cfg.nt // 8)
    # a step of 1.1M rows takes less time on the card than its launch
    missed += sweep("OMEGA one step (step 150)", [a[:n] for a in flat],
                    cfg.edep_shape, 4 * args.reps, dev, out, queued=True)
    out(f"step_sweep: {time.perf_counter() - t0:.1f} s; missed: {missed}")
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
