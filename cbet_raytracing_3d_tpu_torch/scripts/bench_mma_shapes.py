"""Tensor-core throughput of the probe kernel (K6) at the six matmul shapes
of the JAX package's ``scripts/bench_mxu_shapes.py``, on one NVIDIA card.

    python -m cbet_raytracing_3d_tpu_torch.scripts.bench_mma_shapes

For each shape: one warm-up launch of the probe (wgmma + TMA), then the
fastest of 3 launches timed with CUDA events; each launch computes ``REPS``
products ``GRID`` times (``ops/mma_probe.py``).  Prints the microseconds per
product, TFLOP/s and share of the card's dense bf16 peak (989 TFLOP/s), the
milliseconds per launch and the bound, with the card's name and power limit
from ``nvidia-smi``.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from ..ops import mma_probe as mp


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def operands(m: int, k: int, n: int, transpose_lhs: bool, device,
             seed: int = 0):
    """Uniform [0, 1) bf16 operands from a seed, as the TPU script makes
    them."""
    rng = np.random.default_rng(seed)
    ashape = (k, m) if transpose_lhs else (m, k)
    a = torch.as_tensor(rng.random(ashape, np.float32), device=device)
    b = torch.as_tensor(rng.random((k, n), np.float32), device=device)
    return a.to(torch.bfloat16), b.to(torch.bfloat16)


def time_launch(fn, repeats: int = 3) -> float:
    """Seconds of the fastest of ``repeats`` synchronized calls of ``fn``
    after one warm-up call, each timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) / 1e3)
    return best


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_mma_shapes: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"device={torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{card_line()}; grid {mp.GRID} x reps {mp.REPS} products per "
          "launch")
    for label, m, k, n, tr in mp.SHAPES:
        a, b = operands(m, k, n, tr, dev)
        secs = time_launch(lambda: mp.mma_probe(a, b, mp.REPS, tr, mp.GRID))
        per_mm = secs / (mp.GRID * mp.REPS)
        rate = 2 * m * k * n / per_mm
        print(f"{label:42s} {per_mm * 1e6:8.3f} us/mm  "
              f"{2 * m * k * n / 1e6:6.1f} MF -> {rate / 1e12:7.2f} TFLOP/s "
              f"= {100 * rate / mp.PEAK_BF16:5.1f}% of bf16 peak; "
              f"{secs * 1e3:.4f} ms per launch, bound "
              f"{mp.bound_seconds(m, k, n) * 1e3:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
