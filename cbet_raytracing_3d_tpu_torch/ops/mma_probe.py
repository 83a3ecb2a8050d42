"""Tensor-core throughput probe: the CUDA kernel and its plain PyTorch
version.

Counterpart of ``scripts/bench_mxu_shapes.py::make_mm_kernel`` (K6): the
TPU kernel runs a grid of ``GRID`` identical steps, each accumulating
``reps`` bf16 products of VMEM-resident operands into an f32 block, to time
the matrix unit at the deposit and lookup matmul shapes of that script.  The
kernel is ``csrc/mma_probe.cu`` (``mma.sync`` through ``nvcuda::wmma``,
operands streamed through shared memory); its header says how it differs
from the TPU kernel.

``mma_probe(a, b, reps=REPS, transpose_lhs=False, grid=GRID) -> out``: ``a``
is a bf16 (m, k) tensor, or (k, m) with ``transpose_lhs``; ``b`` a bf16
(k, n) tensor; ``out`` the float32 (m, n) sum of ``reps`` products
``A.B`` (``A^T.B``), which one launch computes ``grid`` times over.
m, k and n are multiples of 16.

What bounds it on the card: the operations, ``2*m*k*n*reps*grid /
PEAK_BF16`` seconds (:func:`bound_seconds`); its operands and output are a
few MB.

The wrapper launches the kernel for CUDA tensors (after checking device,
dtype, shape and contiguity; it raises on anything else) and takes the plain
version only for CPU tensors.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .deposit import _on_cpu, _raise_on

#: number of probe-kernel launches in this process (the plain version and
#: the CPU path do not count)
LAUNCHES = 0

#: the TPU script's grid repetitions and products per step
GRID = 512
REPS = 8
#: dense bf16 tensor-core peak of an H100 SXM at 700 W, flop/s (NVIDIA's
#: data sheet)
PEAK_BF16 = 989e12
#: the six shapes of ``bench_mxu_shapes.py:78-84``: (label, m, k, n,
#: transpose_lhs)
SHAPES = (
    ("deposit (1280,896)^T@(1280,128)", 896, 1280, 128, True),
    ("deposit small (320,480)^T@(320,128)", 480, 320, 128, True),
    ("lookup (256,896)@(896,128)", 256, 896, 128, False),
    ("lookup (256,432)@(432,128)", 256, 432, 128, False),
    ("lookup (64,432)@(432,128)", 64, 432, 128, False),
    ("lookup (256,432)@(432,256)", 256, 432, 256, False),
)


def flops(m: int, k: int, n: int, reps: int = REPS, grid: int = GRID) -> int:
    """The multiply-adds of one launch, counted as 2 operations each."""
    return 2 * m * k * n * reps * grid


def bound_seconds(m: int, k: int, n: int, reps: int = REPS,
                  grid: int = GRID) -> float:
    """The least time of one launch on the card: its operations at the
    dense bf16 peak (the bytes, a few MB, take microseconds)."""
    return flops(m, k, n, reps, grid) / PEAK_BF16


def _dims(a, b, transpose_lhs):
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("mma probe operands must be 2-D")
    k_a, m = a.shape if transpose_lhs else a.shape[::-1]
    k, n = b.shape
    if k_a != k:
        raise ValueError(f"contracted dims differ: a {tuple(a.shape)} "
                         f"(transpose_lhs={transpose_lhs}), b "
                         f"{tuple(b.shape)}")
    return m, k, n


def mma_probe_reference(a, b, reps: int = REPS, transpose_lhs: bool = False,
                        grid: int = GRID):
    """The plain PyTorch version: the float32 product of the bf16 values,
    summed ``reps`` times; ``grid`` repeats the same values and does not
    change them.  Same contract as :func:`mma_probe`, on any device."""
    _dims(a, b, transpose_lhs)
    af = a.float()
    p = (af.t() if transpose_lhs else af) @ b.float()
    out = torch.zeros_like(p)
    for _ in range(reps):
        out = out + p
    return out


def mma_probe(a, b, reps: int = REPS, transpose_lhs: bool = False,
              grid: int = GRID):
    """The probe: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  Returns a new float32 (m, n) tensor."""
    global LAUNCHES
    if _on_cpu(a, (b,), "mma probe"):
        return mma_probe_reference(a, b, reps, transpose_lhs, grid)
    m, k, n = _dims(a, b, transpose_lhs)
    for t in (a, b):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"mma probe operands must be bfloat16, got "
                            f"{t.dtype}")
        if t.device != a.device or not t.is_contiguous():
            raise ValueError("mma probe operands must be contiguous tensors "
                             f"on {a.device}")
    if m % 16 or k % 16 or n % 16:
        raise ValueError(f"m, k, n must be multiples of 16, got {m}, {k}, "
                         f"{n}")
    if reps < 1 or not 1 <= grid <= 65535:
        raise ValueError(f"reps must be >= 1 and grid in [1, 65535], got "
                         f"{reps}, {grid}")
    from ..utils import cuda_build
    lib = cuda_build.load()
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.cbet_mma_probe_bf16(a.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), m, k, n, reps,
                                     int(transpose_lhs), grid, stream)
    _raise_on(rc, lib, "mma probe")
    LAUNCHES += 1
    return out
