"""Tensor-core throughput probe: the CUDA kernel and its plain PyTorch
version.

Counterpart of ``scripts/bench_mxu_shapes.py::make_mm_kernel`` (K6): the
TPU kernel runs a grid of ``GRID`` identical steps, each accumulating
``reps`` bf16 products of VMEM-resident operands into an f32 block, to time
the matrix unit at the deposit and lookup matmul shapes of that script.  The
kernel is ``csrc/mma_probe.cu``: ``wgmma.mma_async`` m64n128k16 fed by TMA
loads through a ring of shared-memory stages; its header says how it differs
from the TPU kernel.  The earlier ``mma.sync`` kernel stays in that file for
the in-turn comparison only (:func:`_launch` with ``variant="wmma"``).

``mma_probe(a, b, reps=REPS, transpose_lhs=False, grid=GRID) -> out``: ``a``
is a bf16 (m, k) tensor, or (k, m) with ``transpose_lhs``; ``b`` a bf16
(k, n) tensor; ``out`` the float32 (m, n) sum of ``reps`` products
``A.B`` (``A^T.B``), which one launch computes ``grid`` times over.
m, k and n are multiples of 16.

Rounding.  The tensor cores truncate when they add into their accumulator.
The kernel chains the 64-deep k-slices of one product there (``k / 16``
steps) and adds each product into the float32 sum with a rounded add, as the
TPU kernel's ``acc + dot`` does: ``reps`` rounded adds.  Where the whole k
fits the kernel's ring of shared-memory stages (k <= 384) the slices stay
there for all ``reps`` products, else they are streamed again for each.
:func:`_launch` can cut the chain shorter (``chain_slices``;
:func:`mma_probe_reference` with ``chain=64 * chain_slices`` is the same
grouping in plain PyTorch) and keep such a run resident: that is faster at
long k and rounds more often, and is kept for measurements only.

What bounds it on the card: the operations, ``2*m*k*n*reps*grid /
PEAK_BF16`` seconds (:func:`bound_seconds`); its operands and output are a
few MB.

The wrapper launches the kernel for CUDA tensors (after checking device,
dtype, shape and contiguity; it raises on anything else) and takes the plain
version only for CPU tensors.  ``LAUNCHES`` counts the launches of the
wgmma kernel, ``WMMA_LAUNCHES`` those of the ``mma.sync`` kernel.
"""

from __future__ import annotations

import torch

from .deposit import _on_cpu, _raise_on

#: number of launches of the wgmma probe kernel in this process (the plain
#: version and the CPU path do not count)
LAUNCHES = 0
#: number of launches of the earlier ``mma.sync`` kernel (``variant="wmma"``)
WMMA_LAUNCHES = 0

#: the TPU script's grid repetitions and products per step
GRID = 512
REPS = 8
#: dense bf16 tensor-core peak of an H100 SXM at 700 W, flop/s (NVIDIA's
#: data sheet)
PEAK_BF16 = 989e12
#: k depth of one shared-memory stage of the kernel
SLICE = 64
#: 64-deep slices the public wrapper chains in the wgmma accumulator between
#: two rounded adds: None is the whole k, one rounded add per product
CHAIN_SLICES = None
VARIANTS = ("wgmma", "wmma")
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
                        grid: int = GRID, chain: int | None = None):
    """The plain PyTorch version: the float32 product of the bf16 values,
    summed ``reps`` times; ``grid`` repeats the same values and does not
    change them.  Same contract as :func:`mma_probe`, on any device.

    ``chain`` (a k depth; default the whole k) cuts the product into
    partial products over runs of ``chain`` of k, as the kernel chains its
    slices: run by run, each run's partial product is added ``reps``
    times.  The sum is the same up to float32 rounding."""
    _, k, _ = _dims(a, b, transpose_lhs)
    if chain is not None and chain < 1:
        raise ValueError(f"chain must be >= 1, got {chain}")
    af = a.float().t() if transpose_lhs else a.float()
    bf = b.float()
    step = k if chain is None else min(chain, k)
    out = torch.zeros((af.shape[0], bf.shape[1]), dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, k, step):
        p = af[:, k0:k0 + step] @ bf[k0:k0 + step]
        for _ in range(reps):
            out = out + p
    return out


def mma_probe(a, b, reps: int = REPS, transpose_lhs: bool = False,
              grid: int = GRID):
    """The probe: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  Returns a new float32 (m, n) tensor."""
    if _on_cpu(a, (b,), "mma probe"):
        return mma_probe_reference(a, b, reps, transpose_lhs, grid)
    return _launch(a, b, reps, transpose_lhs, grid)


def _launch(a, b, reps: int = REPS, transpose_lhs: bool = False,
            grid: int = GRID, variant: str = "wgmma",
            chain_slices: int | None = CHAIN_SLICES,
            resident: bool | None = None):
    """One kernel launch on CUDA tensors, counted in ``LAUNCHES`` (wgmma) or
    ``WMMA_LAUNCHES`` (the ``mma.sync`` kernel).

    ``variant="wgmma"`` is the probe; ``chain_slices`` its chain length in
    64-deep slices (None: the whole k) and ``resident`` whether a chain's
    slices stay in shared memory for all ``reps`` products (the chain must
    then fit the ring, ``cbet_mma_probe_ring_slices()``) or are streamed
    again for every product (None: resident where the chain fits).
    ``variant="wmma"`` is the earlier ``mma.sync`` kernel, for comparisons."""
    global LAUNCHES, WMMA_LAUNCHES
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (expected one of "
                         f"{VARIANTS})")
    if not a.is_cuda:
        raise RuntimeError("the mma probe kernel needs CUDA tensors")
    m, k, n = _dims(a, b, transpose_lhs)
    for t in (a, b):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"mma probe operands must be bfloat16, got "
                            f"{t.dtype}")
        if t.device != a.device or not t.is_contiguous():
            raise ValueError("mma probe operands must be contiguous tensors "
                             f"on {a.device}")
        if t.data_ptr() % 16:
            raise ValueError("mma probe operands must be 16-byte aligned")
    if m % 16 or k % 16 or n % 16:
        raise ValueError(f"m, k, n must be multiples of 16, got {m}, {k}, "
                         f"{n}")
    if reps < 1 or not 1 <= grid <= 65535:
        raise ValueError(f"reps must be >= 1 and grid in [1, 65535], got "
                         f"{reps}, {grid}")
    from ..utils import cuda_build
    lib = cuda_build.load()
    nslices = -(-k // SLICE)
    run = nslices if chain_slices is None else min(chain_slices, nslices)
    ring = lib.cbet_mma_probe_ring_slices()
    if resident is None:
        resident = run <= ring
    if variant == "wgmma" and (run < 1 or (resident and run > ring)):
        raise ValueError(f"chain_slices={chain_slices}: a resident chain is "
                         f"1..{ring} slices")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if variant == "wgmma":
            rc = lib.cbet_mma_probe_bf16(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, reps,
                int(transpose_lhs), run, int(resident), grid, stream)
        else:
            rc = lib.cbet_mma_probe_wmma_bf16(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, reps,
                int(transpose_lhs), grid, stream)
    _raise_on(rc, lib, "mma probe")
    if variant == "wgmma":
        LAUNCHES += 1
    else:
        WMMA_LAUNCHES += 1
    return out
