"""Trilinear energy deposit: the CUDA kernel and its plain PyTorch version.

Counterpart of ``cbet_raytracing_3d_tpu/ops/pallas_deposit.py::
make_tile_deposit`` (and of ``make_tile_deposit_hbm``, whose contract the
same kernel covers at any grid size), with the plain version transcribing the
JAX package's XLA scatter backend (``models/raytracer.py::
_scatter_corner_parts``).  The kernel is ``csrc/deposit.cu``; its header says
what bounds it on the card.

``deposit(edep, cx, cy, cz, fx, fy, fz, inc) -> (edep, overflow)`` keeps the
TPU kernel's signature without its grid padding: ``edep`` is the natural
ghost-padded ``(nx+2, ny+2, nz+2)`` grid, updated IN PLACE and returned;
per-row inputs are flat ``(n,)`` tensors (int32 cells, floats of the grid's
dtype) in launch-tile order; ``overflow`` is a 0-dim int32 tensor counting
live rows with a corner outside the grid (0 when cells are clamped to the
grid, as the trace keeps them), which were not written.

The wrapper launches the kernel for CUDA tensors (after checking device,
dtype, shape and contiguity; it raises on anything else) and takes the plain
version only for CPU tensors.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

#: number of deposit-kernel launches in this process (the plain version and
#: the CPU path do not count)
LAUNCHES = 0


def _corner_parts(cx, cy, cz, fx, fy, fz, inc, shape):
    """Flattened (8n,) corner indices and values of the reference scheme
    (launch_ray_XZ.cu:319-348), in the JAX scatter backend's corner order
    and product order; plus the per-row in-grid mask."""
    nxp, nyp, nzp = shape
    cell = (cx, cy, cz)
    dwt, sgn, ok = [], [], torch.ones_like(inc, dtype=torch.bool)
    for ax, (f, n) in enumerate(zip((fx, fy, fz), shape)):
        p = f - 0.5
        dwt.append(1.0 - p.abs())
        s = torch.where(p < 0, -1, 1).to(torch.int64)
        sgn.append(s)
        i0 = cell[ax].to(torch.int64) + 1
        ok &= (i0 >= 0) & (i0 < n) & (i0 + s >= 0) & (i0 + s < n)
    base = ((cx.to(torch.int64) + 1) * nyp + (cy.to(torch.int64) + 1)) * nzp \
        + (cz.to(torch.int64) + 1)
    soff = (sgn[0] * (nyp * nzp), sgn[1] * nzp, sgn[2])
    idxs, vals = [], []
    for ax_x in (0, 1):
        wx = dwt[0] if ax_x else (1.0 - dwt[0])
        ox = soff[0] if ax_x else 0
        for ax_y in (0, 1):
            wy = dwt[1] if ax_y else (1.0 - dwt[1])
            oy = soff[1] if ax_y else 0
            for ax_z in (0, 1):
                wz = dwt[2] if ax_z else (1.0 - dwt[2])
                oz = soff[2] if ax_z else 0
                idxs.append(base + ox + oy + oz)
                vals.append(wx * wy * wz * inc)
    return torch.cat(idxs), torch.cat(vals), ok


def deposit_reference(edep, cx, cy, cz, fx, fy, fz, inc):
    """The plain PyTorch version of the kernel: ``index_add_`` of the eight
    corner parts into the flat grid, on any device.  Same contract as
    :func:`deposit`; deterministic on the CPU."""
    idx, val, ok = _corner_parts(cx, cy, cz, fx, fy, fz, inc, edep.shape)
    overflow = ((inc != 0) & ~ok).sum().to(torch.int32)
    # rows with a corner outside the grid are not written (their indices
    # may be out of range); dead rows in the grid add exact zeros
    write = ok.repeat(8)
    idx = torch.where(write, idx, 0)
    val = torch.where(write, val, 0.0)
    edep.view(-1).index_add_(0, idx, val)
    return edep, overflow


def _check_cuda_args(edep, ints, flts):
    dev = edep.device
    if edep.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"edep must be float32 or float64, got {edep.dtype}")
    if edep.dim() != 3 or not edep.is_contiguous():
        raise ValueError("edep must be a contiguous 3-D grid, got shape "
                         f"{tuple(edep.shape)}")
    n = ints[0].shape[0]
    for a in ints + flts:
        if a.device != dev:
            raise ValueError(f"all deposit inputs must be on {dev}, got "
                             f"{a.device}")
        if a.dim() != 1 or a.shape[0] != n or not a.is_contiguous():
            raise ValueError("deposit rows must be contiguous (n,) tensors "
                             "of one length")
    for a in ints:
        if a.dtype != torch.int32:
            raise TypeError(f"cells must be int32, got {a.dtype}")
    for a in flts:
        if a.dtype != edep.dtype:
            raise TypeError(f"fracs/inc must be {edep.dtype}, got {a.dtype}")


def deposit(edep, cx, cy, cz, fx, fy, fz, inc):
    """Deposit rows into ``edep`` (in place): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  Returns ``(edep,
    overflow)``."""
    global LAUNCHES
    ints, flts = (cx, cy, cz), (fx, fy, fz, inc)
    if edep.device.type == "cpu":
        if any(a.device.type != "cpu" for a in ints + flts):
            raise ValueError("edep is on the CPU but some rows are not")
        return deposit_reference(edep, cx, cy, cz, fx, fy, fz, inc)
    if edep.device.type != "cuda":
        raise ValueError(f"no deposit kernel for device {edep.device}")
    _check_cuda_args(edep, ints, flts)
    from ..utils import cuda_build
    lib = cuda_build.load()
    fn = (lib.cbet_deposit_f32 if edep.dtype == torch.float32
          else lib.cbet_deposit_f64)
    overflow = torch.zeros((), dtype=torch.int32, device=edep.device)
    with torch.cuda.device(edep.device):
        stream = torch.cuda.current_stream(edep.device).cuda_stream
        rc = fn(edep.data_ptr(), cx.data_ptr(), cy.data_ptr(), cz.data_ptr(),
                fx.data_ptr(), fy.data_ptr(), fz.data_ptr(), inc.data_ptr(),
                cx.shape[0], *edep.shape, overflow.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("deposit kernel launch failed: "
                           f"{lib.cbet_error_string(rc).decode()} ({rc})")
    LAUNCHES += 1
    return edep, overflow
