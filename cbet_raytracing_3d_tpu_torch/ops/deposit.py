"""Trilinear energy deposit: the CUDA kernels and their plain PyTorch
versions.

Counterpart of ``cbet_raytracing_3d_tpu/ops/pallas_deposit.py::
make_tile_deposit`` (and of ``make_tile_deposit_hbm``, whose contract the
same wrapper covers at any grid size), with the plain version transcribing the
JAX package's XLA scatter backend (``models/raytracer.py::
_scatter_corner_parts``).  The kernels are in ``csrc/deposit.cu``; its header
says what bounds them on the card.

``deposit(edep, cx, cy, cz, fx, fy, fz, inc, n_rays=None) -> (edep,
overflow)`` (K1) keeps the TPU kernel's signature without its grid padding:
``edep`` is the natural ghost-padded ``(nx+2, ny+2, nz+2)`` grid, updated IN
PLACE and returned; per-row inputs are flat ``(n,)`` tensors (int32 cells,
floats of the grid's dtype) in launch-tile order, one step of ``n_rays`` rays
(the default: all rows) or a step-major window of ``n / n_rays`` steps;
``overflow`` is a 0-dim int32 tensor counting live rows with a corner outside
the grid (0 when cells are clamped to the grid, as the trace keeps them),
which were not written.

``deposit_grouped(grids, ..., inc, rays_per_group, n_rays=None)`` (K2) is
the grouped form, the per-beam CBET intensity fields: ``grids`` is
``(G, nxp, nyp, nzp)``, and row ``i`` goes into grid
``(i % n_rays) // rays_per_group`` (rows are one step of ``n_rays`` rays, or
a step-major window of several).

K1 and K2 deposit a step-major window ray-major, each block of 256 rays
through a shared-memory tile box (``csrc/deposit_row.cuh``).  K1 on one
float32 step (K5's contract: BASELINE config 4 deposits every step into its
202^3 grid) takes the one-step kernel, which reads each row once into an
exact fixed-point box with copies of each node for dense blocks
(``csrc/deposit.cu``); K1 in float64 takes the direct kernel on one step
(one thread per row, global atomics) and the window kernel's direct path on
a window.  ``BOX_DEFAULT`` asks for the kernel's own box capacity, 0 for the
direct kernel.  The wrappers always take the default; ``_launch`` and
``_launch_grouped`` also take 0 or another capacity of the window kernel's
box, to time the designs side by side, and a ``tally`` of the box's use;
``_launch(one_step=False)`` sends a float32 step through the window
kernel's box as it went before the one-step kernel
(``scripts/step_sweep.py`` times both on config 4's steps).

Each wrapper launches its kernel for CUDA tensors (after checking device,
dtype, shape and contiguity; it raises on anything else) and takes the plain
version only for CPU tensors.  ``LAUNCHES`` and ``GROUPED_LAUNCHES`` count
kernel launches.
"""

from __future__ import annotations

import torch

#: number of K1 deposit-kernel launches in this process (the plain version
#: and the CPU path do not count)
LAUNCHES = 0
#: number of K2 grouped-deposit launches, counted the same way
GROUPED_LAUNCHES = 0
#: the tile box capacity that asks for the kernel's default
#: (``cbet_box_default_nodes``); 0 runs the direct kernel
BOX_DEFAULT = -1


def _corner_parts(cx, cy, cz, fx, fy, fz, inc, shape):
    """(n, 8) corner indices into the flat grid and values of the reference
    scheme (launch_ray_XZ.cu:319-348), in the JAX scatter backend's corner
    order and product order; plus the per-row in-grid mask.  Flattened row
    by row, a step-major window of rows adds in the order of one call per
    step, so a batched deposit equals the per-step one bit for bit on the
    CPU."""
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
    return torch.stack(idxs, dim=1), torch.stack(vals, dim=1), ok


def _check_steps(n_rows, n_rays) -> int:
    """``n_rays`` (default: all rows, one step); raises unless the rows are
    whole steps of it."""
    if n_rays is None:
        n_rays = n_rows
    if n_rows and (n_rays <= 0 or n_rows % n_rays):
        raise ValueError(f"deposit: {n_rows} rows are not whole steps of "
                         f"n_rays={n_rays}")
    return n_rays


def deposit_reference(edep, cx, cy, cz, fx, fy, fz, inc, n_rays=None):
    """The plain PyTorch version of the kernel: ``index_add_`` of the eight
    corner parts into the flat grid, on any device.  Same contract as
    :func:`deposit`; deterministic on the CPU, where a step-major window
    equals one call per step bit for bit (``_corner_parts``' order)."""
    _check_steps(cx.shape[0], n_rays)
    idx, val, ok = _corner_parts(cx, cy, cz, fx, fy, fz, inc, edep.shape)
    overflow = ((inc != 0) & ~ok).sum().to(torch.int32)
    # rows with a corner outside the grid are not written (their indices
    # may be out of range); dead rows in the grid add exact zeros
    idx = torch.where(ok[:, None], idx, 0).reshape(-1)
    val = torch.where(ok[:, None], val, 0.0).reshape(-1)
    edep.view(-1).index_add_(0, idx, val)
    return edep, overflow


def _check_groups(n_rows, n_rays, rays_per_group, n_groups) -> int:
    """The grouped deposit's checks; returns ``n_rays`` (default: all rows,
    one step)."""
    if n_rays is None:
        n_rays = n_rows
    if n_rays <= 0 or rays_per_group <= 0 or n_rows % n_rays:
        raise ValueError(f"grouped deposit: {n_rows} rows are not whole steps "
                         f"of n_rays={n_rays} (rays_per_group="
                         f"{rays_per_group})")
    if n_rays > n_groups * rays_per_group:
        # raise, not clamp: a clamped group would pour the overflowing rays'
        # energy into the last grid (pallas_deposit.py:589-599)
        raise ValueError(
            f"grouped deposit called with {n_rays} rays > n_groups*"
            f"rays_per_group = {n_groups}*{rays_per_group}")
    return n_rays


def deposit_grouped_reference(grids, cx, cy, cz, fx, fy, fz, inc,
                              rays_per_group, n_rays=None):
    """The plain PyTorch version of the grouped kernel: one ``index_add_``
    of the eight corner parts, offset by each row's group, into the flat
    grids.  Same contract as :func:`deposit_grouped`."""
    n_rays = _check_groups(cx.shape[0], n_rays, rays_per_group,
                           grids.shape[0])
    group = (torch.arange(cx.shape[0], device=cx.device) % n_rays) \
        // rays_per_group
    idx, val, ok = _corner_parts(cx, cy, cz, fx, fy, fz, inc,
                                 grids.shape[1:])
    overflow = ((inc != 0) & ~ok).sum().to(torch.int32)
    elems = grids[0].numel()
    idx = torch.where(ok[:, None], idx + (group * elems)[:, None], 0)
    val = torch.where(ok[:, None], val, 0.0)
    grids.view(-1).index_add_(0, idx.reshape(-1), val.reshape(-1))
    return grids, overflow


def _check_cuda_args(edep, ints, flts, grid_dim=3):
    dev = edep.device
    if edep.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"edep must be float32 or float64, got {edep.dtype}")
    if edep.dim() != grid_dim or not edep.is_contiguous():
        raise ValueError(f"the grid must be a contiguous {grid_dim}-D tensor, "
                         f"got shape {tuple(edep.shape)}")
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


def _on_cpu(out, inputs, what):
    """True when the call takes the plain version (``out`` on the CPU);
    raises on mixed devices and on devices without a kernel.  Shared by the
    wrappers of ops/deposit, ops/gain and ops/gain_deposit."""
    if out.device.type == "cpu":
        if any(a.device.type != "cpu" for a in inputs):
            raise ValueError(f"the {what} output is on the CPU but some "
                             "inputs are not")
        return True
    if out.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {out.device}")
    return False


def _raise_on(rc, lib, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.cbet_error_string(rc).decode()} ({rc})")


def deposit(edep, cx, cy, cz, fx, fy, fz, inc, n_rays=None):
    """Deposit rows into ``edep`` (in place): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  ``n_rays`` is the number of
    rays per step (default: all rows, one step); rows that are not whole
    steps raise.  Returns ``(edep, overflow)``."""
    global LAUNCHES
    ints, flts = (cx, cy, cz), (fx, fy, fz, inc)
    if _on_cpu(edep, ints + flts, "deposit"):
        return deposit_reference(edep, cx, cy, cz, fx, fy, fz, inc, n_rays)
    overflow = _launch(edep, cx, cy, cz, fx, fy, fz, inc, n_rays)
    LAUNCHES += 1
    return edep, overflow


def _launch(edep, cx, cy, cz, fx, fy, fz, inc, n_rays=None,
            box_nodes=BOX_DEFAULT, tally=None, one_step=True):
    """Check the CUDA arguments and launch K1.  At the default capacity a
    float32 step takes the one-step kernel (``one_step=False``: the window
    kernel at one step, the tile box a float32 step took before) and a
    float32 window the window kernel's box; in float64 a step takes the
    direct kernel and a window the window kernel's direct path.
    ``box_nodes`` 0 runs the direct kernel over all the rows, > 0 the
    window kernel with a box of that capacity.  Returns the overflow count.
    ``tally`` as in :func:`_launch_grouped`."""
    ints, flts = (cx, cy, cz), (fx, fy, fz, inc)
    _check_cuda_args(edep, ints, flts)
    n_rays = _check_steps(cx.shape[0], n_rays)
    from ..utils import cuda_build
    lib = cuda_build.load()
    fn = (lib.cbet_deposit_f32 if edep.dtype == torch.float32
          else lib.cbet_deposit_f64)
    overflow = torch.zeros((), dtype=torch.int32, device=edep.device)
    with torch.cuda.device(edep.device):
        stream = torch.cuda.current_stream(edep.device).cuda_stream
        rc = fn(edep.data_ptr(), cx.data_ptr(), cy.data_ptr(), cz.data_ptr(),
                fx.data_ptr(), fy.data_ptr(), fz.data_ptr(), inc.data_ptr(),
                cx.shape[0], n_rays, *edep.shape, box_nodes, int(one_step),
                overflow.data_ptr(),
                None if tally is None else _tally_ptr(tally, edep.device),
                stream)
    _raise_on(rc, lib, "deposit")
    return overflow


def deposit_grouped(grids, cx, cy, cz, fx, fy, fz, inc, rays_per_group,
                    n_rays=None):
    """Deposit rows into their groups' grids (in place): the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors.  ``n_rays`` is the
    number of rays per step (default: all rows, one step).  Returns
    ``(grids, overflow)``; raises when ``n_rays > G * rays_per_group``."""
    global GROUPED_LAUNCHES
    ints, flts = (cx, cy, cz), (fx, fy, fz, inc)
    if _on_cpu(grids, ints + flts, "grouped deposit"):
        return deposit_grouped_reference(grids, cx, cy, cz, fx, fy, fz, inc,
                                         rays_per_group, n_rays)
    overflow = _launch_grouped(grids, cx, cy, cz, fx, fy, fz, inc,
                               rays_per_group, n_rays)
    GROUPED_LAUNCHES += 1
    return grids, overflow


def _launch_grouped(grids, cx, cy, cz, fx, fy, fz, inc, rays_per_group,
                    n_rays=None, box_nodes=BOX_DEFAULT, tally=None):
    """Check the CUDA arguments and launch K2 with tile box capacity
    ``box_nodes``; returns the overflow count.  ``tally``, an int32 (2,)
    tensor on the grids' device, receives the blocks with rows and the
    blocks that took the box."""
    ints, flts = (cx, cy, cz), (fx, fy, fz, inc)
    _check_cuda_args(grids, ints, flts, grid_dim=4)
    n_rays = _check_groups(cx.shape[0], n_rays, rays_per_group,
                           grids.shape[0])
    from ..utils import cuda_build
    lib = cuda_build.load()
    fn = (lib.cbet_deposit_grouped_f32 if grids.dtype == torch.float32
          else lib.cbet_deposit_grouped_f64)
    overflow = torch.zeros((), dtype=torch.int32, device=grids.device)
    with torch.cuda.device(grids.device):
        stream = torch.cuda.current_stream(grids.device).cuda_stream
        rc = fn(grids.data_ptr(), cx.data_ptr(), cy.data_ptr(), cz.data_ptr(),
                fx.data_ptr(), fy.data_ptr(), fz.data_ptr(), inc.data_ptr(),
                cx.shape[0], n_rays, rays_per_group, *grids.shape[1:],
                box_nodes, overflow.data_ptr(),
                None if tally is None else _tally_ptr(tally, grids.device),
                stream)
    _raise_on(rc, lib, "grouped deposit")
    return overflow


def _tally_ptr(tally, device):
    if (tally.dtype != torch.int32 or tally.shape != (2,)
            or tally.device != device):
        raise ValueError(f"tally must be an int32 (2,) tensor on {device}")
    return tally.data_ptr()
