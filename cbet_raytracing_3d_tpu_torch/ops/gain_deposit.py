"""CBET window-gain deposit: the CUDA kernel and its plain PyTorch versions.

Counterpart of ``cbet_raytracing_3d_tpu/ops/pallas_deposit.py::
_make_tile_deposit_gain`` in both of its sampling modes and with its
``gain_only`` flag, with the plain versions transcribing the JAX package's
XLA window form (``models/cbet.py:846-916``): the gain at each step's entry
cell ("cell", ``cbet_gain_mode="kernel_cell"``) or trilinearly at each
step's deposit position over the zero-ghost padded table ("tri",
``cbet_gain_mode="kernel"``, ``:861-873``), then ``cumprod``, ``cummax``,
and a per-step ``index_add_``.  The kernel is ``csrc/gain_deposit.cu``; its
header states the contract row by row and what bounds it on the card.

``deposit_gain_window(edep, cx, cy, cz, fx, fy, fz, inc, ds, u_nogain,
uinit, lcx, lcy, lcz, gain, rays_per_group, clip, stop_fraction,
gain_only=False) -> (edep, overflow, gamma, uout)`` ("cell") and
``deposit_gain_window_tri(edep, cx, cy, cz, fx, fy, fz, inc, ds, u_nogain,
uinit, gain, rays_per_group, clip, stop_fraction, gain_only=False)``
("tri"; no entry cells):

* the streams ``cx .. u_nogain`` and the entry (lag) cells ``lc*`` are
  contiguous step-major ``(batch, n)`` tensors (int32 cells, floats of the
  grid's dtype); ``uinit`` is ``(n,)``; ``gain`` is the unpadded
  ``(B, nx*ny*nz)`` table in the grid's dtype, ray ``r`` reading row
  ``r // rays_per_group``;
* ``edep`` (the natural ``(nx+2, ny+2, nz+2)`` grid) is updated IN PLACE
  with the gained increments up to each ray's death step, unless
  ``gain_only`` (light CBET iterations), which leaves it untouched;
* ``gamma`` ``(batch, n)`` is the cumulative gain factor masked from the
  killing step on (it multiplies the gain-free intensity contributions);
  ``uout`` ``(n,)`` the frozen true energy;
* ``overflow`` counts live rows whose deposit corners leave the grid (with
  or without ``gain_only``) and, in "cell" mode, whose entry cell does (0 on
  the trace's clamped cells).

With the edep deposit, the kernel deposits each block of 256 rays' window
through a shared-memory tile box (``csrc/deposit_row.cuh``); the wrappers
take the kernel's default capacity, ``_launch`` also 0 (the direct kernel).

The wrappers launch the kernel for CUDA tensors (after checking device,
dtype, shape and contiguity; they raise on anything else) and take the
plain versions only for CPU tensors.  ``LAUNCHES``, ``TRI_LAUNCHES`` and
``GAIN_ONLY_LAUNCHES`` count kernel launches.
"""

from __future__ import annotations

import torch

from .deposit import (BOX_DEFAULT, _corner_parts, _on_cpu, _raise_on,
                      _tally_ptr, deposit_reference)

#: number of "cell" window-gain kernel launches with the edep deposit in
#: this process (the plain versions and the CPU path do not count)
LAUNCHES = 0
#: number of "tri" window-gain kernel launches with the edep deposit
TRI_LAUNCHES = 0
#: number of gain-only window-gain kernel launches, of either mode
GAIN_ONLY_LAUNCHES = 0


def _check(edep, streams, lags, uinit, gain, rays_per_group):
    """Shape, dtype and layout checks shared by all versions; returns
    ``(batch, n, (nx, ny, nz))``."""
    if edep.dim() != 3:
        raise ValueError(f"edep must be a 3-D grid, got {tuple(edep.shape)}")
    nx, ny, nz = (s - 2 for s in edep.shape)
    shape = streams[0].shape
    if len(shape) != 2:
        raise ValueError(f"window streams must be (batch, n), got {shape}")
    batch, n = shape
    for a in streams + lags:
        if a.shape != shape:
            raise ValueError(f"window streams must all be {tuple(shape)}, "
                             f"got {tuple(a.shape)}")
    for a in streams[:3] + lags:
        if a.dtype != torch.int32:
            raise TypeError(f"cells must be int32, got {a.dtype}")
    for a in streams[3:] + (uinit, gain):
        if a.dtype != edep.dtype:
            raise TypeError(f"window floats must be {edep.dtype}, got "
                            f"{a.dtype}")
    if uinit.shape != (n,):
        raise ValueError(f"uinit must be ({n},), got {tuple(uinit.shape)}")
    if gain.dim() != 2 or gain.shape[1] != nx * ny * nz:
        raise ValueError(f"gain must be (B, {nx * ny * nz}), got "
                         f"{tuple(gain.shape)}")
    if rays_per_group <= 0 or n > gain.shape[0] * rays_per_group:
        raise ValueError(f"window of {n} rays > beams*rays_per_group = "
                         f"{gain.shape[0]}*{rays_per_group}")
    return batch, n, (nx, ny, nz)


def _window_reference(edep, g, streams, uinit, clip, stop_fraction,
                      gain_only):
    """The window model after the gain sample ``g`` (batch, n): the
    cumulative factors, the exact termination and the deposit."""
    cx, cy, cz, fx, fy, fz, inc, ds, u_nogain = streams
    gam = torch.exp(torch.clamp(g * ds, -clip, clip))
    gcum = torch.cumprod(gam, dim=0)
    # exact termination: deposits masked from the step AFTER the first
    # death (the killing step still deposits), intensity FROM the killing
    # step on
    u_true = u_nogain * gcum
    died = (u_true <= stop_fraction * uinit).to(edep.dtype)
    anydied = torch.cummax(died, dim=0).values
    prev_any = torch.cat([torch.zeros_like(anydied[:1]), anydied[:-1]])
    medep = 1.0 - prev_any
    mint = 1.0 - anydied
    inc_c = inc * gcum * medep
    if gain_only:
        # no deposit, the same overflow count as the deposit's
        _, _, ok = _corner_parts(*(a.reshape(-1) for a in streams[:6]),
                                 inc_c.reshape(-1), edep.shape)
        overflow = ((inc_c.reshape(-1) != 0) & ~ok).sum().to(torch.int32)
    else:
        overflow = torch.zeros((), dtype=torch.int32, device=edep.device)
        for j in range(g.shape[0]):
            edep, of = deposit_reference(edep, cx[j], cy[j], cz[j], fx[j],
                                         fy[j], fz[j], inc_c[j])
            overflow = overflow + of
    # frozen true energy: at the first death step, else the window end
    uout = ((u_true * died * medep).sum(dim=0)
            + u_true[-1] * (1.0 - anydied[-1]))
    return edep, overflow, gcum * mint, uout


def deposit_gain_window_reference(edep, cx, cy, cz, fx, fy, fz, inc, ds,
                                  u_nogain, uinit, lcx, lcy, lcz, gain,
                                  rays_per_group, clip, stop_fraction,
                                  gain_only=False):
    """The plain PyTorch version of the "cell" mode (the XLA window form of
    the JAX package).  Same contract as :func:`deposit_gain_window`, on any
    device."""
    streams = (cx, cy, cz, fx, fy, fz, inc, ds, u_nogain)
    _, n, (nx, ny, nz) = _check(edep, streams, (lcx, lcy, lcz), uinit, gain,
                                rays_per_group)
    beam = torch.arange(n, device=cx.device) // rays_per_group
    inb = ((lcx >= 0) & (lcx < nx) & (lcy >= 0) & (lcy < ny)
           & (lcz >= 0) & (lcz < nz))
    flat = (lcx.to(torch.int64) * ny + lcy) * nz + lcz
    idx = beam[None, :] * (nx * ny * nz) + torch.where(inb, flat, 0)
    g = torch.where(inb, gain.reshape(-1)[idx], 0.0)
    lag_of = (~inb & (ds != 0)).sum().to(torch.int32)
    edep, overflow, gamma, uout = _window_reference(
        edep, g, streams, uinit, clip, stop_fraction, gain_only)
    return edep, overflow + lag_of, gamma, uout


def deposit_gain_window_tri_reference(edep, cx, cy, cz, fx, fy, fz, inc, ds,
                                      u_nogain, uinit, gain, rays_per_group,
                                      clip, stop_fraction, gain_only=False):
    """The plain PyTorch version of the "tri" mode: the XLA form's gather
    of the eight deposit corners, with the deposit's weights, from the
    zero-ghost padded table (``models/cbet.py:693-696``, ``:861-873``).
    Same contract as :func:`deposit_gain_window_tri`, on any device."""
    streams = (cx, cy, cz, fx, fy, fz, inc, ds, u_nogain)
    batch, n, (nx, ny, nz) = _check(edep, streams, (), uinit, gain,
                                    rays_per_group)
    gpad = torch.nn.functional.pad(
        gain.reshape(-1, nx, ny, nz), (1, 1, 1, 1, 1, 1)).reshape(-1)
    beam = torch.arange(n, device=cx.device) // rays_per_group
    off = (beam * edep.numel()).repeat(batch)
    idx, w, ok = _corner_parts(*(a.reshape(-1) for a in streams[:6]),
                               torch.ones_like(ds).reshape(-1), edep.shape)
    idx = torch.where(ok[:, None], idx + off[:, None], 0)
    g = torch.where(ok, (gpad[idx] * w).sum(dim=1), 0.0).reshape(batch, n)
    return _window_reference(edep, g, streams, uinit, clip, stop_fraction,
                             gain_only)


def _launch(edep, streams, uinit, lags, gain, rays_per_group, clip,
            stop_fraction, gain_only, box_nodes=BOX_DEFAULT, tally=None):
    """Check the CUDA arguments and launch the kernel; "tri" when there are
    no lag cells.  ``box_nodes`` is the edep tile box's capacity (the
    wrappers take the kernel's default; 0 runs the direct kernel) and
    ``tally`` as in ``ops.deposit._launch_grouped``.  Returns ``(edep,
    overflow, gamma, uout)``."""
    batch, n, (nx, ny, nz) = _check(edep, streams, lags, uinit, gain,
                                    rays_per_group)
    if edep.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"edep must be float32 or float64, got {edep.dtype}")
    for a in (edep,) + streams + (uinit,) + lags + (gain,):
        if a.device != edep.device or not a.is_contiguous():
            raise ValueError("window-gain inputs must be contiguous tensors "
                             f"on {edep.device}")
    from ..utils import cuda_build
    lib = cuda_build.load()
    fn = (lib.cbet_gain_window_f32 if edep.dtype == torch.float32
          else lib.cbet_gain_window_f64)
    lag_ptrs = [a.data_ptr() for a in lags] if lags else [None] * 3
    overflow = torch.zeros((), dtype=torch.int32, device=edep.device)
    gamma = torch.empty((batch, n), dtype=edep.dtype, device=edep.device)
    uout = torch.empty((n,), dtype=edep.dtype, device=edep.device)
    with torch.cuda.device(edep.device):
        stream = torch.cuda.current_stream(edep.device).cuda_stream
        rc = fn(edep.data_ptr(), *(a.data_ptr() for a in streams),
                uinit.data_ptr(), *lag_ptrs, gain.data_ptr(), n,
                rays_per_group, batch, nx, ny, nz, float(clip),
                float(stop_fraction), int(not lags), int(bool(gain_only)),
                box_nodes, overflow.data_ptr(), gamma.data_ptr(),
                uout.data_ptr(),
                None if tally is None else _tally_ptr(tally, edep.device),
                stream)
    _raise_on(rc, lib, "window-gain deposit")
    return edep, overflow, gamma, uout


def deposit_gain_window(edep, cx, cy, cz, fx, fy, fz, inc, ds, u_nogain,
                        uinit, lcx, lcy, lcz, gain, rays_per_group, clip,
                        stop_fraction, gain_only=False):
    """One window of the exact entry-cell gain model ("cell"): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  Returns
    ``(edep, overflow, gamma, uout)``."""
    global LAUNCHES, GAIN_ONLY_LAUNCHES
    streams = (cx, cy, cz, fx, fy, fz, inc, ds, u_nogain)
    lags = (lcx, lcy, lcz)
    if _on_cpu(edep, streams + (uinit,) + lags + (gain,),
               "window-gain deposit"):
        return deposit_gain_window_reference(
            edep, *streams, uinit, *lags, gain, rays_per_group, clip,
            stop_fraction, gain_only)
    out = _launch(edep, streams, uinit, lags, gain, rays_per_group, clip,
                  stop_fraction, gain_only)
    if gain_only:
        GAIN_ONLY_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def deposit_gain_window_tri(edep, cx, cy, cz, fx, fy, fz, inc, ds, u_nogain,
                            uinit, gain, rays_per_group, clip, stop_fraction,
                            gain_only=False):
    """One window of the trilinear gain model ("tri"): the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors.  Returns ``(edep,
    overflow, gamma, uout)``."""
    global TRI_LAUNCHES, GAIN_ONLY_LAUNCHES
    streams = (cx, cy, cz, fx, fy, fz, inc, ds, u_nogain)
    if _on_cpu(edep, streams + (uinit, gain), "window-gain deposit"):
        return deposit_gain_window_tri_reference(
            edep, *streams, uinit, gain, rays_per_group, clip,
            stop_fraction, gain_only)
    out = _launch(edep, streams, uinit, (), gain, rays_per_group, clip,
                  stop_fraction, gain_only)
    if gain_only:
        GAIN_ONLY_LAUNCHES += 1
    else:
        TRI_LAUNCHES += 1
    return out
