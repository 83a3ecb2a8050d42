"""CBET window-gain deposit: the CUDA kernel and its plain PyTorch version.

Counterpart of ``cbet_raytracing_3d_tpu/ops/pallas_deposit.py::
_make_tile_deposit_gain`` in its "cell" mode (``cbet_gain_mode=
"kernel_cell"``), with the plain version transcribing the JAX package's XLA
window form (``models/cbet.py:846-916``): the gain lookup at each step's
entry cell, ``cumprod``, ``cummax``, and a per-step ``index_add_``.  The
kernel is ``csrc/gain_deposit.cu``; its header states the contract row by
row and what bounds it on the card.

``deposit_gain_window(edep, cx, cy, cz, fx, fy, fz, inc, ds, u_nogain,
uinit, lcx, lcy, lcz, gain, rays_per_group, clip, stop_fraction) ->
(edep, overflow, gamma, uout)``:

* the streams ``cx .. u_nogain`` and the entry (lag) cells ``lc*`` are
  contiguous step-major ``(batch, n)`` tensors (int32 cells, floats of the
  grid's dtype); ``uinit`` is ``(n,)``; ``gain`` is the ``(B, nx*ny*nz)``
  table in the grid's dtype, ray ``r`` reading row ``r // rays_per_group``;
* ``edep`` (the natural ``(nx+2, ny+2, nz+2)`` grid) is updated IN PLACE
  with the gained increments up to each ray's death step;
* ``gamma`` ``(batch, n)`` is the cumulative gain factor masked from the
  killing step on (it multiplies the gain-free intensity contributions);
  ``uout`` ``(n,)`` the frozen true energy;
* ``overflow`` counts live rows whose entry cell or deposit corners leave
  the grid (0 on the trace's clamped cells).

The wrapper launches the kernel for CUDA tensors (after checking device,
dtype, shape and contiguity; it raises on anything else) and takes the plain
version only for CPU tensors.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .deposit import _on_cpu, _raise_on, deposit_reference

#: number of window-gain kernel launches in this process (the plain version
#: and the CPU path do not count)
LAUNCHES = 0


def _check(edep, streams, lags, uinit, gain, rays_per_group):
    """Shape, dtype and layout checks shared by both versions; returns
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


def deposit_gain_window_reference(edep, cx, cy, cz, fx, fy, fz, inc, ds,
                                  u_nogain, uinit, lcx, lcy, lcz, gain,
                                  rays_per_group, clip, stop_fraction):
    """The plain PyTorch version (the XLA window form of the JAX package).
    Same contract as :func:`deposit_gain_window`, on any device."""
    batch, n, (nx, ny, nz) = _check(edep, (cx, cy, cz, fx, fy, fz, inc, ds,
                                           u_nogain), (lcx, lcy, lcz),
                                    uinit, gain, rays_per_group)
    beam = torch.arange(n, device=cx.device) // rays_per_group
    inb = ((lcx >= 0) & (lcx < nx) & (lcy >= 0) & (lcy < ny)
           & (lcz >= 0) & (lcz < nz))
    flat = (lcx.to(torch.int64) * ny + lcy) * nz + lcz
    idx = beam[None, :] * (nx * ny * nz) + torch.where(inb, flat, 0)
    g = torch.where(inb, gain.reshape(-1)[idx], 0.0)
    overflow = (~inb & (ds != 0)).sum().to(torch.int32)
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
    for j in range(batch):
        edep, of = deposit_reference(edep, cx[j], cy[j], cz[j], fx[j], fy[j],
                                     fz[j], inc_c[j])
        overflow = overflow + of
    # frozen true energy: at the first death step, else the window end
    uout = ((u_true * died * medep).sum(dim=0)
            + u_true[-1] * (1.0 - anydied[-1]))
    return edep, overflow, gcum * mint, uout


def deposit_gain_window(edep, cx, cy, cz, fx, fy, fz, inc, ds, u_nogain,
                        uinit, lcx, lcy, lcz, gain, rays_per_group, clip,
                        stop_fraction):
    """One window of the exact entry-cell gain model: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors.  Returns ``(edep,
    overflow, gamma, uout)``."""
    global LAUNCHES
    streams = (cx, cy, cz, fx, fy, fz, inc, ds, u_nogain)
    lags = (lcx, lcy, lcz)
    args = streams + (uinit,) + lags + (gain,)
    if _on_cpu(edep, args, "window-gain deposit"):
        return deposit_gain_window_reference(edep, *args, rays_per_group,
                                             clip, stop_fraction)
    batch, n, (nx, ny, nz) = _check(edep, streams, lags, uinit, gain,
                                    rays_per_group)
    if edep.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"edep must be float32 or float64, got {edep.dtype}")
    for a in (edep,) + args:
        if a.device != edep.device or not a.is_contiguous():
            raise ValueError("window-gain inputs must be contiguous tensors "
                             f"on {edep.device}")
    from ..utils import cuda_build
    lib = cuda_build.load()
    fn = (lib.cbet_gain_window_f32 if edep.dtype == torch.float32
          else lib.cbet_gain_window_f64)
    overflow = torch.zeros((), dtype=torch.int32, device=edep.device)
    gamma = torch.empty((batch, n), dtype=edep.dtype, device=edep.device)
    uout = torch.empty((n,), dtype=edep.dtype, device=edep.device)
    with torch.cuda.device(edep.device):
        stream = torch.cuda.current_stream(edep.device).cuda_stream
        rc = fn(edep.data_ptr(), *(a.data_ptr() for a in args), n,
                rays_per_group, batch, nx, ny, nz, float(clip),
                float(stop_fraction), overflow.data_ptr(), gamma.data_ptr(),
                uout.data_ptr(), stream)
    _raise_on(rc, lib, "window-gain deposit")
    LAUNCHES += 1
    return edep, overflow, gamma, uout
