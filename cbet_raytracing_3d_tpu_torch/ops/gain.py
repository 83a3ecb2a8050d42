"""CBET gain reduction: the CUDA kernel and its plain PyTorch version.

Counterpart of ``cbet_raytracing_3d_tpu/ops/pallas_gain.py::
make_gain_kernel`` (kernel body ``_gain_kernel``), with the plain version
transcribing the JAX package's XLA form (``models/cbet.py::make_gain_fn``,
the fori-loop over partner beams).  The kernel is ``csrc/gain.cu``; its
header says what bounds it on the card.

``gain(pair_u (Bo, B, 3), rhat_pre (4, P), intensity (B, P)) -> (Bo, P)``,
all float32::

    g[b, p] = pre[p] * sum_{b'} R(pair_u[b, b'] . rhat[:, p]) * I[b', p]
    R(eta)  = iaw^2 eta / ((eta^2 - 1)^2 + iaw^2 eta^2)

``rhat_pre`` rows are [rhat_x, rhat_y, rhat_z, pre].  ``Bo < B`` is the
TPU kernel's ``b_out`` form: the rows of ``pair_u`` are those of the
requested output beams, the partner sum still runs over all ``B``.  The
(B, B, P) product is never built.

The wrapper launches the kernel for CUDA tensors (after checking device,
dtype, shape and contiguity; it raises on anything else) and takes the plain
version only for CPU tensors.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import constants as k
from .deposit import _on_cpu, _raise_on

#: number of gain-kernel launches in this process (the plain version and the
#: CPU path do not count)
LAUNCHES = 0


def resonance(eta, iaw: float = k.IAW):
    """The ion-acoustic response ``R(eta)`` (odd in eta), elementwise on a
    tensor or an array (``models/cbet.py::resonance``)."""
    e2 = eta * eta
    return (iaw * iaw) * eta / ((e2 - 1.0) ** 2 + (iaw * iaw) * e2)


def _check_shapes(pair_u, rhat_pre, intensity):
    if intensity.dim() != 2 or rhat_pre.dim() != 2 or pair_u.dim() != 3:
        raise ValueError("gain expects pair_u (Bo, B, 3), rhat_pre (4, P), "
                         "intensity (B, P)")
    B, P = intensity.shape
    if rhat_pre.shape != (4, P):
        raise ValueError(f"rhat_pre must be (4, {P}), got "
                         f"{tuple(rhat_pre.shape)}")
    # (Bo, B, 3) in the axis order pair_couplings builds: a (b, b')-
    # transposed pair_u has the same shape and reverses the transfer, which
    # only the value tests catch; a wrong axis order is refused here
    if pair_u.shape[1:] != (B, 3) or not 0 < pair_u.shape[0] <= B:
        raise ValueError(f"pair_u must be (Bo, {B}, 3) with Bo <= {B}, got "
                         f"{tuple(pair_u.shape)}")
    for a in (pair_u, rhat_pre, intensity):
        if a.dtype != torch.float32:
            raise TypeError(f"gain inputs must be float32, got {a.dtype}")


def gain_reference(pair_u, rhat_pre, intensity):
    """The plain PyTorch version: the partner loop of the JAX XLA form, in
    its order and float32 expression (``acc += R(eta) * I[b']``, then
    ``* pre``).  Same contract as :func:`gain`, on any device."""
    _check_shapes(pair_u, rhat_pre, intensity)
    rx, ry, rz, pre = rhat_pre[0], rhat_pre[1], rhat_pre[2], rhat_pre[3]
    acc = torch.zeros((pair_u.shape[0], intensity.shape[1]),
                      dtype=torch.float32, device=intensity.device)
    for bp in range(intensity.shape[0]):
        eta = (pair_u[:, bp, 0:1] * rx[None, :]
               + pair_u[:, bp, 1:2] * ry[None, :]
               + pair_u[:, bp, 2:3] * rz[None, :])
        acc = acc + resonance(eta) * intensity[bp:bp + 1]
    return acc * pre[None, :]


def gain(pair_u, rhat_pre, intensity):
    """The gain reduction: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns a new (Bo, P) float32 tensor."""
    global LAUNCHES
    args = (pair_u, rhat_pre, intensity)
    if _on_cpu(intensity, args, "gain"):
        return gain_reference(*args)
    _check_shapes(*args)
    for a in args:
        if a.device != intensity.device or not a.is_contiguous():
            raise ValueError("gain inputs must be contiguous tensors on "
                             f"{intensity.device}")
    from ..utils import cuda_build
    lib = cuda_build.load()
    bo = pair_u.shape[0]
    B, P = intensity.shape
    out = torch.empty((bo, P), dtype=torch.float32, device=intensity.device)
    with torch.cuda.device(intensity.device):
        stream = torch.cuda.current_stream(intensity.device).cuda_stream
        rc = lib.cbet_gain_f32(pair_u.data_ptr(), rhat_pre.data_ptr(),
                               intensity.data_ptr(), out.data_ptr(), bo, B, P,
                               float(k.IAW) ** 2, stream)
    _raise_on(rc, lib, "gain")
    LAUNCHES += 1
    return out
