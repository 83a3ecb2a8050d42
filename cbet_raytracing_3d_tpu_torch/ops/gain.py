"""CBET gain reduction: the CUDA kernel and its plain PyTorch version.

Counterpart of ``cbet_raytracing_3d_tpu/ops/pallas_gain.py::
make_gain_kernel`` (kernel body ``_gain_kernel``), with the plain version
transcribing the JAX package's XLA form (``models/cbet.py::make_gain_fn``,
the fori-loop over partner beams).  The kernels are in ``csrc/gain.cu``; its
header says what bounds them on the card.

``gain(pair_u (Bo, B, 3), rhat_pre (4, P), intensity (B, P)) -> (Bo, P)``,
all float32::

    g[b, p] = pre[p] * sum_{b'} R(pair_u[b, b'] . rhat[:, p]) * I[b', p]
    R(eta)  = iaw^2 eta / ((eta^2 - 1)^2 + iaw^2 eta^2)

``rhat_pre`` rows are [rhat_x, rhat_y, rhat_z, pre].  ``Bo < B`` is the
TPU kernel's ``b_out`` form: the rows of ``pair_u`` are those of the
requested output beams, the partner sum still runs over all ``B``.  The
(B, B, P) product is never built.

There are two kernels.  The solver's own couplings (``models/cbet.py::
pair_couplings``) are antisymmetric, ``pair_u[b, a] == -pair_u[a, b]`` with
a zero diagonal, and ``R`` is odd, so ``R(b, a) = -R(a, b)`` bit for bit:
for such a ``pair_u`` in the full form (``Bo == B``) the pair kernel
evaluates each beam pair once and feeds both beams' sums, in the all-pairs
kernel's order of summation, so the two agree bit for bit.  Any other
``pair_u`` (the ``b_out`` form, a caller's own couplings, more beams than
the pair kernel's shared memory holds) takes the all-pairs kernel.
:func:`pairs_antisymmetric` is the test; the wrapper runs it once per
``pair_u`` tensor.  :func:`gain_pairs_reference` is the pair kernel's plain
version; on the CPU it equals :func:`gain_reference` bit for bit.

The wrapper launches a kernel for CUDA tensors (after checking device,
dtype, shape and contiguity; it raises on anything else) and takes the plain
version only for CPU tensors.  ``LAUNCHES`` counts kernel launches,
``PAIR_LAUNCHES`` those of them that were the pair kernel's and
``B_OUT_LAUNCHES`` those in the ``b_out`` form (``Bo < B``: the rank's own
rows of a beam-sharded gain, ``models/cbet.make_gain_fn``).
"""

from __future__ import annotations

import torch

from .. import constants as k
from .deposit import _on_cpu, _raise_on

#: number of gain-kernel launches in this process, either kernel's (the
#: plain versions and the CPU path do not count)
LAUNCHES = 0
#: how many of them launched the pair kernel
PAIR_LAUNCHES = 0
#: how many of them computed fewer output rows than beams (``b_out``)
B_OUT_LAUNCHES = 0


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


def pairs_antisymmetric(pair_u) -> bool:
    """Whether ``pair_u`` is the full form with exactly antisymmetric
    couplings: (B, B, 3), ``pair_u[b, a] == -pair_u[a, b]`` for every pair
    and a zero diagonal.  Then one evaluation of ``R`` serves both beams of
    a pair."""
    if pair_u.dim() != 3 or pair_u.shape[0] != pair_u.shape[1]:
        return False
    return bool(torch.equal(pair_u, -pair_u.transpose(0, 1)))


def _takes_pairs(pair_u) -> bool:
    """:func:`pairs_antisymmetric`, evaluated once per tensor (and again
    after an in-place change) and kept on the tensor: the solver builds its
    couplings once."""
    hit = getattr(pair_u, "_pair_form", None)
    if hit is None or hit[0] != pair_u._version:
        hit = (pair_u._version, pairs_antisymmetric(pair_u))
        pair_u._pair_form = hit
    return hit[1]


def gain_pairs_reference(pair_u, rhat_pre, intensity):
    """The plain PyTorch version of the pair kernel: for each pair a < b one
    ``r = R(pair_u[a, b] . rhat)``, then ``sum[a] += r * I[b]`` and
    ``sum[b] -= r * I[a]``, a ascending and b ascending, so that every sum
    receives its partners in :func:`gain_reference`'s order.  Needs
    :func:`pairs_antisymmetric` couplings; same contract as :func:`gain`,
    on any device."""
    _check_shapes(pair_u, rhat_pre, intensity)
    if not pairs_antisymmetric(pair_u):
        raise ValueError("gain_pairs_reference needs the full form with "
                         "antisymmetric couplings and a zero diagonal")
    rx, ry, rz, pre = rhat_pre[0], rhat_pre[1], rhat_pre[2], rhat_pre[3]
    B = intensity.shape[0]
    acc = torch.zeros_like(intensity)
    for a in range(B - 1):
        u = pair_u[a, a + 1:]                          # the partners b > a
        eta = (u[:, 0:1] * rx[None, :] + u[:, 1:2] * ry[None, :]
               + u[:, 2:3] * rz[None, :])
        r = resonance(eta)
        # each later beam's sum takes this a once, in a's turn
        acc[a + 1:] -= r * intensity[a:a + 1]
        mine = r * intensity[a + 1:]
        for j in range(B - 1 - a):                     # b ascending
            acc[a] += mine[j]
    return acc * pre[None, :]


def gain(pair_u, rhat_pre, intensity):
    """The gain reduction: a CUDA kernel for CUDA tensors (the pair kernel
    for antisymmetric couplings in the full form, else the all-pairs
    kernel), the plain version for CPU tensors.  Returns a new (Bo, P)
    float32 tensor."""
    global LAUNCHES, PAIR_LAUNCHES, B_OUT_LAUNCHES
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
    pairs = (bo == B and B <= lib.cbet_gain_pairs_max_beams()
             and _takes_pairs(pair_u))
    out = _launch(lib, pair_u, rhat_pre, intensity, pairs)
    LAUNCHES += 1
    PAIR_LAUNCHES += pairs
    B_OUT_LAUNCHES += bo < B
    return out


def _launch(lib, pair_u, rhat_pre, intensity, pairs: bool):
    """Launch the pair kernel (``pairs``; the caller vouches for the
    couplings) or the all-pairs kernel on checked CUDA arguments."""
    bo = pair_u.shape[0]
    B, P = intensity.shape
    out = torch.empty((bo, P), dtype=torch.float32, device=intensity.device)
    ptrs = (pair_u.data_ptr(), rhat_pre.data_ptr(), intensity.data_ptr(),
            out.data_ptr())
    iaw2 = float(k.IAW) ** 2
    with torch.cuda.device(intensity.device):
        stream = torch.cuda.current_stream(intensity.device).cuda_stream
        if pairs:
            rc = lib.cbet_gain_pairs_f32(*ptrs, B, P, iaw2, stream)
        else:
            rc = lib.cbet_gain_f32(*ptrs, bo, B, P, iaw2, stream)
    _raise_on(rc, lib, "gain")
    return out
