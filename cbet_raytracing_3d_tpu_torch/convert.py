"""Carry trace inputs and states between the JAX package and the port.

The two packages share no import: the port never imports jax.  A caller that
holds the JAX package's ``TraceContext`` contents as NumPy arrays (e.g.
``np.asarray`` of each array) hands them here and gets the port's tensors on
a given device, so both packages can trace the identical initial state —
and, for CBET, the identical beam ids and (B, P) gain or intensity fields.

A state travels as a dict keyed by ``RayState``'s field names: the per-axis
fields (``frac``, ``vel``, ``kick``, ``cell``) hold 3-tuples of (N,) arrays,
the others (``uray``, ``uray_init``, ``alive``) one (N,) array each — the
layout of both packages' ``RayState``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.raytracer import RayState

_AXES = ("frac", "vel", "kick", "cell")


def state_from_numpy(arrays: dict, device="cpu") -> RayState:
    """A ``RayState`` of tensors on ``device`` from NumPy arrays (copied)."""
    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    kw = {}
    for f in dataclasses.fields(RayState):
        v = arrays[f.name]
        kw[f.name] = tuple(t(a) for a in v) if f.name in _AXES else t(v)
    return RayState(**kw)


def state_to_numpy(state) -> dict:
    """The inverse: a dict of NumPy arrays from a ``RayState`` of either
    package (anything ``np.asarray`` takes, after a move to the CPU)."""
    def n(a):
        if isinstance(a, torch.Tensor):
            a = a.cpu()
        return np.asarray(a)

    out = {}
    for f in dataclasses.fields(RayState):
        v = getattr(state, f.name)
        out[f.name] = tuple(n(a) for a in v) if f.name in _AXES else n(v)
    return out


def from_jax_context(field4: np.ndarray, state0: dict, live_slots: np.ndarray,
                     device="cpu"):
    """``(field4, state0, live_slots)`` as the port's tensors on ``device``
    from the JAX ``TraceContext``'s arrays (``state0`` as a dict, see the
    module docstring)."""
    return (torch.from_numpy(np.array(field4, copy=True)).to(device),
            state_from_numpy(state0, device),
            torch.from_numpy(np.asarray(live_slots, np.int64)).to(device))


def tensor_from_numpy(a, device="cpu", dtype=None) -> torch.Tensor:
    """A tensor on ``device`` from an array of either package (copied):
    per-slot beam ids, (B, P) gain or intensity fields."""
    t = torch.from_numpy(np.array(a, copy=True)).to(device)
    return t if dtype is None else t.to(dtype)


def from_jax_cbet(field4: np.ndarray, state0: dict, bid: np.ndarray,
                  gain: np.ndarray, device="cpu"):
    """``(field4, state0, bid, gain)`` of a JAX CBET trace call
    (``make_cbet_trace_fn(...)()(field4, gain, bid, state0)``) as the
    port's tensors on ``device``: the state as a dict (module docstring),
    ``bid`` int32 per-slot beam ids, ``gain`` the (B, P) table."""
    return (tensor_from_numpy(field4, device),
            state_from_numpy(state0, device),
            tensor_from_numpy(np.asarray(bid, np.int32), device),
            tensor_from_numpy(gain, device))
