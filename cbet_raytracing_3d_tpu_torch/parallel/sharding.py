"""Ray-axis padding.

Counterpart of ``pad_rays`` in ``cbet_raytracing_3d_tpu/parallel/sharding.py``.
The port runs on one device; the multi-device trace is a later slice."""

from __future__ import annotations

import torch

from ..models.raytracer import RayState


def pad_rays(state: RayState, multiple: int) -> RayState:
    """Pad the slot axis to a multiple of ``multiple`` with dead rays."""
    pad = (-state.n) % multiple
    if pad == 0:
        return state

    def pad0(x, fill=0):
        tail = torch.full((pad,), fill, dtype=x.dtype, device=x.device)
        return torch.cat([x, tail])

    return RayState(
        frac=tuple(pad0(a) for a in state.frac),
        vel=tuple(pad0(a) for a in state.vel),
        kick=tuple(pad0(a) for a in state.kick),
        uray=pad0(state.uray),
        # avoid 0 <= stop_frac*0 edge cases in the termination rule
        uray_init=pad0(state.uray_init, fill=1),
        cell=tuple(pad0(a) for a in state.cell),
        alive=pad0(state.alive, fill=False),
    )
