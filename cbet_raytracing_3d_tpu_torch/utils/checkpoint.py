"""Checkpoint / resume for long traces and CBET solves.

Counterpart of ``cbet_raytracing_3d_tpu/utils/checkpoint.py``: one ``.npz``
per checkpoint, written to a temp file and moved into place with
``os.replace`` (an interrupt mid-write never damages the last good
checkpoint), carrying a fingerprint of the run so that a checkpoint cannot
resume another run.

Three kinds, each with a version key of the port's own:

* :func:`save_checkpoint` / :func:`load_checkpoint` -- ``runner.run_resumable``:
  the chunk index, the steps executed, the ``edep_dtype`` master, the
  overflow count and the ray state.
* :func:`save_composed_checkpoint` / :func:`load_composed_checkpoint` --
  ``runner.run_composed``: the same, plus the tile compactor's state (its
  ``tiles`` index, its ``widths`` and, once a compaction has happened, the
  written-back full-layout state).
* :func:`save_cbet_checkpoint` / :func:`load_cbet_checkpoint` --
  ``models.cbet_composed.cbet_solve_composed``: the iteration, the (B, Ph)
  intensity, the history and, on the converged iteration, the coupled edep
  with the run's accounting scalars.

What differs from the JAX package's files, and why the two are **not
interchangeable** (each loader refuses the other's file and says so):

* the JAX package stores the levels of a pairwise float32 accumulator that
  stands in for float64 on a chip without it; the port's master is one
  ``edep_dtype`` (float64) array;
* the JAX package's composed state belongs to a segment of a static tile
  plan and its fingerprint covers the plan; the port compacts by the
  trace's own ``alive`` mask and stores the compactor's state instead.

Tensors go to NumPy on save and come back on the device the caller names.
The files are uncompressed ``np.savez``: ray states are float noise to a
compressor, and deflate costs more time than the bytes it saves.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from ..config import Config
from ..models.raytracer import RayState

#: version keys of the port's files (the JAX package's are
#: ``format_version``, ``composed_version`` and ``cbet_version``)
FORMAT_VERSION = 1
_KEYS = {"trace": "torch_trace_version", "composed": "torch_composed_version",
         "cbet": "torch_cbet_version"}
_JAX_KEYS = ("format_version", "composed_version", "cbet_version")


def config_fingerprint(cfg: Config) -> str:
    blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def run_fingerprint(cfg: Config, device, tag: str) -> str:
    """Config, device type and ray dtype (a card checkpoint holds the
    on-card init's layout, a CPU one the host prepare's), and the kind of
    run."""
    return (f"{tag}-{config_fingerprint(cfg)}-{torch.device(device).type}-"
            f"{cfg.dtype}")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu").numpy()


def _state_payload(state: RayState, prefix: str = "") -> dict:
    return {
        prefix + "frac": np.stack([_np(a) for a in state.frac]),
        prefix + "vel": np.stack([_np(a) for a in state.vel]),
        prefix + "kick": np.stack([_np(a) for a in state.kick]),
        prefix + "uray": _np(state.uray),
        prefix + "uray_init": _np(state.uray_init),
        prefix + "cell": np.stack([_np(a) for a in state.cell]),
        prefix + "alive": _np(state.alive),
    }


def _state_from(data, device, prefix: str = "") -> RayState:
    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def up3(name):
        return tuple(up(data[prefix + name][i]) for i in range(3))

    return RayState(frac=up3("frac"), vel=up3("vel"), kick=up3("kick"),
                    uray=up(data[prefix + "uray"]),
                    uray_init=up(data[prefix + "uray_init"]),
                    cell=up3("cell"), alive=up(data[prefix + "alive"]))


def _write(path: str, payload: dict) -> None:
    # the .npz suffix makes savez write exactly this name
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def _check(data, kind: str, fingerprint: str, path: str) -> None:
    key = _KEYS[kind]
    if key not in data:
        if any(k in data for k in _JAX_KEYS):
            raise ValueError(
                f"{path} is a checkpoint of the JAX package "
                "(cbet_raytracing_3d_tpu): its pairwise accumulator levels "
                "and plan segments have no counterpart here, the two "
                "formats are not interchangeable")
        other = [k for k in _KEYS.values() if k in data]
        raise ValueError(f"{path} is not a {kind} checkpoint of this package"
                         + (f" (it holds {other[0]})" if other else ""))
    if int(data[key]) != FORMAT_VERSION:
        raise ValueError(f"unsupported {kind} checkpoint version: "
                         f"{int(data[key])}")
    fp = str(data["fingerprint"])
    if fp != fingerprint:
        raise ValueError(
            f"checkpoint fingerprint {fp} does not match this run's "
            f"{fingerprint} (another config, device type or kind of run)")


def save_checkpoint(path: str, fingerprint: str, chunk_index: int,
                    steps: int, master: torch.Tensor, state: RayState,
                    oflow: int) -> None:
    """The state after ``chunk_index`` completed chunks.  Atomic."""
    _write(path, dict({_KEYS["trace"]: FORMAT_VERSION,
                       "fingerprint": fingerprint,
                       "chunk_index": int(chunk_index), "steps": int(steps),
                       "master": _np(master), "oflow": int(oflow)},
                      **_state_payload(state)))


def load_checkpoint(path: str, fingerprint: str, device):
    """``(chunk_index, steps, master, state, oflow)`` on ``device``; refuses
    another run's file."""
    with np.load(path) as data:
        _check(data, "trace", fingerprint, path)
        return (int(data["chunk_index"]), int(data["steps"]),
                torch.from_numpy(data["master"]).to(device),
                _state_from(data, device), int(data["oflow"]))


def save_composed_checkpoint(path: str, fingerprint: str, chunk_index: int,
                             steps: int, master: torch.Tensor,
                             state: RayState, oflow: int,
                             compactor: dict) -> None:
    """The compacted trace after ``chunk_index`` completed chunks: the
    state as that chunk left it (before the next boundary's gather) and
    ``compactor``, a ``TileCompactor.state_dict()``.  Atomic."""
    payload = dict({_KEYS["composed"]: FORMAT_VERSION,
                    "fingerprint": fingerprint,
                    "chunk_index": int(chunk_index), "steps": int(steps),
                    "master": _np(master), "oflow": int(oflow),
                    "tiles": _np(compactor["tiles"]),
                    "widths": np.asarray(compactor["widths"], np.int64)},
                   **_state_payload(state))
    if compactor["full"] is not None:
        payload.update(_state_payload(compactor["full"], "full_"))
    _write(path, payload)


def load_composed_checkpoint(path: str, fingerprint: str, device):
    """``(chunk_index, steps, master, state, oflow, compactor)`` on
    ``device``; refuses another run's file."""
    with np.load(path) as data:
        _check(data, "composed", fingerprint, path)
        full = (_state_from(data, device, "full_")
                if "full_uray" in data else None)
        comp = {"tiles": torch.from_numpy(data["tiles"]).to(device),
                "widths": [int(w) for w in data["widths"]], "full": full}
        return (int(data["chunk_index"]), int(data["steps"]),
                torch.from_numpy(data["master"]).to(device),
                _state_from(data, device), int(data["oflow"]), comp)


def save_cbet_checkpoint(path: str, fingerprint: str, iteration: int,
                         intensity: torch.Tensor, history: list,
                         edep: np.ndarray | None = None,
                         accounting: dict | None = None) -> None:
    """The fixed-point state after ``iteration`` completed iterations: the
    (blended) intensity and the history.  No ray state: every iteration
    retraces from the launch state.  ``edep`` and ``accounting`` (the
    run's accounting scalars) ride on the converged iteration's checkpoint
    so that a resume landing there rebuilds the result without a trace.
    Atomic."""
    payload = {_KEYS["cbet"]: FORMAT_VERSION, "fingerprint": fingerprint,
               "iteration": int(iteration), "intensity": _np(intensity),
               "history": np.asarray(history, np.float64)}
    if edep is not None:
        payload["edep"] = np.asarray(edep, np.float64)
        payload["accounting"] = json.dumps(accounting or {})
    _write(path, payload)


def load_cbet_checkpoint(path: str, fingerprint: str, device):
    """``(iteration, intensity, history, edep | None, accounting | None)``;
    refuses another run's file."""
    with np.load(path) as data:
        _check(data, "cbet", fingerprint, path)
        edep = acct = None
        if "edep" in data:
            edep = np.array(data["edep"])
            acct = json.loads(str(data["accounting"]))
        return (int(data["iteration"]),
                torch.from_numpy(data["intensity"]).to(device),
                [float(h) for h in data["history"]], edep, acct)
