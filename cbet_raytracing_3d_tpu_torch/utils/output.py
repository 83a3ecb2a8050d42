"""Output writers: canonical text dump, npz, and HDF5.

Counterpart of ``cbet_raytracing_3d_tpu/utils/output.py`` (the same formats,
byte for byte).

Covers the reference's two output paths:

* the ``-D PRINT`` golden dump — the entire ghost-padded edep array as nested
  bracketed lists (main.cu:6-22,353-355), used by ``make test`` for ``cmp``
  regression.  We reproduce the exact format so outputs are
  ``truth_100``-comparable.
* the dormant HDF5 writer (main.cu:37-94): datasets ``/Coordinate_x,y,z`` and
  ``/Edepavg`` where edepavg is the 27-node (3x3x3 ghost-stencil) box average
  (main.cu:334-349).  Live here, gated on h5py availability.
"""

from __future__ import annotations

import io
import json

import numpy as np

from ..config import Config

try:
    import h5py
    HAVE_H5PY = True
except Exception:            # pragma: no cover - availability depends on env
    h5py = None
    HAVE_H5PY = False


def print_nested(arr: np.ndarray, out: io.TextIOBase) -> None:
    """Recursive bracketed dump matching the reference printer (main.cu:6-22):
    comma-joined entries, ``]`` followed by a newline at every level."""
    if arr.ndim == 0:
        out.write(repr(float(arr)))
        return
    out.write("[")
    n = arr.shape[0]
    for i in range(n):
        sub = arr[i]
        if sub.ndim == 0:
            # C++ ostream default: 6 significant digits
            out.write(f"{float(sub):g}")
        else:
            print_nested(sub, out)
        if i != n - 1:
            out.write(",")
    out.write("]\n")


def dump_print_format(edep: np.ndarray) -> str:
    """The full -D PRINT stdout payload for the ghost-padded edep grid."""
    buf = io.StringIO()
    print_nested(edep, buf)
    return buf.getvalue()


def coordinate_meshes(cfg: Config):
    """Node coordinate meshes (main.cu:321-329)."""
    x = (np.arange(cfg.nx) * cfg.dx + cfg.xmin)[:, None, None]
    y = (np.arange(cfg.ny) * cfg.dy + cfg.ymin)[None, :, None]
    z = (np.arange(cfg.nz) * cfg.dz + cfg.zmin)[None, None, :]
    shape = (cfg.nx, cfg.ny, cfg.nz)
    return (np.broadcast_to(x, shape).copy(), np.broadcast_to(y, shape).copy(),
            np.broadcast_to(z, shape).copy())


def edep_box_average(cfg: Config, edep_padded: np.ndarray) -> np.ndarray:
    """27-node box average over the ghost-padded grid (main.cu:334-349):
    ``edepavg[i,j,k] = mean(edep[i:i+3, j:j+3, k:k+3])``.

    Delegates to the native C++ filter when available (NumPy fallback
    inside)."""
    if edep_padded.shape != cfg.edep_shape:
        raise ValueError(f"edep shape {edep_padded.shape} != {cfg.edep_shape}")
    from .native import box_average27
    return box_average27(edep_padded)


def _stat_array(v) -> np.ndarray:
    """A stat as an npz array; a ragged list (the per-rank tile widths of a
    sharded run) as its JSON text."""
    try:
        return np.asarray(v)
    except ValueError:
        return np.asarray(json.dumps(v))


def save_npz(path: str, cfg: Config, edep_padded: np.ndarray,
             stats: dict | None = None, extras: dict | None = None) -> None:
    x, y, z = coordinate_meshes(cfg)
    np.savez_compressed(
        path, edep=edep_padded, edepavg=edep_box_average(cfg, edep_padded),
        coord_x=x, coord_y=y, coord_z=z,
        **(extras or {}),
        **({f"stat_{k}": _stat_array(v) for k, v in (stats or {}).items()}))


def save_hdf5(path: str, cfg: Config, edep_padded: np.ndarray) -> None:
    """HDF5 schema of the reference writer (main.cu:37-94): little-endian f64
    datasets /Coordinate_x, /Coordinate_y, /Coordinate_z, /Edepavg."""
    if not HAVE_H5PY:
        raise RuntimeError("h5py is not available in this environment; "
                           "use save_npz instead")
    x, y, z = coordinate_meshes(cfg)
    with h5py.File(path, "w") as f:
        f.create_dataset("/Coordinate_x", data=x, dtype="<f8")
        f.create_dataset("/Coordinate_y", data=y, dtype="<f8")
        f.create_dataset("/Coordinate_z", data=z, dtype="<f8")
        f.create_dataset("/Edepavg", data=edep_box_average(cfg, edep_padded),
                         dtype="<f8")
