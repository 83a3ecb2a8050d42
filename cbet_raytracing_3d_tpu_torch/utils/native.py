"""ctypes bindings to the native IO runtime (``csrc/cbet_io.cpp``).

Counterpart of ``cbet_raytracing_3d_tpu/utils/native.py``: the same C++
source, built by this package into its own ``_build/`` directory with the
host C++ compiler at first use.  This is host IO, not the device path, so
every entry point falls back to NumPy where the library cannot be built
(no compiler, or the package installed without the repository's ``csrc/``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "csrc", "cbet_io.cpp")
_LIB_PATH = os.path.join(_PKG, "_build", "libcbet_io.so")
_lib = None
_tried = False


def _build() -> bool:
    cxx = shutil.which("g++")
    if cxx is None or not os.path.exists(_SRC):
        return False
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.tmp{os.getpid()}"
    proc = subprocess.run([cxx, "-O3", "-fPIC", "-shared", "-std=c++17",
                           "-o", tmp, _SRC], capture_output=True, timeout=120)
    if proc.returncode != 0:
        return False
    os.replace(tmp, _LIB_PATH)
    return True


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.cbet_parse_profile.restype = ctypes.c_int
    lib.cbet_parse_profile.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")]
    lib.cbet_write_print_dump.restype = ctypes.c_int
    lib.cbet_write_print_dump.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.cbet_box_average27.restype = None
    lib.cbet_box_average27.argtypes = [
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    _lib = lib
    return _lib


def parse_profile(path: str, max_rows: int):
    """Read (r, value) rows; native fscanf loop or np.loadtxt fallback."""
    lib = _load()
    if lib is None:
        rows = np.loadtxt(path)[:max_rows]
        return np.ascontiguousarray(rows[:, 0]), np.ascontiguousarray(rows[:, 1])
    r = np.empty(max_rows, np.float64)
    v = np.empty(max_rows, np.float64)
    n = lib.cbet_parse_profile(path.encode(), max_rows, r, v)
    if n < 0:
        raise FileNotFoundError(path)
    return r[:n].copy(), v[:n].copy()


def write_print_dump(path: str, edep: np.ndarray) -> None:
    """Write the -D PRINT nested dump; native writer or Python fallback."""
    edep = np.ascontiguousarray(edep, np.float64)
    lib = _load()
    if lib is None:
        from .output import dump_print_format
        with open(path, "w") as f:
            f.write(dump_print_format(edep))
        return
    rc = lib.cbet_write_print_dump(path.encode(), edep, *edep.shape)
    if rc != 0:
        raise IOError(f"native dump writer failed: {rc}")


def box_average27(edep_padded: np.ndarray) -> np.ndarray:
    """27-node box average; native loop or NumPy fallback."""
    edep_padded = np.ascontiguousarray(edep_padded, np.float64)
    n0, n1, n2 = (s - 2 for s in edep_padded.shape)
    lib = _load()
    if lib is None:
        out = np.zeros((n0, n1, n2))
        for a in range(3):
            for b in range(3):
                for c in range(3):
                    out += edep_padded[a:a + n0, b:b + n1, c:c + n2]
        return out / 27.0
    out = np.empty((n0, n1, n2), np.float64)
    lib.cbet_box_average27(edep_padded, out, n0, n1, n2)
    return out
