"""Build and load the package's CUDA kernels.

The sources under ``csrc/*.cu`` have a plain C interface.  ``nvcc`` compiles
them for Hopper (``sm_90a``) into one shared library under ``_build/`` (a
directory that git ignores) at first use; the library is loaded with
``ctypes``.  The file name carries a hash of the sources and flags, so an
edited source is rebuilt and never served from a stale build.

A failed build or load raises: there is no fallback for a kernel.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        nvcc = cand if os.path.exists(cand) else None
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built")
    return nvcc


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libcbet_kernels_{h.hexdigest()[:16]}.so")


def build(force: bool = False) -> str:
    """Compile the kernels if their library is missing (or ``force``);
    return the library path.  Raises with nvcc's output on failure."""
    path = library_path()
    if os.path.exists(path) and not force:
        return path
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The kernels' library, built at first use and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _declare(lib)
            _lib = lib
        return _lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("cbet_deposit_f32", "cbet_deposit_f64"):
        fn = getattr(lib, name)
        # (edep, cx, cy, cz, fx, fy, fz, inc, n, nxp, nyp, nzp, overflow,
        #  stream) -> cudaError_t
        fn.argtypes = [p, p, p, p, p, p, p, p, ll, i, i, i, p, p]
        fn.restype = ctypes.c_int
    lib.cbet_error_string.argtypes = [ctypes.c_int]
    lib.cbet_error_string.restype = ctypes.c_char_p
