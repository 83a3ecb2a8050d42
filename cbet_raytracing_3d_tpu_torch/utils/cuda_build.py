"""Build and load the package's CUDA kernels.

The sources under ``csrc/*.cu`` (with the headers ``csrc/*.cuh`` they
include) have a plain C interface.  ``nvcc`` compiles each source for Hopper
(``sm_90a``) into an object file, all of them at once in parallel, and links
them into one shared library under ``_build/`` (a directory that git
ignores) at first use; the library is loaded with ``ctypes``.  The file name
carries a hash of the sources, headers and flags, so an edited source is
rebuilt and never served from a stale build.  Processes that build at
once (the ranks of a sharded run on one machine) take turns on a lock file
beside the library: the first builds, the others find its library.

A failed build or load raises: there is no fallback for a kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def headers() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


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
    for src in sources() + headers():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libcbet_kernels_{h.hexdigest()[:16]}.so")


@contextlib.contextmanager
def _build_lock():
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".build.lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(force: bool = False) -> str:
    """Compile the kernels if their library is missing (or ``force``);
    return the library path.  One ``nvcc -c`` per source, all started
    together, then one link, under the build lock.  Raises with nvcc's
    output on failure."""
    path = library_path()
    if os.path.exists(path) and not force:
        return path
    with _build_lock():
        if os.path.exists(path) and not force:
            return path             # another process built it meanwhile
        return _compile(path)


def _compile(path: str) -> str:
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o")
            for s in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
            for s, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        failed = []
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=900)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = f"{path}.tmp{tag}"
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(link)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, path)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
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
    d = ctypes.c_double
    signatures = {
        # (edep, cx, cy, cz, fx, fy, fz, inc, n, n_rays, nxp, nyp, nzp,
        #  box_nodes, one_step, overflow, tally, stream)
        "cbet_deposit": [p] * 8 + [ll, ll, i, i, i, i, i, p, p, p],
        # (grids, cx, cy, cz, fx, fy, fz, inc, n, n_rays, rays_per_group,
        #  nxp, nyp, nzp, box_nodes, overflow, tally, stream)
        "cbet_deposit_grouped": [p] * 8 + [ll, ll, ll, i, i, i, i, p, p, p],
        # (edep, cx, cy, cz, fx, fy, fz, inc, ds, u_nogain, uinit, lcx, lcy,
        #  lcz, gain, n_rays, rays_per_group, batch, nx, ny, nz, clip, stop,
        #  tri, gain_only, box_nodes, overflow, gamma, uout, tally, stream)
        "cbet_gain_window": ([p] * 15 + [ll, ll, i, i, i, i, d, d, i, i, i]
                             + [p] * 5),
    }
    for stem, argtypes in signatures.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, stem + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int          # cudaError_t
    _declare_gain(lib)
    # (a, b, out, m, k, n, reps, transpose_lhs, run, resident, grid, stream)
    lib.cbet_mma_probe_bf16.argtypes = [p, p, p] + [i] * 8 + [p]
    lib.cbet_mma_probe_bf16.restype = ctypes.c_int
    lib.cbet_mma_probe_ring_slices.argtypes = []
    lib.cbet_mma_probe_ring_slices.restype = ctypes.c_int
    lib.cbet_box_default_nodes.argtypes = []
    lib.cbet_box_default_nodes.restype = ctypes.c_int
    lib.cbet_error_string.argtypes = [ctypes.c_int]
    lib.cbet_error_string.restype = ctypes.c_char_p


def _declare_gain(lib: ctypes.CDLL) -> None:
    """The entries of ``csrc/gain.cu`` (also of a library built from that
    source alone, ``scripts/gain_sweep.py``)."""
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    # (pair_u, rhat_pre, intensity, out, bo, B, P, iaw2, stream)
    lib.cbet_gain_f32.argtypes = [p, p, p, p, i, i, ll, f, p]
    lib.cbet_gain_f32.restype = ctypes.c_int
    # (pair_u, rhat_pre, intensity, out, B, P, iaw2, stream)
    lib.cbet_gain_pairs_f32.argtypes = [p, p, p, p, i, ll, f, p]
    lib.cbet_gain_pairs_f32.restype = ctypes.c_int
    lib.cbet_gain_pairs_max_beams.argtypes = []
    lib.cbet_gain_pairs_max_beams.restype = ctypes.c_int
