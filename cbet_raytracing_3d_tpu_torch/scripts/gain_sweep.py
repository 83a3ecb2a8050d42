"""The pair kernel's tile and block sizes against its time (K3).

    python -m cbet_raytracing_3d_tpu_torch.scripts.gain_sweep

Builds variants of ``csrc/gain.cu`` whose constants ``kTile``,
``kPairThreads`` and ``kPairBlocks`` (beams of a register tile, threads of a
block, blocks of an SM the compiler is asked to fit) are replaced in a copy
of the source, each into its own library under ``_build/``, all at once.
Runs each at the OMEGA shape (60 beams, 100^3 nodes; the solver's
couplings, a seeded random intensity), holds the pair kernel to the
all-pairs kernel bit for bit, and prints its registers and spills
(``-Xptxas -v``) and the mean milliseconds per call of both kernels (CUDA
events, 10 calls, forward then backward over the variants).  The constants
in ``csrc/gain.cu`` were chosen from this sweep.  Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

from .. import constants as k
from ..config import Config
from ..models import cbet
from ..models import raytracer as rt
from ..utils import cuda_build
from .bench_mma_shapes import card_line
from .box_sweep import cuda_ms

#: (kTile, kPairThreads, kPairBlocks)
VARIANTS = ((12, 256, 2), (6, 256, 2), (10, 256, 2), (15, 256, 2),
            (20, 256, 2), (30, 256, 1), (12, 128, 3), (12, 512, 1),
            (20, 512, 1))
SEED = 20261016


def variant_source(tile: int, threads: int, blocks: int) -> str:
    """``csrc/gain.cu`` with the three constants replaced."""
    with open(os.path.join(cuda_build.CSRC, "gain.cu")) as f:
        src = f.read()
    for name, value in (("kTile", tile), ("kPairThreads", threads),
                        ("kPairBlocks", blocks)):
        src, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};",
                         src)
        if n != 1:
            raise RuntimeError(f"gain.cu: no single definition of {name}")
    return src


def build_variants() -> dict:
    """{variant: (library, ptxas lines)}, the compilers started together."""
    nvcc = cuda_build.find_nvcc()
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for v in VARIANTS:
        stem = os.path.join(cuda_build.BUILD_DIR,
                            "gain_sweep_%d_%d_%d" % v)
        with open(stem + ".cu", "w") as f:
            f.write(variant_source(*v))
        procs[v] = (stem, subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
             stem + ".so", stem + ".cu"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for v, (stem, proc) in procs.items():
        out, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {v}:\n{out}")
        lines = out.splitlines()
        at = next(i for i, l in enumerate(lines)
                  if "Compiling" in l and "gain_pairs_kernel" in l)
        lib = ctypes.CDLL(stem + ".so")
        cuda_build._declare_gain(lib)
        libs[v] = (lib, "; ".join(
            l.replace("ptxas info    :", "").strip()
            for l in lines[at + 1:at + 4] if "spill" in l or "Used" in l))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("gain_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = Config()
    print(f"device={torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{card_line()}; torch {torch.__version__}", flush=True)
    ctx = rt.prepare(cfg)
    rp = np.concatenate([cbet._node_rhat(cfg), cbet.gain_prefactor_field(
        cfg, ctx.fields).reshape(1, -1)]).astype(np.float32)
    pu = cbet.pair_couplings(ctx.beam_norm, cfg.machnum).astype(np.float32)
    B, P = cfg.nbeams, rp.shape[1]
    inten = np.random.default_rng(SEED).uniform(0.0, 1e14, size=(B, P))
    pu, rp, inten = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                     for a in (pu, rp, inten))
    out = torch.empty((B, P), dtype=torch.float32, device=dev)
    want = torch.empty_like(out)
    iaw2 = float(k.IAW) ** 2
    stream = torch.cuda.current_stream(dev).cuda_stream
    libs = build_variants()

    def run(lib, pairs, to):
        ptrs = (pu.data_ptr(), rp.data_ptr(), inten.data_ptr(), to.data_ptr())
        rc = (lib.cbet_gain_pairs_f32(*ptrs, B, P, iaw2, stream) if pairs
              else lib.cbet_gain_f32(*ptrs, B, B, P, iaw2, stream))
        if rc != 0:
            raise RuntimeError(f"launch refused: {rc}")

    ms = {v: {"pairs": [], "all": []} for v in VARIANTS}
    for v in VARIANTS + VARIANTS[::-1]:
        lib = libs[v][0]
        for which in ("pairs", "all"):
            ms[v][which].append(cuda_ms(
                lambda: run(lib, which == "pairs", out), 10))
    for v in VARIANTS:
        lib, ptxas = libs[v]
        run(lib, True, out)
        run(lib, False, want)
        torch.cuda.synchronize()
        print("kTile %d, %d threads, %d blocks per SM: " % v
              + f"pair kernel {sum(ms[v]['pairs']) / 2:.4f} ms, all-pairs "
              f"{sum(ms[v]['all']) / 2:.4f} ms; bit-equal "
              f"{bool(torch.equal(out, want))}; {ptxas}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
