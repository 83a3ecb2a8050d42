#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the root of a checkout, with one card:

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero before the last line):

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit from ``nvidia-smi``.
2. build: compiles the CUDA kernels from ``cbet_raytracing_3d_tpu_torch/
   csrc`` with nvcc (sm_90a) and prints the seconds.
3. kernel vs plain: the deposit kernel against its plain PyTorch version on
   the same rows, at the main path's row count on the OMEGA 102^3 grid
   (coherent tiles, boundary exit rows, dead rows) in f32 and f64, and on an
   nz = 130 grid; times both.
4. config-1 golden: float64 trace on the card through the kernel against
   ``tests/golden/config1_oracle.npz``.
5. OMEGA main path: ``runner.run(Config())`` on the card (60 beams, 19,600
   rays each, 100^3 nodes, f32 rays, f64 master) against the same run in
   float64 (the exact reference) and against ``artifacts/omega_golden.npz``;
   the kernel's launch count must equal the steps executed.
6. timing: median of 3 synchronized full traces with the kernel and with the
   plain version, in turns.
7. determinism: rel-L2 between two kernel traces (float atomics reorder).

Then one JSON line describing the kernels, the ``nvidia-smi`` line, and the
final ``{"ok": true, "device": ...}`` line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "cbet_raytracing_3d_tpu_torch"
OMEGA_GOLDEN = os.path.join(REPO, "artifacts", "omega_golden.npz")
OMEGA_TOTAL = 1.5510306647974894e18
CONFIG1_GOLDEN = os.path.join(REPO, "tests", "golden", "config1_oracle.npz")
SEED = 20261016


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def deposit_rows(rng, grid, n, rays_per_tile=256, dead=0.3, boundary=0.05):
    """Synthetic deposit rows in the trace's layout: tiles of
    ``rays_per_tile`` rows whose cells sit in a 10-cell box (or the grid), a share of
    boundary exit rows (a cell on a face with frac beyond +-0.5, so one
    weight is negative) and of dead rows (inc == 0).  Float64 NumPy."""
    grid = np.asarray(grid)
    box = np.minimum(grid, 10)
    n_tiles = -(-n // rays_per_tile)
    lo = rng.integers(0, grid - box + 1, size=(n_tiles, 3))
    cell = [np.repeat(lo[:, a], rays_per_tile)[:n]
            + rng.integers(0, box[a], size=n) for a in range(3)]
    frac = [rng.uniform(-0.4999, 0.4999, size=n) for _ in range(3)]
    inc = rng.uniform(0.5, 2.0, size=n) * 1e9
    exit_rows = np.nonzero(rng.uniform(size=n) < boundary)[0]
    for a in range(3):
        rows = exit_rows[a::3]
        low = rng.uniform(size=rows.size) < 0.5
        cell[a][rows] = np.where(low, 0, grid[a] - 1)
        frac[a][rows] = np.where(low, rng.uniform(-0.95, -0.55, rows.size),
                                 rng.uniform(0.55, 0.95, rows.size))
    inc[rng.uniform(size=n) < dead] = 0.0
    return [c.astype(np.int32) for c in cell], frac, inc


def to_device(cell, frac, inc, dtype, device):
    import torch
    return ([torch.as_tensor(c, device=device) for c in cell]
            + [torch.as_tensor(f, dtype=dtype, device=device) for f in frac]
            + [torch.as_tensor(inc, dtype=dtype, device=device)])


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` calls, timed
    with CUDA events after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, PKG)):
        print(f"chip_smoke: {PKG}/ not found next to this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from cbet_raytracing_3d_tpu_torch.config import Config
    from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
    from cbet_raytracing_3d_tpu_torch.ops import deposit as dep
    from cbet_raytracing_3d_tpu_torch.parallel.sharding import pad_rays
    from cbet_raytracing_3d_tpu_torch.runner import run
    from cbet_raytracing_3d_tpu_torch.utils import cuda_build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    say("1 device", f"{name}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t = time.perf_counter()
    lib_path = cuda_build.build(force=True)
    build_s = time.perf_counter() - t
    cuda_build.load()
    say("2 build", f"nvcc sm_90a -> {os.path.relpath(lib_path, REPO)} in "
        f"{build_s:.3f} s")

    # 3. kernel vs plain, at the main path's row count
    cfg = Config()
    ctx = rt.prepare(cfg)
    n_rows = len(ctx.live_slots)
    rng = np.random.default_rng(SEED)
    kern = {}
    for grid_n, dtypes in (((100, 100, 100), (torch.float32, torch.float64)),
                           ((100, 100, 130), (torch.float32,))):
        shape = tuple(g + 2 for g in grid_n)
        rows = deposit_rows(rng, grid_n, n_rows)
        for dt in dtypes:
            args = to_device(*rows, dt, dev)
            got, of_k = dep.deposit(torch.zeros(shape, dtype=dt, device=dev),
                                    *args)
            want, of_p = dep.deposit_reference(
                torch.zeros(shape, dtype=dt, device=dev), *args)
            torch.cuda.synchronize()
            g64, w64 = got.double().cpu().numpy(), want.double().cpu().numpy()
            err = rel_l2(g64, w64)
            max_abs = float(np.abs(g64 - w64).max())
            tot = abs(g64.sum() - w64.sum()) / abs(w64.sum())
            f32 = dt == torch.float32
            ok = (int(of_k) == 0 and int(of_p) == 0
                  and np.isfinite(g64).all() and w64.min() < 0
                  and (err < 1e-5 and tot < 1e-5 if f32 else err < 1e-12))
            if not ok:
                raise RuntimeError(
                    f"kernel vs plain failed on {shape} {dt}: rel-L2 {err}, "
                    f"total rel {tot}, overflow {int(of_k)}/{int(of_p)}")
            line = (f"grid {shape} {str(dt)[6:]} rows {n_rows}: rel-L2 "
                    f"{err:.3e} total-rel {tot:.3e} max-abs {max_abs:.6e} "
                    "overflow 0")
            if f32 and shape == cfg.edep_shape:
                grid_k = torch.zeros(shape, dtype=dt, device=dev)
                ms = cuda_ms(lambda: dep.deposit(grid_k, *args), 20)
                ms_p = cuda_ms(lambda: dep.deposit_reference(grid_k, *args),
                               20)
                kern = {"max_abs_err": max_abs, "ms": ms, "plain_ms": ms_p}
                line += f"; kernel {ms:.4f} ms plain {ms_p:.4f} ms per call"
            say("3 kernel-vs-plain", line)
            del args, got, want

    # 4. config-1 golden, f64, through the kernel
    data = np.load(CONFIG1_GOLDEN)
    c1 = Config(nbeams=1, rays_per_zone=1, nx=40, ny=40, nz=40,
                dtype="float64", deposit_backend="cuda")
    ctx1 = rt.prepare(c1)
    s1 = rt.select_rays(ctx1.state0, ctx1.layout.slot_of[0, data["rays"]])
    before = dep.LAUNCHES
    e1, _, of1, steps1 = rt.make_trace_fn(c1)(ctx1.field4.to(dev), s1.to(dev))
    e1 = e1.cpu().numpy()
    err1 = rel_l2(e1, data["edep"])
    if not (int(of1) == 0 and err1 < 1e-9
            and dep.LAUNCHES - before == steps1 > 0):
        raise RuntimeError(f"config-1 golden failed: rel-L2 {err1}")
    say("4 config1-golden", f"f64 rel-L2 {err1:.3e} (< 1e-9), "
        f"{steps1} kernel launches")

    # 5. the OMEGA main path, through the runner; then the same scene in
    # float64 (f64 rays, f64 kernel) as the exact reference for the f32 run
    golden = np.load(OMEGA_GOLDEN)["edep"].astype(np.float64)
    dep.LAUNCHES = 0
    res = run(cfg, device=dev, verbose=False)
    launches = dep.LAUNCHES
    st = res.stats
    exact = run(cfg.replace(dtype="float64"), device=dev, verbose=False)
    err_exact = rel_l2(res.edep, exact.edep)
    err = rel_l2(res.edep, golden)
    err_gold_exact = rel_l2(exact.edep, golden)
    tot = abs(st["edep_total"] - OMEGA_TOTAL) / OMEGA_TOTAL
    cons = abs(st["edep_total"] - st["energy_absorbed"]) / st["energy_absorbed"]
    checks = {
        "finite, shape": bool(np.isfinite(res.edep).all()
                              and res.edep.shape == golden.shape),
        "rel-L2 vs exact f64 trace < 1e-4": err_exact < 1e-4,
        # the TPU-recorded golden is itself ~1.5e-4 from the exact trace
        # (its f32 on-device init, bf16 hi/lo deposit and boundary
        # misplacement): hold the grid to 2e-4 of it, its total to 1e-4
        "golden rel-L2 < 2e-4": err < 2e-4,
        "edep_total vs golden rtol 1e-4": tot < 1e-4,
        "edep_total = energy_absorbed (1e-5)": cons < 1e-5,
        "launches == steps > 0": launches == st["steps_executed"] > 0,
        "same rays as the f64 run": all(
            st[k] == exact.stats[k] for k in ("rays_launched",
                                              "rays_alive_at_end")),
    }
    if not all(checks.values()):
        raise RuntimeError(f"OMEGA main path failed: {checks}; rel-L2 exact "
                           f"{err_exact} golden {err}, total rel {tot}, "
                           f"conservation {cons}, launches {launches}, "
                           f"stats {st}")
    say("5 omega-run", f"f32 vs f64 exact rel-L2 {err_exact:.3e}; vs golden "
        f"{err:.3e} (f64 exact vs golden {err_gold_exact:.3e}); edep_total "
        f"{st['edep_total']:.17g} (golden rel {tot:.3e}); "
        f"absorbed-vs-deposited {cons:.3e}; rays_launched "
        f"{st['rays_launched']} rays_alive_at_end {st['rays_alive_at_end']} "
        f"steps {st['steps_executed']} launches {launches} overflow 0")
    say("5 omega-run", "phases " + " ".join(
        f"{k} {v:.6f} s" for k, v in res.timings.items()))

    # 6. timing: full traces, kernel and plain in turns
    state0 = pad_rays(rt.select_rays(ctx.state0, ctx.live_slots),
                      ctx.layout.rays_per_tile).to(dev)
    field4 = ctx.field4.to(dev)
    fns = {"kernel": rt.make_trace_fn(cfg, dep.deposit),
           "plain": rt.make_trace_fn(cfg, dep.deposit_reference)}
    times = {"kernel": [], "plain": []}
    edeps = []
    for which in ("kernel", "plain", "plain", "kernel", "kernel", "plain"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        e, _, of, _ = fns[which](field4, state0)
        torch.cuda.synchronize()
        times[which].append(time.perf_counter() - t)
        if int(of) != 0:
            raise RuntimeError(f"{which} trace overflow {int(of)}")
        if which == "kernel":
            edeps.append(e.cpu().numpy())
    ray_steps = cfg.total_rays * cfg.nt
    med = {k: statistics.median(v) for k, v in times.items()}
    for k in ("kernel", "plain"):
        say("6 timing", f"{k}: trace median {med[k]:.6f} s of "
            f"{[round(x, 6) for x in times[k]]}, "
            f"{ray_steps / med[k]:.6e} nominal ray-steps/s; card {smi}")

    # 7. determinism of the kernel trace
    drift = rel_l2(edeps[1], edeps[0])
    if not drift < 1e-6:
        raise RuntimeError(f"kernel traces differ by rel-L2 {drift}")
    say("7 determinism", f"rel-L2 between two kernel traces {drift:.3e} "
        "(< 1e-6)")

    print(json.dumps({"kernels": [{
        "name": "deposit", "route": "cuda",
        "source": f"{PKG}/csrc/deposit.cu",
        "replaces": "cbet_raytracing_3d_tpu/ops/pallas_deposit.py:527",
        "launches": launches, **kern}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
