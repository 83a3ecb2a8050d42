#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the root of a checkout, with one card:

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero before the last line):

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit from ``nvidia-smi``.
2. build: compiles the CUDA kernels from ``cbet_raytracing_3d_tpu_torch/
   csrc`` with nvcc (sm_90a) and prints the seconds.
3. kernel vs plain: the deposit kernel (K1) against its plain PyTorch
   version on the same rows.  One step at the main path's row count on the
   OMEGA 102^3 grid (synthetic coherent tiles, boundary exit rows, dead
   rows) in f32 and f64, and on an nz = 130 grid (K5's case), timed in f32
   beside the bound.  Then the main path's window (5 steps x 1,121,280 rows,
   150 steps into the OMEGA trace): through the tile box against the plain
   version and against five direct one-step launches, f32 and f64 (a f64
   window takes the window kernel's direct path by default; the box's
   largest per-node relative error in f64 is printed), and a chunk's five
   windows into one f32 grid against their float64 sum; the box, the five
   launches and the direct kernel timed in turns, beside the bound and the
   blocks that took the box.
4. config-1 golden: float64 trace on the card through the kernel against
   ``tests/golden/config1_oracle.npz``; a launch per 5-step window.
5. OMEGA main path: ``runner.run(Config())`` on the card (60 beams, 19,600
   rays each, 100^3 nodes, f32 rays, f64 master; the rays initialized on
   the card, ``prepare_device``) against the same run in float64 (the exact
   reference) and against ``artifacts/omega_golden.npz``; the kernel's
   launch count must equal the windows traced (steps / 5).
6. timing: median of 3 synchronized full traces with the kernel (windows),
   with the kernel on every step (``deposit_batch_steps=1``) and with the
   plain version, in turns.
7. determinism: rel-L2 between two kernel traces (float atomics reorder);
   the windowed trace against the per-step one, f32 and f64.
8. CBET kernels vs plain, at the main path's shapes, timed with CUDA events:
   the grouped intensity deposit (K2) into 60 beam grids on one synthetic
   step (boundary exits, dead rows, scattered tiles), f32 and f64, and its
   refusal of more rays than its groups hold; the gain reduction (K3) at
   60 beams x 100^3 nodes: the pair kernel (each beam pair once) against
   the plain version and bit for bit against the all-pairs kernel, both
   timed in turns, and the b_out form on the all-pairs kernel; the window-gain deposit
   (K4 "cell") on an OMEGA window (5 steps, mid-trace, a smooth synthetic
   gain of both signs, rays dying mid-window) and K2 on that window's
   5 x 1,228,800 rows (its contributions contrib0 * gamma), f32 and f64.
   K2 and K4 are timed with their shared-memory tile box and on the direct
   path (capacity 0) in turns, each line with the bound and the blocks that
   took the box.
9. OMEGA CBET, lookup mode: ``runner.run(Config(), with_cbet=True)`` on the
   card and the same in float64 (the exact reference); both converge in 5
   iterations; f32 against f64; both against ``artifacts/cbet_golden.npz``;
   the lookup advances 5-step windows (``deposit_batch_steps``), so K1/K2
   launches equal the windows traced (K1 also the uncoupled trace's
   windows), K3 launches the iterations, all through the pair kernel.
10. OMEGA CBET, kernel_cell mode (the JAX bench's configuration): f32 and
   f64 against phase 9's solves; K4 launches equal the windows traced.
11. timing: a 1-iteration warm-up per solver, then full kernel_cell solves
   with the kernels, with K3's all-pairs kernel in place of the pair
   kernel (three each), and once with the plain versions of K1-K4, in turns;
   median solve seconds and per-iteration gain/trace/update seconds.
12. K4 "tri" and K4 gain-only (both modes) against their plain versions on
   phase 8's OMEGA window, f32 and f64: edep, gamma, uout, overflow;
   gain-only leaves edep bit-untouched; CUDA-event times ("tri" with the
   box and on the direct path, in turns).
13. the OMEGA CBET opt-ins, f32, each after a 1-iteration warm-up (or on a
   warm cached solver): (a) ``cbet_gain_mode="kernel"`` (K4 "tri"): its
   deviation from the kernel_cell solve as a share of the CBET effect,
   below 1; (b) light iterations in kernel_cell and lookup: the full
   solve's iterations, history, edep and intensity within the card's
   atomic drift, gain-only launches equal the light traces' windows, and
   light vs full kernel_cell solve seconds, two each, in turns;
   (c) ``cbet_accel="anderson"``: no more iterations than the plain solve,
   the same first history entry, edep within the tolerance truncation;
   (d) ``cbet_gain_stride=5`` in lookup: its deviation from the stride-1
   solve as a share of the CBET effect, below 0.6; (e) one lookup trace
   with the per-step deposits against the batched one, in turns.
14. device init: ``prepare_device`` on the card against the host
   ``prepare`` at OMEGA, f64 and f32: launched masks and cells identical,
   float values equal (at most 1e-4 of them 1 ulp apart), ``beam_id`` -1
   exactly on pads; seconds of both paths, first and second call.
15. the compacted OMEGA trace (the JAX CLI's default: ``runner.run(cfg,
   cache_dir=...)``) against ``runner.run(cfg)``: f64 <= 1e-12 rel-L2, f32
   within 2x phase 7's drift, ``trace_stats`` counts identical, energy
   conserved, K1 launches = steps / 5; the tile widths; both traces timed,
   median of 3 in turns.
16. the compacted CBET solve (the JAX bench's kernel_cell with
   ``cbet_segmented=True``, ``cbet_plan_headroom=0.5``; and lookup), f32,
   through the runner with a cache dir: 5 iterations, history within 1e-3
   of phases 9/10, edep and intensity within max(1e-6, 2x phase 13's drift),
   K2/K4 launches = windows; f64 kernel_cell <= 1e-10; seeded solves
   compacted and uncompacted, median of 3 in turns.
17. K6, the tensor-core probe (wgmma + TMA), against its plain version and
   the earlier mma.sync kernel at the six shapes of
   ``scripts/bench_mxu_shapes.py`` (rel-L2 <= 1e-5), timed in turns with
   that kernel and beside ``torch.matmul`` in bf16; the drift and time per
   chain length; ``bench_mma_shapes`` in this process (its launches) and
   as a subprocess (rc 0).
18. the resumable OMEGA trace: ``runner.run_composed`` uninterrupted against
   phase 15's compacted run; stopped after a mid-width chunk and after a
   chunk whose boundary compacts, each resumed from its checkpoint: stats,
   widths and steps equal, edep within 2x phase 7's drift; K1 launches =
   windows; another config's checkpoint refused; seconds and bytes of one
   checkpoint write and read.
19. the composed OMEGA CBET solve: ``cbet_solve_composed`` uninterrupted
   against phase 9's lookup solve; stopped after two iterations and resumed
   with ``cbet_max_iters`` raised; a resume on the converged checkpoint (no
   launch, the accounting kept); four serial beam groups against one;
   K2 launches = windows x groups, K3 = iterations; then ``cli run
   --composed --cbet`` with both checkpoints as a subprocess (rc 0).

Phases 15, 16, 18 and 19 print their peak device memory beside
``runner.estimate_device_bytes``; 15, 18 and 19 fail when a peak exceeds the
estimate (``runner.check_memory`` decides on it).

Then one JSON line describing the kernels (each with its bound on this card:
the larger of its bytes over 3.35 TB/s and its operations over the peak of
their type), the ``nvidia-smi`` line, and the final ``{"ok": true,
"device": ...}`` line.
"""

from __future__ import annotations

import dataclasses
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
CBET_GOLDEN = os.path.join(REPO, "artifacts", "cbet_golden.npz")
CBET_TOTAL = 1.6515210646281257e18
CBET_HISTORY = (0.30723, 0.12011, 0.05411, 0.00817, 0.00211)
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


def cbet_layout(cfg, ctx, device, dtype=None):
    """The CBET solver's slot layout on ``device``: each beam's launched
    tiles, block-padded (``models.cbet.live_tile_slots``); returns
    ``(state, rays_per_group)``."""
    from cbet_raytracing_3d_tpu_torch.models import cbet
    from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
    slots = cbet.live_tile_slots(cfg, ctx)
    state = rt.select_rays(ctx.state0, slots).to(device)
    if dtype is not None:
        state = state.map(lambda a: a.to(dtype) if a.is_floating_point()
                          else a)
    return state, len(slots) // cfg.nbeams


def smooth_gain(rng, cfg, scale, dtype, device, block=4):
    """A smooth synthetic (B, P) gain field of both signs: a normal field
    on every ``block``-th node, repeated over the block (the field of
    tests/test_cbet.py:1063-1069), times ``scale``."""
    import torch
    n = [-(-m // block) for m in (cfg.nx, cfg.ny, cfg.nz)]
    out = torch.empty((cfg.nbeams, cfg.nx * cfg.ny * cfg.nz), dtype=dtype,
                      device=device)
    ones = np.ones((block,) * 3)
    for b in range(cfg.nbeams):
        g = np.kron(rng.standard_normal(n), ones)[:cfg.nx, :cfg.ny, :cfg.nz]
        out[b] = torch.as_tensor(g.reshape(-1) * scale, dtype=dtype)
    return out


def window_case(cfg, ctx, device, dtype, warm_steps, gain, rows=None):
    """One kernel_cell window of the scene's CBET layout after
    ``warm_steps`` ordinary steps: ``(state, args)`` with ``state`` the
    post-window state and ``args`` the window-gain deposit's arguments
    after ``edep`` (``models.cbet.make_window_advance``).  A dict passed as
    ``rows`` receives the window's rows (``make_window_advance``'s)."""
    from cbet_raytracing_3d_tpu_torch.models import cbet
    from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
    state, rpg = cbet_layout(cfg, ctx, device, dtype)
    field4 = ctx.field4.to(device, dtype)
    step = rt.make_deferred_step_fn(cfg)
    for _ in range(warm_steps):
        state, _ = step(state, field4)
    st, w = cbet.make_window_advance(cfg)(state, field4)
    if rows is not None:
        rows.update(w)
    args = (w["cx"], w["cy"], w["cz"], w["fx"], w["fy"], w["fz"], w["inc"],
            w["ds"], w["u_nogain"], st.uray_init, w["lcx"], w["lcy"],
            w["lcz"], gain, rpg, cbet.GAIN_CLIP, cfg.stop_fraction)
    return st, args


def k2_window_args(w, gamma, rays_per_group):
    """K2's arguments after the grids on the main path's window: the
    window's step-major rows with the intensity contributions
    ``contrib0 * gamma`` (``models/cbet.py``'s ``window_step``; the CBET
    grid is the full grid at ``cbet_grid_downsample`` 1)."""
    flat = [w[k].reshape(-1) for k in ("cx", "cy", "cz", "fx", "fy", "fz")]
    contrib = (w["contrib0"] * gamma).reshape(-1)
    return (*flat, contrib, rays_per_group, w["cx"].shape[1])


def in_turns(fns: dict, reps: int) -> dict:
    """Milliseconds per call of each of two ``fns`` (name -> callable),
    CUDA events over ``reps`` calls, timed in turns a, b, b, a; returns the
    mean of each one's two readings."""
    a, b = fns
    got = {a: [], b: []}
    for name in (a, b, b, a):
        got[name].append(cuda_ms(fns[name], reps))
    return {k: sum(v) / len(v) for k, v in got.items()}


def box_share(launch, device) -> tuple:
    """(blocks with rows, blocks that took the tile box) of one launch:
    ``launch(tally)`` runs the kernel with an int32 (2,) tally."""
    import torch
    tally = torch.zeros(2, dtype=torch.int32, device=device)
    launch(tally)
    torch.cuda.synchronize()
    return int(tally[0]), int(tally[1])


def gain_case(rng, cfg, ctx, device):
    """The gain reduction's inputs at the scene's shapes: ``pair_u`` and
    ``rhat_pre`` as ``models.cbet.make_gain_fn`` builds them, and a random
    float32 intensity of the W/cm^2 scale."""
    import torch
    from cbet_raytracing_3d_tpu_torch.models import cbet
    rhat = cbet._node_rhat(cfg)
    pre = cbet.gain_prefactor_field(cfg, ctx.fields).reshape(-1)
    rp = np.concatenate([rhat, pre[None]]).astype(np.float32)
    pu = cbet.pair_couplings(ctx.beam_norm, cfg.machnum).astype(np.float32)
    inten = rng.uniform(0.0, 1e14, size=(cfg.nbeams, rhat.shape[1]))
    return (torch.as_tensor(pu, device=device),
            torch.as_tensor(rp, device=device),
            torch.as_tensor(inten, dtype=torch.float32, device=device))


def gain_all_pairs(pair_u, rhat_pre, intensity):
    """K3 through its all-pairs kernel whatever the couplings (what the
    wrapper ran before the pair kernel): for solves timed beside the
    wrapper's."""
    from cbet_raytracing_3d_tpu_torch.ops import gain as gop
    from cbet_raytracing_3d_tpu_torch.utils import cuda_build
    gop._check_shapes(pair_u, rhat_pre, intensity)
    return gop._launch(cuda_build.load(), pair_u, rhat_pre, intensity, False)


# The card's published rates (H100 SXM at 700 W; NVIDIA's data sheet): HBM3
# bytes/s, and flop/s of float32 outside the tensor cores and of dense bf16
# on them.  A bound is the larger of the bytes a call must move (each input
# read once, each output written once) over the memory rate and its
# operations over the peak rate of their type.
HBM_BPS = 3.35e12
PEAK_F32 = 67e12
# operations of one live deposit row: the three weights and their
# complements (12), the eight corner products inc*wx*wy*wz (24) and the
# eight adds of the atomics (8)
DEPOSIT_OPS = 44
# a window-gain step adds the gain factor (g*ds, clip, exp, the cumulative
# product, the termination test: 6) to the deposit's operations; the tri
# form samples eight corners (16 more); the gain-only forms skip the adds
GAIN_STEP_OPS = 6
TRI_SAMPLE_OPS = 16


def bound(nbytes: float, nops: float, peak: float) -> dict:
    """``bound_ms`` and ``bound_by`` of a call that moves ``nbytes`` and
    does ``nops`` operations at ``peak`` operations/s."""
    t_bytes, t_ops = nbytes / HBM_BPS, nops / peak
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def deposit_bytes(inc) -> int:
    """The bytes a trilinear deposit must read of its f32 rows: every row's
    contribution, and the three int32 cells and three fracs only of the rows
    that deposit (contribution != 0)."""
    return 4 * inc.numel() + 24 * int((inc != 0).sum())


def touched(grid) -> int:
    """Grid nodes a deposit wrote (non-zero after a deposit into zeros):
    each is read and written once."""
    return int((grid != 0).sum())


def gain_nodes(cfg, cells, fracs, live, rows_per_group, tri: bool) -> int:
    """Distinct (beam, node) entries of the (B, P) gain table that a window
    reads: at the sampled cell of each live row, or ("tri") at the eight
    in-grid corners of its deposit position."""
    import torch
    from cbet_raytracing_3d_tpu_torch.ops import deposit as dep
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    flat_rows = [a.reshape(-1) for a in cells]
    n_rays = cells[0].shape[-1]
    beam = ((torch.arange(flat_rows[0].shape[0], device=live.device)
             % n_rays) // rows_per_group)
    live = live.reshape(-1)
    if not tri:
        cx, cy, cz = (a.to(torch.int64) for a in flat_rows)
        keys = (beam * (nx * ny * nz) + (cx * ny + cy) * nz + cz)[live]
    else:
        fx, fy, fz = (a.reshape(-1) for a in fracs)
        nxp, nyp, nzp = cfg.edep_shape
        idx, _, ok = dep._corner_parts(*flat_rows, fx, fy, fz,
                                       torch.ones_like(fx), cfg.edep_shape)
        x = idx // (nyp * nzp) - 1
        y = (idx // nzp) % nyp - 1
        z = idx % nzp - 1
        inside = ((x >= 0) & (x < nx) & (y >= 0) & (y < ny) & (z >= 0)
                  & (z < nz) & (live & ok)[:, None])
        keys = (beam[:, None] * (nx * ny * nz)
                + (x * ny + y) * nz + z)[inside]
    return int(torch.unique(keys).numel())


def k4_bound(cfg, args, gain_out, grid, tri: bool, gain_only: bool) -> dict:
    """The window-gain deposit's bound from one call's arguments (``args``
    after ``edep``), its gamma and the plain version's grid from zeros.

    A row is read only up to its ray's first death in the window (a later
    row's gamma is 0 whatever it holds): its ds, u_nogain and inc; the gain
    sample's cells (the entry cell, or "tri" the deposit corners) only
    where ds != 0; the deposit's cells and fracs only where inc != 0."""
    import torch
    n = args[0].shape[1]
    rpg = args[11] if tri else args[14]
    inc, ds = args[6], args[7]
    # rows at or before the first death: step 0, or no death up to step j-1
    read = torch.ones_like(ds, dtype=torch.bool)
    read[1:] = gain_out[:-1] != 0
    live = read & (ds != 0)                    # the gain factor is needed
    dep_rows = read & (inc != 0)
    if tri:
        nodes = gain_nodes(cfg, args[0:3], args[3:6], live, rpg, True)
        corner_rows = live | dep_rows
        nbytes = 24 * int(corner_rows.sum())
    else:
        nodes = gain_nodes(cfg, args[10:13], None, live, rpg, False)
        nbytes = 12 * int(live.sum()) + 24 * int(dep_rows.sum())
    nbytes += (12 * int(read.sum()) + 4 * n + 4 * nodes
               + 4 * gain_out.numel() + 4 * n)
    ops_row = GAIN_STEP_OPS + DEPOSIT_OPS + (TRI_SAMPLE_OPS if tri else 0)
    if not gain_only:
        nbytes += 8 * touched(grid)
    else:
        ops_row -= 8
    return bound(nbytes, ops_row * int(live.sum()), PEAK_F32)


def cuda_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` calls, timed
    with CUDA events after one warm-up call.  ``queued`` holds the stream
    with a device-side sleep (~25 ms) while the host enqueues the calls, so
    calls shorter than their launch run back to back and the time is the
    device's, not the host's launch rate."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(50_000_000)
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
            if f32:
                # each row's inc, the cells and fracs of the rows that
                # deposit, the nodes written
                kb = bound(deposit_bytes(args[6]) + 8 * touched(want),
                           DEPOSIT_OPS * int((args[6] != 0).sum()), PEAK_F32)
                grid_k = torch.zeros(shape, dtype=dt, device=dev)
                ms = cuda_ms(lambda: dep.deposit(grid_k, *args), 20)
                ms_p = cuda_ms(lambda: dep.deposit_reference(grid_k, *args),
                               20)
                if shape == cfg.edep_shape:
                    one_step = {"one_step_ms": ms, "one_step_plain_ms": ms_p,
                                "one_step_bound_ms": kb["bound_ms"]}
                line += (f"; kernel {ms:.4f} ms plain {ms_p:.4f} ms per "
                         f"call, bound {kb['bound_ms']:.4f} ms "
                         f"({kb['bound_by']})")
            say("3 kernel-vs-plain", line)
            del args, got, want

    rows3, kern = deposit_window_vs_plain(cfg, ctx, dev)
    kern.update(one_step)
    for line in rows3:
        say("3 kernel-vs-plain", line)

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
    batch = c1.deposit_batch_steps
    launches1 = dep.LAUNCHES - before
    if not (int(of1) == 0 and err1 < 1e-9 and rt.batched(c1)
            and launches1 * batch == steps1 > 0):
        raise RuntimeError(f"config-1 golden failed: rel-L2 {err1}, "
                           f"{launches1} launches over {steps1} steps")
    say("4 config1-golden", f"f64 rel-L2 {err1:.3e} (< 1e-9), {steps1} steps,"
        f" {launches1} kernel launches (one per {batch}-step window)")

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
        "launches == steps / 5 > 0": (
            rt.batched(cfg) and launches * batch == st["steps_executed"] > 0),
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
        f"steps {st['steps_executed']} launches {launches} (one per {batch}-"
        f"step window) overflow 0")
    say("5 omega-run", "phases " + " ".join(
        f"{k} {v:.6f} s" for k, v in res.timings.items()))

    # 6. timing: full traces, kernel and plain in turns
    state0 = pad_rays(rt.select_rays(ctx.state0, ctx.live_slots),
                      ctx.layout.rays_per_tile).to(dev)
    field4 = ctx.field4.to(dev)
    per_step_cfg = cfg.replace(deposit_batch_steps=1)
    fns = {"kernel": rt.make_trace_fn(cfg, dep.deposit),
           "kernel, a deposit per step": rt.make_trace_fn(per_step_cfg,
                                                          dep.deposit),
           "plain": rt.make_trace_fn(cfg, dep.deposit_reference)}
    times = {k: [] for k in fns}
    edeps = {k: [] for k in fns}
    order = list(fns)
    for which in order + order[::-1] + order:
        torch.cuda.synchronize()
        before = dep.LAUNCHES
        t = time.perf_counter()
        e, _, of, steps = fns[which](field4, state0)
        torch.cuda.synchronize()
        times[which].append(time.perf_counter() - t)
        # a launch per window, per step, or none (the plain version)
        want = {"kernel": steps // batch, "plain": 0}.get(which, steps)
        if int(of) != 0 or dep.LAUNCHES - before != want:
            raise RuntimeError(f"{which} trace: overflow {int(of)}, "
                               f"{dep.LAUNCHES - before} launches over "
                               f"{steps} steps")
        if which != "plain":
            edeps[which].append(e.cpu().numpy())
    ray_steps = cfg.total_rays * cfg.nt
    med = {k: statistics.median(v) for k, v in times.items()}
    for k in fns:
        say("6 timing", f"{k} ({steps} steps): trace median {med[k]:.6f} s of "
            f"{[round(x, 6) for x in times[k]]}, "
            f"{ray_steps / med[k]:.6e} nominal ray-steps/s; card {smi}")

    # 7. determinism of the kernel trace; windows against a deposit per step
    drift = rel_l2(edeps["kernel"][1], edeps["kernel"][0])
    drift_1 = rel_l2(edeps["kernel, a deposit per step"][1],
                     edeps["kernel, a deposit per step"][0])
    d32 = rel_l2(edeps["kernel"][0], edeps["kernel, a deposit per step"][0])
    c64 = cfg.replace(dtype="float64")
    ctx64 = rt.prepare(c64)
    state64 = rt.traced_state(ctx64, dev)
    field64 = ctx64.field4.to(dev)
    e64 = [rt.make_trace_fn(c)(field64, state64)[0].cpu().numpy()
           for c in (c64, c64.replace(deposit_batch_steps=1),
                     c64.replace(deposit_batch_steps=1))]
    d64, drift64 = rel_l2(e64[0], e64[1]), rel_l2(e64[2], e64[1])
    del state64, field64, ctx64
    # f32: the two traces add the same values into f32 chunk grids in another
    # grouping (a block's window is summed exactly in its box and added once;
    # per step every corner is added on its own), so they differ by the
    # chunk grids' rounding, above the drift of one grouping's atomics
    if not (drift < 1e-6 and drift_1 < 1e-6 and d32 < 1e-5 and d64 < 1e-12):
        raise RuntimeError(f"kernel traces differ: windows twice {drift}, a "
                           f"deposit per step twice {drift_1}, windows vs a "
                           f"deposit per step f32 {d32} f64 {d64}")
    say("7 determinism", f"rel-L2 between two kernel traces {drift:.3e} "
        f"(< 1e-6; with a deposit per step {drift_1:.3e}); windows vs a "
        f"deposit per step: f32 {d32:.3e} (< 1e-5), f64 {d64:.3e} (< 1e-12; "
        f"two f64 traces with a deposit per step {drift64:.3e})")

    # 8. CBET kernels vs plain, at the main path's shapes
    from cbet_raytracing_3d_tpu_torch.models import cbet
    from cbet_raytracing_3d_tpu_torch.ops import gain as gop
    from cbet_raytracing_3d_tpu_torch.ops import gain_deposit as gdep
    from cbet_raytracing_3d_tpu_torch.ops import mma_probe as mp
    rows8, kern8 = cbet_kernels_vs_plain(cfg, ctx, dev, rng)
    for line in rows8:
        say("8 cbet-kernels", line)

    # 9. the CBET main path, lookup mode, through the runner; then float64
    counters = (("K1", dep, "LAUNCHES"), ("K2", dep, "GROUPED_LAUNCHES"),
                ("K3", gop, "LAUNCHES"), ("K3 pairs", gop, "PAIR_LAUNCHES"),
                ("K4", gdep, "LAUNCHES"),
                ("K4 tri", gdep, "TRI_LAUNCHES"),
                ("K4 gain-only", gdep, "GAIN_ONLY_LAUNCHES"),
                ("K6", mp, "LAUNCHES"),
                ("K6 mma.sync", mp, "WMMA_LAUNCHES"))

    def zero_counts():
        for _, mod, attr in counters:
            setattr(mod, attr, 0)

    def read_counts():
        return {name: getattr(mod, attr) for name, mod, attr in counters}

    golden_c = np.load(CBET_GOLDEN)["edep"].astype(np.float64)
    zero_counts()
    look = run(cfg, with_cbet=True, device=dev, verbose=False)
    n9 = read_counts()
    look64 = run(cfg.replace(dtype="float64"), with_cbet=True, device=dev,
                 verbose=False)
    c32, c64 = look.cbet, look64.cbet
    batch = cfg.deposit_batch_steps
    steps9 = sum(c32.stats["trace_steps"])
    windows9 = steps9 // batch
    d_gold = rel_l2(c64.edep, golden_c)
    d_gold_tot = abs(c64.edep.sum() - CBET_TOTAL) / CBET_TOTAL
    # the golden's own distance from the exact solve sets its bars
    # (the OMEGA trace golden sits 1.47e-4 from the exact trace)
    exact_ok = d_gold < 1.5e-4 and d_gold_tot < 1e-4
    bar_grid = 2e-4 if exact_ok else d_gold + 5e-5
    bar_tot = 1e-4 if exact_ok else d_gold_tot + 5e-5
    hist_rel = [abs(a / b - 1) for a, b in zip(c32.history, c64.history)]
    # per-beam intensity fields resolve single rays' cell choices, which f32
    # positions flip: the zero-gain (iteration-0) intensity of the f32 trace
    # is already ~3e-4 from the f64 one (the JAX package's f32 trace shows
    # the same).  The solve is held not to amplify that distance.
    i0 = {}
    for dt in ("float32", "float64"):
        c = cfg.replace(dtype=dt, cbet_max_iters=0)
        i0[dt] = cbet.cbet_solve(c, rt.prepare(c), dev).intensity
    d_i0 = rel_l2(i0["float32"], i0["float64"])
    bar_int = max(1e-4, 1.5 * d_i0)
    for tag, r in (("f32", look), ("f64", look64)):
        c = r.cbet
        say("9 cbet-lookup", f"{tag}: {c.iterations} iterations, history "
            f"{[f'{h:.5f}' for h in c.history]} (golden {list(CBET_HISTORY)}); "
            f"golden rel-L2 {rel_l2(c.edep, golden_c):.6e}, edep_total "
            f"{c.edep.sum():.17g} (golden rel "
            f"{abs(c.edep.sum() - CBET_TOTAL) / CBET_TOTAL:.6e}); "
            f"CBET/uncoupled edep_total "
            f"{c.edep.sum() / r.edep.sum():.9f}; rays_terminated "
            f"{c.stats['rays_terminated']} rays_alive_at_end "
            f"{c.stats['rays_alive_at_end']}; CBET phase "
            f"{r.timings['CBET']:.6f} s")
    say("9 cbet-lookup", f"f32 vs f64: edep rel-L2 "
        f"{rel_l2(c32.edep, c64.edep):.3e}, intensity rel-L2 "
        f"{rel_l2(c32.intensity, c64.intensity):.3e} (iteration 0: "
        f"{d_i0:.3e}), history max rel {max(hist_rel):.3e}; f64 vs golden: "
        f"grid {d_gold:.6e}, total {d_gold_tot:.6e} -> bars grid "
        f"{bar_grid:.3e} total {bar_tot:.3e}; launches {n9} over "
        f"{len(c32.stats['trace_steps'])} traces of {steps9} steps "
        f"({windows9} windows)")
    checks = {}
    for tag, r in (("f32", look), ("f64", look64)):
        c = r.cbet
        tot = abs(c.edep.sum() - CBET_TOTAL) / CBET_TOTAL
        checks.update({
            f"{tag}: 5 iterations, converged": (c.iterations == 5
                                                and c.converged),
            f"{tag}: finite, shape": bool(np.isfinite(c.edep).all()
                                          and c.edep.shape == golden_c.shape
                                          and np.isfinite(c.intensity).all()),
            f"{tag}: golden rel-L2 < {bar_grid:.3e}":
                rel_l2(c.edep, golden_c) < bar_grid,
            f"{tag}: golden total < {bar_tot:.3e}": tot < bar_tot,
            f"{tag}: history within 20% of the golden's": all(
                abs(h / g - 1) < 0.2 for h, g in zip(c.history,
                                                     CBET_HISTORY)),
        })
    checks.update({
        "f32 vs f64 edep rel-L2 < 1e-4": rel_l2(c32.edep, c64.edep) < 1e-4,
        f"f32 vs f64 intensity rel-L2 < {bar_int:.3e}":
            rel_l2(c32.intensity, c64.intensity) < bar_int,
        "f32 history within 2% of f64": max(hist_rel) < 0.02,
        "K3 launches == iterations, all the pair kernel's":
            n9["K3"] == n9["K3 pairs"] == c32.iterations,
        "batched lookup": cbet.batched(cfg) and steps9 % batch == 0,
        "K2 launches == CBET windows > 0": n9["K2"] == windows9 > 0,
        "K1 launches == CBET windows + uncoupled windows": (
            n9["K1"] == windows9 + look.stats["steps_executed"] // batch),
        "K4 not on the lookup path": (
            n9["K4"] == n9["K4 tri"] == n9["K4 gain-only"] == 0),
    })
    if not all(checks.values()):
        raise RuntimeError(f"OMEGA CBET (lookup) failed: "
                           f"{[k for k, v in checks.items() if not v]}")

    # 10. kernel_cell, the JAX bench's configuration
    cfg_kc = cfg.replace(cbet_gain_mode="kernel_cell")
    zero_counts()
    kc = run(cfg_kc, with_cbet=True, device=dev, verbose=False)
    n10 = read_counts()
    kc64 = run(cfg_kc.replace(dtype="float64"), with_cbet=True, device=dev,
               verbose=False)
    k32, k64 = kc.cbet, kc64.cbet
    windows = sum(k32.stats["trace_steps"]) // batch
    say("10 cbet-kernel-cell", f"iterations {k32.iterations}/"
        f"{k64.iterations}; history f32 "
        f"{[f'{h:.5f}' for h in k32.history]}; vs lookup: f32 edep "
        f"{rel_l2(k32.edep, c32.edep):.3e} intensity "
        f"{rel_l2(k32.intensity, c32.intensity):.3e}, f64 edep "
        f"{rel_l2(k64.edep, c64.edep):.3e} intensity "
        f"{rel_l2(k64.intensity, c64.intensity):.3e}; golden rel-L2 f32 "
        f"{rel_l2(k32.edep, golden_c):.6e} f64 "
        f"{rel_l2(k64.edep, golden_c):.6e}; launches {n10} over {windows} "
        f"windows; CBET phase {kc.timings['CBET']:.6f} s")

    checks = {
        "5 iterations (f32, f64)": k32.iterations == k64.iterations == 5,
        "f32 edep vs lookup < 1e-5": rel_l2(k32.edep, c32.edep) < 1e-5,
        "f32 intensity vs lookup < 1e-5":
            rel_l2(k32.intensity, c32.intensity) < 1e-5,
        "f64 edep vs lookup < 1e-10": rel_l2(k64.edep, c64.edep) < 1e-10,
        "f64 intensity vs lookup < 1e-10":
            rel_l2(k64.intensity, c64.intensity) < 1e-10,
        "f64 terminations equal": all(
            k64.stats[key] == c64.stats[key]
            for key in ("rays_terminated", "rays_alive_at_end")),
        "K4 launches == windows > 0": n10["K4"] == windows > 0,
        "K2 launches == windows": n10["K2"] == windows,
        "K3 launches == iterations, all the pair kernel's":
            n10["K3"] == n10["K3 pairs"] == k32.iterations,
        "K1 only in the uncoupled trace, per window":
            n10["K1"] * batch == kc.stats["steps_executed"],
        "no tri, no gain-only": n10["K4 tri"] == n10["K4 gain-only"] == 0,
    }
    if not all(checks.values()):
        raise RuntimeError(f"OMEGA CBET (kernel_cell) failed: "
                           f"{[k for k, v in checks.items() if not v]}; "
                           f"launches {n10}")

    # 11. timing: kernel_cell solves, kernels and plain versions in turns
    ctx_kc = rt.prepare(cfg_kc)
    variants = {"kernel": cbet.kernel_ops(),
                "kernel, K3 all-pairs": dataclasses.replace(
                    cbet.kernel_ops(), gain=gain_all_pairs),
                "plain": cbet.plain_ops()}
    for ops in variants.values():      # warm-up: builds the solver + seed
        cbet.cbet_solve(cfg_kc.replace(cbet_max_iters=1), ctx_kc, dev,
                        ops=ops)
    solves = {k: [] for k in variants}
    order = list(variants)
    zero_counts()
    # the plain solve (8 s) once: its repeats taught nothing new
    for which in order + order[-2::-1] + order[:-1]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = cbet.cbet_solve(cfg_kc, ctx_kc, dev, ops=variants[which])
        solves[which].append((time.perf_counter() - t, r))
    n11 = read_counts()
    # the two K3 kernels agree bit for bit, so their solves differ by the
    # float atomics' drift alone
    same = solves["kernel"][0][1], solves["kernel, K3 all-pairs"][0][1]
    h11 = max(abs(a / b - 1) for a, b in zip(same[0].history,
                                             same[1].history))
    if not (n11["K3"] == n11["K3 pairs"] == 15 and h11 < 1e-4):
        raise RuntimeError(f"timing solves: K3 launches {n11}, histories "
                           f"{same[0].history} / {same[1].history}")
    for which, runs in solves.items():
        secs = [x[0] for x in runs]
        st = runs[int(np.argsort(secs)[len(secs) // 2])][1].stats
        if not all(x[1].iterations == 5 for x in runs):
            raise RuntimeError(f"{which} timing solves did not take 5 "
                               "iterations")
        say("11 cbet-timing", f"{which}: kernel_cell solve median "
            f"{statistics.median(secs):.6f} s of "
            f"{[round(x, 6) for x in secs]} (seeded {st['seeded_zero_gain']})"
            f"; median solve's iterations: gain "
            f"{[round(x, 6) for x in st['iter_gain_seconds']]} trace "
            f"{[round(x, 6) for x in st['iter_trace_seconds']]} update "
            f"{[round(x, 6) for x in st['iter_update_seconds']]} s; "
            f"card {smi}")

    # 12. K4 tri and gain-only against their plain versions
    rows12, kern12 = optin_kernels_vs_plain(cfg, ctx, dev)
    for line in rows12:
        say("12 k4-optins", line)

    # 13. the CBET opt-ins at OMEGA
    rows13, n13 = cbet_optins(cfg, dev, smi, zero_counts, read_counts, {
        "kernel_cell": k32, "uncoupled_kc": kc.edep, "lookup": c32,
        "uncoupled_lookup": look.edep})
    for line in rows13:
        say("13 cbet-optins", line)

    # 14. the on-card init against the host prepare
    for line in device_init(dev):
        say("14 device-init", line)

    # 15. the JAX CLI's default trace: on-card init, compacted trace
    base = mem_mark()
    rows15, n15, seg15 = compacted_trace(cfg, dev, drift, zero_counts,
                                         read_counts, smi)
    rows15.append(peak_line(cfg.replace(dtype="float64"), False, base)
                  + " (f32 and f64 runs, the f64 estimate)")
    for line in rows15:
        say("15 compacted-trace", line)

    # 16. the JAX bench's CBET: compacted kernel_cell (and lookup)
    base = mem_mark()
    rows16, n16 = compacted_cbet(cfg, dev, {
        "kernel_cell": k32, "lookup": c32, "kernel_cell_f64": k64},
        n13["drift"], zero_counts, read_counts, smi)
    rows16.append(peak_line(cfg.replace(cbet_gain_mode="kernel_cell"), True,
                            base, hold=False)
                  + " (f32 and f64 solves with three cached solvers, beside "
                  "the estimate of one f32 solve)")
    for line in rows16:
        say("16 compacted-cbet", line)

    # 17. K6, the tensor-core probe, and its entry point
    rows17, kern17, n17 = mma_probe_phase(dev, zero_counts, read_counts, smi)
    for line in rows17:
        say("17 mma-probe", line)

    # 18. the resumable trace; 19. the composed CBET solve
    rows18, full18 = resumable_trace(cfg, dev, drift, seg15, zero_counts,
                                     read_counts, smi)
    for line in rows18:
        say("18 resumable-trace", line)
    for line in composed_cbet(cfg, dev, full18.ctx, c32, n13["drift"],
                              zero_counts, read_counts, smi):
        say("19 composed-cbet", line)

    src = f"{PKG}/csrc"
    kernels = [
        {"name": "deposit", "route": "cuda", "source": f"{src}/deposit.cu",
         "replaces": "cbet_raytracing_3d_tpu/ops/pallas_deposit.py:527",
         "launches": launches, **kern},
        {"name": "deposit_grouped", "route": "cuda",
         "source": f"{src}/deposit.cu",
         "replaces": "cbet_raytracing_3d_tpu/ops/pallas_deposit.py:527",
         "launches": n9["K2"], **kern8["K2"]},
        {"name": "deposit_grouped (one synthetic step)", "route": "cuda",
         "source": f"{src}/deposit.cu",
         "replaces": "cbet_raytracing_3d_tpu/ops/pallas_deposit.py:527",
         "launches": n9["K2"], **kern8["K2 step"]},
        {"name": "gain", "route": "cuda", "source": f"{src}/gain.cu",
         "replaces": "cbet_raytracing_3d_tpu/ops/pallas_gain.py:58",
         "launches": n9["K3"], **kern8["K3"]},
        {"name": "deposit_gain_window", "route": "cuda",
         "source": f"{src}/gain_deposit.cu",
         "replaces": "cbet_raytracing_3d_tpu/ops/pallas_deposit.py:687",
         "launches": n10["K4"], **kern8["K4"]},
        {"name": "deposit_gain_window_tri", "route": "cuda",
         "source": f"{src}/gain_deposit.cu",
         "replaces": "cbet_raytracing_3d_tpu/ops/pallas_deposit.py:687",
         "launches": n13["tri"], **kern12["tri"]},
        {"name": "deposit_gain_window_gain_only", "route": "cuda",
         "source": f"{src}/gain_deposit.cu",
         "replaces": "cbet_raytracing_3d_tpu/ops/pallas_deposit.py:687",
         "launches": n13["gain_only"], **kern12["cell gain-only"]},
        {"name": "mma_probe", "route": "cuda", "source": f"{src}/mma_probe.cu",
         "replaces": "scripts/bench_mxu_shapes.py:21", "launches": n17,
         **kern17},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def deposit_window_vs_plain(cfg, ctx, dev):
    """Phase 3, the main path's window: K1 on the 5-step window that
    ``raytracer.make_trace_fn`` builds 150 steps into the OMEGA trace
    (``scripts.box_sweep.trace_window``), against its plain version and
    against five direct one-step launches, f32 and f64; timed in turns.
    Returns (report lines, {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms, per_step_ms, direct_ms, box_share} of the f32 case)."""
    import torch
    from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
    from cbet_raytracing_3d_tpu_torch.ops import deposit as dep
    from cbet_raytracing_3d_tpu_torch.scripts.box_sweep import trace_window
    from cbet_raytracing_3d_tpu_torch.utils import cuda_build

    lines, kern = [], {}
    default_nodes = cuda_build.load().cbet_box_default_nodes()
    for dt in (torch.float32, torch.float64):
        c = cfg.replace(dtype=str(dt)[6:])
        cx = ctx if dt == torch.float32 else rt.prepare(c)
        *flat, n = trace_window(c, cx, dev, 3 * c.nt // 8, dt)
        batch = flat[0].shape[0] // n
        steps = [tuple(a[j * n:(j + 1) * n] for a in flat)
                 for j in range(batch)]

        def zeros(dtype=dt):
            return torch.zeros(c.edep_shape, dtype=dtype, device=dev)

        def per_step(grid):
            of = 0
            for rows in steps:
                of = of + dep._launch(grid, *rows)
            return of
        before = dep.LAUNCHES
        got, of_k = dep.deposit(zeros(), *flat, n)
        counted = dep.LAUNCHES - before
        want, of_p = dep.deposit_reference(zeros(), *flat, n)
        stepped = zeros()
        of_s = per_step(stepped)
        tally = torch.zeros(2, dtype=torch.int32, device=dev)
        boxed = zeros()
        dep._launch(boxed, *flat, n, box_nodes=default_nodes, tally=tally)
        default = box_share(lambda t: dep._launch(zeros(), *flat, n, tally=t),
                            dev)
        torch.cuda.synchronize()
        g64, w64, s64 = (a.double().cpu().numpy()
                         for a in (got, want, stepped))
        err, err_s = rel_l2(g64, w64), rel_l2(g64, s64)
        max_abs = float(np.abs(g64 - w64).max())
        tot = abs(g64.sum() - w64.sum()) / abs(w64.sum())
        f32 = dt == torch.float32
        tol = 1e-5 if f32 else 1e-12
        live = int((flat[6] != 0).sum())
        blocks = tuple(int(x) for x in tally.cpu())
        ok = (err < tol and err_s < tol and tot < tol and counted == 1
              and int(of_k) == int(of_p) == int(of_s) == 0
              and np.isfinite(g64).all() and live > 0
              and rel_l2(boxed.double().cpu(), w64) < tol
              # the default: f32 through the box, f64 on the direct path
              and default == (blocks if f32 else (blocks[0], 0))
              and 0 < blocks[1] <= blocks[0])
        if not ok:
            raise RuntimeError(
                f"K1 window vs plain failed ({dt}): rel-L2 {err} (vs five "
                f"launches {err_s}), total rel {tot}, overflow {int(of_k)}/"
                f"{int(of_p)}/{int(of_s)}, blocks {blocks}, default "
                f"{default}, launches counted {counted}")
        line = (f"K1 window {str(dt)[6:]} {batch} x {n} rows ({live} live) "
                f"into {tuple(c.edep_shape)}: rel-L2 vs plain {err:.3e} vs "
                f"five one-step launches {err_s:.3e} total-rel {tot:.3e} "
                f"max-abs {max_abs:.6e} (< {tol:g}); overflow 0")
        if f32:
            # a chunk's five windows into one f32 grid, against the float64
            # sum of the same rows: what each grouping of the adds loses
            exact, _ = dep.deposit_reference(
                zeros(torch.float64), *flat[:3],
                *(a.double() for a in flat[3:]), n)
            exact = (5 * exact).cpu().numpy()
            grid_b, grid_s = zeros(), zeros()
            for _ in range(5):
                dep._launch(grid_b, *flat, n)
                per_step(grid_s)
            loss_b = rel_l2(grid_b.double().cpu(), exact)
            loss_s = rel_l2(grid_s.double().cpu(), exact)
            kb = bound(deposit_bytes(flat[6]) + 8 * touched(want),
                       DEPOSIT_OPS * live, PEAK_F32)
            grid = zeros()
            ms = in_turns({"box": lambda: dep.deposit(grid, *flat, n),
                           "steps": lambda: per_step(grid)}, 20)
            ms_d = in_turns({"box": lambda: dep.deposit(grid, *flat, n),
                             "direct": lambda: dep._launch(
                                 grid, *flat, n, box_nodes=0)}, 20)
            ms_p = cuda_ms(lambda: dep.deposit_reference(grid, *flat, n), 5)
            ms_box = (ms["box"] + ms_d["box"]) / 2
            kern = {"max_abs_err": max_abs, "ms": ms_box, "plain_ms": ms_p,
                    **kb, "library_ms": None, "per_step_ms": ms["steps"],
                    "direct_ms": ms_d["direct"],
                    "box_share": blocks[1] / blocks[0]}
            line += (f"; five windows into one f32 grid vs their float64 sum:"
                     f" box {loss_b:.3e}, one-step launches {loss_s:.3e}; box"
                     f" {ms['box']:.4f} / {ms_d['box']:.4f} ms, five one-step"
                     f" launches {ms['steps']:.4f} ms, direct kernel over "
                     f"the window {ms_d['direct']:.4f} ms (in turns), plain "
                     f"{ms_p:.4f} ms per window; bound {kb['bound_ms']:.4f} "
                     f"ms ({kb['bound_by']}); blocks in the box {blocks[1]} "
                     f"of {blocks[0]}")
            del exact, grid_b, grid_s, grid
        else:
            direct = zeros()
            dep._launch(direct, *flat, n, box_nodes=0)
            d64 = direct.double().cpu().numpy()
            nz = w64 != 0
            b64 = boxed.double().cpu().numpy()
            node = float((np.abs(b64 - d64)[nz] / np.abs(w64[nz])).max())
            line += (f"; by default on the window kernel's direct path (0 of "
                     f"{default[0]} blocks in the box); through the box "
                     f"({blocks[1]} of {blocks[0]} blocks): rel-L2 vs plain "
                     f"{rel_l2(b64, w64):.3e}, largest per-node relative "
                     f"difference from the direct kernel {node:.3e}")
            del direct
        lines.append(line)
        del flat, steps, got, want, stepped, boxed
    return lines, kern


def cbet_kernels_vs_plain(cfg, ctx, dev, rng):
    """Phase 8: K2, K3 and K4 against their plain versions on the card at
    the OMEGA CBET path's shapes: K2 on one synthetic step and on the main
    path's window, K3's pair kernel (also against its all-pairs kernel, bit
    for bit, both timed in turns) and its b_out form, K4 "cell" on that
    window; K2 and K4 timed with the tile
    box (the kernels' default) and on the direct path (capacity 0) in
    turns, with the share of blocks that took the box.  Returns (report
    lines, per-kernel {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms, direct_ms, box_share} of the float32 cases)."""
    import torch
    from cbet_raytracing_3d_tpu_torch.models import cbet
    from cbet_raytracing_3d_tpu_torch.ops import deposit as dep
    from cbet_raytracing_3d_tpu_torch.ops import gain as gop
    from cbet_raytracing_3d_tpu_torch.ops import gain_deposit as gdep
    from cbet_raytracing_3d_tpu_torch.utils import cuda_build

    lines, kern = [], {}

    def compare(got, want):
        g64 = np.asarray(got.double().cpu().numpy(), np.float64)
        w64 = np.asarray(want.double().cpu().numpy(), np.float64)
        return (rel_l2(g64, w64), float(np.abs(g64 - w64).max()),
                bool(np.isfinite(g64).all()))

    # K2, one synthetic step of the CBET layout's rows into 60 beam grids:
    # boundary exits, dead rows, tiles scattered over the grid (the blocks
    # whose box does not fit take the direct path)
    _, rpg = cbet_layout(cfg, ctx, "cpu")
    n = rpg * cfg.nbeams
    gshape = (cfg.nbeams,) + cfg.edep_shape
    rows = deposit_rows(rng, (cfg.nx, cfg.ny, cfg.nz), n)
    for dt in (torch.float32, torch.float64):
        args = to_device(*rows, dt, dev)
        before = dep.GROUPED_LAUNCHES
        got, of_k = dep.deposit_grouped(
            torch.zeros(gshape, dtype=dt, device=dev), *args, rpg)
        want, of_p = dep.deposit_grouped_reference(
            torch.zeros(gshape, dtype=dt, device=dev), *args, rpg)
        err, mx, fin = compare(got, want)
        tol = 1e-5 if dt == torch.float32 else 1e-12
        if not (err < tol and fin and int(of_k) == int(of_p) == 0
                and dep.GROUPED_LAUNCHES == before + 1):
            raise RuntimeError(f"K2 vs plain failed ({dt}): rel-L2 {err}, "
                               f"overflow {int(of_k)}/{int(of_p)}")
        try:
            dep.deposit_grouped(got, *args, rpg - 1)
        except ValueError:
            pass
        else:
            raise RuntimeError("K2 took more rays than its groups hold")
        line = (f"K2 grouped deposit, one synthetic step, {dt} {n} rows into "
                f"{gshape}: rel-L2 {err:.3e} max-abs {mx:.6e} (< {tol:g}); "
                "over-count refused")
        if dt == torch.float32:
            kb = bound(deposit_bytes(args[6]) + 8 * touched(want),
                       DEPOSIT_OPS * int((args[6] != 0).sum()), PEAK_F32)
            blocks = box_share(lambda t: dep._launch_grouped(
                got, *args, rpg, tally=t), dev)
            ms = in_turns({
                "box": lambda: dep.deposit_grouped(got, *args, rpg),
                "direct": lambda: dep._launch_grouped(got, *args, rpg,
                                                      box_nodes=0)}, 20)
            ms_p = cuda_ms(
                lambda: dep.deposit_grouped_reference(want, *args, rpg), 5)
            kern["K2 step"] = {"max_abs_err": mx, "ms": ms["box"],
                               "plain_ms": ms_p, **kb, "library_ms": None,
                               "direct_ms": ms["direct"],
                               "box_share": blocks[1] / max(1, blocks[0])}
            line += (f"; box {ms['box']:.4f} ms direct {ms['direct']:.4f} ms"
                     f" (in turns) plain {ms_p:.4f} ms per call, bound "
                     f"{kb['bound_ms']:.4f} ms ({kb['bound_by']}); blocks in "
                     f"the box {blocks[1]} of {blocks[0]}")
        lines.append(line)
        del args, got, want

    # K3: 60 beams x 100^3 nodes through the pair kernel (the solver's
    # couplings are antisymmetric), bit for bit the all-pairs kernel; and
    # the b_out form (8 output rows) on the all-pairs kernel
    pu, rp, inten = gain_case(rng, cfg, ctx, dev)
    lib = cuda_build.load()
    for bo in (cfg.nbeams, 8):
        full = bo == cfg.nbeams
        pu_b = pu[:bo].contiguous()
        before = (gop.LAUNCHES, gop.PAIR_LAUNCHES)
        got = gop.gain(pu_b, rp, inten)
        counted = (gop.LAUNCHES - before[0], gop.PAIR_LAUNCHES - before[1])
        want = gop.gain_reference(pu_b, rp, inten)
        err, mx, fin = compare(got, want)
        if not (err < 1e-5 and fin and counted == (1, int(full))
                and gop.pairs_antisymmetric(pu_b) == full
                and float(want.abs().max()) > 0):
            raise RuntimeError(f"K3 vs plain failed (Bo={bo}): rel-L2 {err}, "
                               f"launches (all, pair kernel) {counted}")
        B, P = inten.shape
        line = (f"K3 gain Bo={bo} B={B} P={P}, the "
                f"{'pair' if full else 'all-pairs'} kernel: rel-L2 {err:.3e} "
                f"max-abs {mx:.6e} (< 1e-5; the whole difference is the "
                "kernels' FMA contraction)")
        # pair_u, rhat_pre and I read once, G written once
        nbytes = 4 * (pu_b.numel() + rp.numel() + (B + bo) * P)
        if full:
            every = gop._launch(lib, pu, rp, inten, False)
            same = bool(torch.equal(got, every))
            plain_pairs = gop.gain_pairs_reference(pu, rp, inten)
            err_pp = compare(got, plain_pairs)[0]
            if not (same and err_pp < 1e-5):
                raise RuntimeError(
                    f"K3 pair kernel vs all-pairs kernel: "
                    f"{int((got != every).sum())} values differ, max "
                    f"{float((got - every).abs().max())}; vs its plain "
                    f"version {err_pp}")
            # per pair a < b and node: eta 5, the resonance 7 with the
            # division as one, and a product and a sum for each of the two
            # beams (4): 16 float32 operations; then G = sum * pre
            kb = bound(nbytes, (16 * (B * (B - 1) // 2) + B) * P, PEAK_F32)
            # every (b, b'): eta 5, the resonance 7, the product and sum 2
            kb_all = bound(nbytes, 14 * B * B * P, PEAK_F32)
            ms = in_turns({
                "pairs": lambda: gop.gain(pu, rp, inten),
                "all": lambda: gop._launch(lib, pu, rp, inten, False)}, 10)
            ms_p = cuda_ms(lambda: gop.gain_reference(pu, rp, inten), 3)
            ms_pp = cuda_ms(lambda: gop.gain_pairs_reference(pu, rp, inten),
                            1)
            kern["K3"] = {"max_abs_err": mx, "ms": ms["pairs"],
                          "plain_ms": ms_pp, **kb, "library_ms": None,
                          "all_pairs_ms": ms["all"],
                          "all_pairs_bound_ms": kb_all["bound_ms"],
                          "all_pairs_plain_ms": ms_p}
            line += (f"; equal to the all-pairs kernel bit for bit (it takes "
                     f"up to {lib.cbet_gain_pairs_max_beams()} beams); vs its "
                     f"own plain version {err_pp:.3e}; pair kernel "
                     f"{ms['pairs']:.4f} ms, all-pairs kernel "
                     f"{ms['all']:.4f} ms (in turns), plain pairs "
                     f"{ms_pp:.4f} ms, plain all-pairs {ms_p:.4f} ms per "
                     f"call; bound {kb['bound_ms']:.4f} ms "
                     f"({kb['bound_by']}; every (b, b'): "
                     f"{kb_all['bound_ms']:.4f} ms)")
            del every, plain_pairs
        else:
            kb = bound(nbytes, 14 * bo * B * P, PEAK_F32)
            ms = cuda_ms(lambda: gop.gain(pu_b, rp, inten), 10)
            kern["K3"]["b_out_ms"] = ms
            line += (f"; {ms:.4f} ms per call, bound {kb['bound_ms']:.4f} ms"
                     f" ({kb['bound_by']})")
        lines.append(line)
        del got, want
    del pu, rp, inten

    # K4 "cell" and K2 on the main path's window: an OMEGA window 150 steps
    # in (3/8 of nt; the last rays die near step 250), smooth gain of both
    # signs; K2 deposits that window's contributions contrib0 * gamma
    for dt in (torch.float32, torch.float64):
        gain = smooth_gain(np.random.default_rng(SEED + 4), cfg, 40.0, dt,
                           dev)
        w = {}
        st, args = window_case(cfg, ctx, dev, dt, 3 * cfg.nt // 8, gain, w)
        before = gdep.LAUNCHES
        e_k, of_k, gam_k, u_k = gdep.deposit_gain_window(
            torch.zeros(cfg.edep_shape, dtype=dt, device=dev), *args)
        e_p, of_p, gam_p, u_p = gdep.deposit_gain_window_reference(
            torch.zeros(cfg.edep_shape, dtype=dt, device=dev), *args)
        thr = cfg.stop_fraction * st.uray_init
        alive_k = st.alive & (u_k > thr)
        alive_p = st.alive & (u_p > thr)
        live = args[7] != 0                       # ds: alive at step entry
        mid = int((live[0] & (gam_p[0] > 0) & (gam_p[-1] == 0)).sum())
        errs = [compare(a, b) for a, b in ((e_k, e_p), (gam_k, gam_p),
                                           (u_k, u_p))]
        tol = 1e-5 if dt == torch.float32 else 1e-12
        if not (all(e < tol and f for e, _, f in errs)
                and bool(torch.equal(alive_k, alive_p)) and mid > 0
                and int(of_k) == int(of_p) == 0
                and gdep.LAUNCHES == before + 1):
            raise RuntimeError(f"K4 vs plain failed ({dt}): {errs}, "
                               f"mid-window deaths {mid}")
        line = (f"K4 window-gain deposit {dt} 5 x {st.n} rows: rel-L2 edep "
                f"{errs[0][0]:.3e} gamma {errs[1][0]:.3e} uout "
                f"{errs[2][0]:.3e} (< {tol:g}); alive identical; "
                f"{mid} rays die mid-window")
        k2a = k2_window_args(w, gam_p, args[14])
        g2shape = (cfg.nbeams,) + cfg.edep_shape
        before2 = dep.GROUPED_LAUNCHES
        i_k, of2_k = dep.deposit_grouped(
            torch.zeros(g2shape, dtype=dt, device=dev), *k2a)
        i_p, of2_p = dep.deposit_grouped_reference(
            torch.zeros(g2shape, dtype=dt, device=dev), *k2a)
        err2, mx2, fin2 = compare(i_k, i_p)
        if not (err2 < tol and fin2 and int(of2_k) == int(of2_p) == 0
                and dep.GROUPED_LAUNCHES == before2 + 1):
            raise RuntimeError(f"K2 on the window vs plain failed ({dt}): "
                               f"rel-L2 {err2}, overflow "
                               f"{int(of2_k)}/{int(of2_p)}")
        n2 = k2a[0].shape[0]
        line2 = (f"K2 grouped deposit on the main path's window {dt} "
                 f"{n2 // st.n} x {st.n} rows into {g2shape}: rel-L2 "
                 f"{err2:.3e} max-abs {mx2:.6e} (< {tol:g}); overflow 0")
        if dt == torch.float32:
            kb = k4_bound(cfg, args, gam_p, e_p, tri=False, gain_only=False)
            grid = torch.zeros(cfg.edep_shape, dtype=dt, device=dev)
            streams, lags = args[:9], args[10:13]
            rest = (args[13], args[14], args[15], args[16])

            def k4_direct(tally=None, box_nodes=0):
                return gdep._launch(grid, streams, args[9], lags, rest[0],
                                    *rest[1:], False, box_nodes=box_nodes,
                                    tally=tally)
            blocks = box_share(lambda t: k4_direct(t, dep.BOX_DEFAULT), dev)
            ms = in_turns({
                "box": lambda: gdep.deposit_gain_window(grid, *args),
                "direct": k4_direct}, 20)
            ms_p = cuda_ms(
                lambda: gdep.deposit_gain_window_reference(grid, *args), 5)
            kern["K4"] = {"max_abs_err": max(e[1] for e in errs),
                          "ms": ms["box"], "plain_ms": ms_p, **kb,
                          "library_ms": None, "direct_ms": ms["direct"],
                          "box_share": blocks[1] / max(1, blocks[0])}
            line += (f"; box {ms['box']:.4f} ms direct {ms['direct']:.4f} ms"
                     f" (in turns) plain {ms_p:.4f} ms per call, bound "
                     f"{kb['bound_ms']:.4f} ms ({kb['bound_by']}); blocks in "
                     f"the box {blocks[1]} of {blocks[0]}")
            # K2's bound at the window shape: each row's contribution, the
            # cells and fracs of the rows that deposit, the nodes written
            kb2 = bound(deposit_bytes(k2a[6]) + 8 * touched(i_p),
                        DEPOSIT_OPS * int((k2a[6] != 0).sum()), PEAK_F32)
            ib = torch.zeros(g2shape, dtype=dt, device=dev)
            blocks2 = box_share(lambda t: dep._launch_grouped(
                ib, *k2a, tally=t), dev)
            ms2 = in_turns({
                "box": lambda: dep.deposit_grouped(ib, *k2a),
                "direct": lambda: dep._launch_grouped(ib, *k2a,
                                                      box_nodes=0)}, 20)
            ms2_p = cuda_ms(lambda: dep.deposit_grouped_reference(ib, *k2a),
                            5)
            kern["K2"] = {"max_abs_err": mx2, "ms": ms2["box"],
                          "plain_ms": ms2_p, **kb2, "library_ms": None,
                          "direct_ms": ms2["direct"],
                          "box_share": blocks2[1] / max(1, blocks2[0])}
            line2 += (f"; box {ms2['box']:.4f} ms direct "
                      f"{ms2['direct']:.4f} ms (in turns) plain "
                      f"{ms2_p:.4f} ms per call, bound "
                      f"{kb2['bound_ms']:.4f} ms ({kb2['bound_by']}); "
                      f"blocks in the box {blocks2[1]} of {blocks2[0]}")
            del grid, ib
        lines += [line, line2]
        del gain, args, st, w, k2a, i_k, i_p
    return lines, kern



def optin_kernels_vs_plain(cfg, ctx, dev):
    """Phase 12: K4 "tri" and K4 gain-only ("tri" and "cell") against their
    plain versions on phase 8's OMEGA window, f32 and f64.  Returns (report
    lines, per-variant {max_abs_err, ms, plain_ms} of the float32 cases)."""
    import torch
    from cbet_raytracing_3d_tpu_torch.ops import deposit as dep
    from cbet_raytracing_3d_tpu_torch.ops import gain_deposit as gdep

    lines, kern = [], {}
    counter = {"tri": "TRI_LAUNCHES", "tri gain-only": "GAIN_ONLY_LAUNCHES",
               "cell gain-only": "GAIN_ONLY_LAUNCHES"}
    for dt in (torch.float32, torch.float64):
        gain = smooth_gain(np.random.default_rng(SEED + 4), cfg, 40.0, dt,
                           dev)
        st, args = window_case(cfg, ctx, dev, dt, 3 * cfg.nt // 8, gain)
        tri_args = args[:10] + args[13:]         # no entry (lag) cells
        thr = cfg.stop_fraction * st.uray_init
        live = args[7] != 0                       # ds: alive at step entry
        cases = (
            ("tri", gdep.deposit_gain_window_tri,
             gdep.deposit_gain_window_tri_reference, tri_args, False),
            ("tri gain-only", gdep.deposit_gain_window_tri,
             gdep.deposit_gain_window_tri_reference, tri_args, True),
            ("cell gain-only", gdep.deposit_gain_window,
             gdep.deposit_gain_window_reference, args, True))
        tol = 1e-5 if dt == torch.float32 else 1e-12
        for name, fn, ref, a, gain_only in cases:
            # gain-only must leave a grid that already holds values alone
            e0 = (torch.full(cfg.edep_shape, 0.5, dtype=dt, device=dev)
                  if gain_only else
                  torch.zeros(cfg.edep_shape, dtype=dt, device=dev))
            before = getattr(gdep, counter[name])
            e_k, of_k, g_k, u_k = fn(e0.clone(), *a, gain_only=gain_only)
            after = getattr(gdep, counter[name])
            e_p, of_p, g_p, u_p = ref(e0.clone(), *a, gain_only=gain_only)
            torch.cuda.synchronize()
            pairs = ((g_k, g_p), (u_k, u_p)) + (
                () if gain_only else ((e_k, e_p),))
            errs = [(rel_l2(x.double().cpu(), y.double().cpu()),
                     float((x.double() - y.double()).abs().max()),
                     bool(torch.isfinite(x).all())) for x, y in pairs]
            mid = int((live[0] & (g_p[0] > 0) & (g_p[-1] == 0)).sum())
            ok = (all(e < tol and f for e, _, f in errs)
                  and bool(torch.equal(st.alive & (u_k > thr),
                                       st.alive & (u_p > thr)))
                  and mid > 0 and int(of_k) == int(of_p) == 0
                  and after == before + 1)
            if gain_only:
                ok = ok and bool(torch.equal(e_k, e0)
                                 and torch.equal(e_p, e0))
            if not ok:
                raise RuntimeError(f"K4 {name} vs plain failed ({dt}): "
                                   f"{errs}, mid-window deaths {mid}, "
                                   f"overflow {int(of_k)}/{int(of_p)}, "
                                   f"launches {after - before}")
            line = (f"K4 {name} {dt} {a[0].shape[0]} x {st.n} rows: rel-L2 gamma "
                    f"{errs[0][0]:.3e} uout {errs[1][0]:.3e}"
                    + ("; edep bit-untouched" if gain_only else
                       f" edep {errs[2][0]:.3e}")
                    + f" (< {tol:g}); alive identical; {mid} rays die "
                    "mid-window; overflow 0")
            if dt == torch.float32:
                kb = k4_bound(cfg, a, g_p, e_p - e0, tri=name.startswith(
                    "tri"), gain_only=gain_only)
                grid = e0.clone()
                ms_p = cuda_ms(lambda: ref(grid, *a, gain_only=gain_only), 5)
                kern[name] = {"max_abs_err": max(e[1] for e in errs),
                              "plain_ms": ms_p, **kb, "library_ms": None}
                if name == "tri":
                    def tri_direct(tally=None, box_nodes=0):
                        return gdep._launch(grid, a[:9], a[9], (), *a[10:],
                                            False, box_nodes=box_nodes,
                                            tally=tally)
                    blocks = box_share(
                        lambda t: tri_direct(t, dep.BOX_DEFAULT), dev)
                    ms = in_turns({"box": lambda: fn(grid, *a),
                                   "direct": tri_direct}, 20)
                    kern[name].update(
                        ms=ms["box"], direct_ms=ms["direct"],
                        box_share=blocks[1] / max(1, blocks[0]))
                    line += (f"; box {ms['box']:.4f} ms direct "
                             f"{ms['direct']:.4f} ms (in turns) plain "
                             f"{ms_p:.4f} ms per call; blocks in the box "
                             f"{blocks[1]} of {blocks[0]}")
                else:
                    kern[name]["ms"] = cuda_ms(
                        lambda: fn(grid, *a, gain_only=gain_only), 20)
                    line += (f"; kernel {kern[name]['ms']:.4f} ms plain "
                             f"{ms_p:.4f} ms per call")
            lines.append(line)
        del gain, args, tri_args, st
    return lines, kern


def cbet_optins(cfg, dev, smi, zero_counts, read_counts, ref):
    """Phase 13: the OMEGA CBET opt-ins in f32 against the solves of phases
    9 and 10 (``ref``: the kernel_cell and lookup ``CbetResult``s and their
    runs' uncoupled edep).  Returns (report lines, the main-path launches of
    K4 "tri" and K4 gain-only)."""
    import torch
    from cbet_raytracing_3d_tpu_torch.models import cbet
    from cbet_raytracing_3d_tpu_torch.models import raytracer as rt

    ctx = rt.prepare(cfg)
    batch = cfg.deposit_batch_steps
    lines, checks = [], {}

    def solve(c, warm=True):
        """One seeded solve (after a 1-iteration warm-up that builds the
        solver and its zero-gain seed): (result, seconds, launches)."""
        if warm:
            cbet.cbet_solve(c.replace(cbet_max_iters=1), ctx, dev)
        zero_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = cbet.cbet_solve(c, ctx, dev)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t, read_counts()

    def norm(a):
        return float(np.linalg.norm(np.asarray(a, np.float64)))

    def windows(r, traces=slice(None)):
        return sum(r.stats["trace_steps"][traces]) // batch

    def hist(r):
        return [f"{h:.5f}" for h in r.history]

    # (a) the trilinear window model (K4 "tri")
    kc_ref = ref["kernel_cell"]
    effect = norm(kc_ref.edep - ref["uncoupled_kc"])
    ra, sa, na = solve(cfg.replace(cbet_gain_mode="kernel"))
    share_a = norm(ra.edep - kc_ref.edep) / effect
    checks.update({
        "(a) tri converges, finite": ra.converged and bool(
            np.isfinite(ra.edep).all() and np.isfinite(ra.intensity).all()),
        "(a) tri deviation < the CBET effect": share_a < 1.0,
        "(a) K4 tri launches == windows > 0":
            na["K4 tri"] == windows(ra) == na["K2"] > 0,
        "(a) no K4 cell, no gain-only, no K1":
            na["K4"] == na["K4 gain-only"] == na["K1"] == 0,
        "(a) K3 through the pair kernel":
            na["K3"] == na["K3 pairs"] == ra.iterations,
    })
    lines.append(
        f"(a) kernel (tri): {ra.iterations} iterations, history {hist(ra)}; "
        f"vs the kernel_cell solve {norm(ra.edep - kc_ref.edep) / norm(kc_ref.edep):.3e} "
        f"rel-L2 = {share_a:.4f} of the CBET effect (effect "
        f"{effect / norm(ref['uncoupled_kc']):.4e} rel-L2; bar < 1); "
        f"edep_total {ra.edep.sum():.17g}; seeded solve {sa:.6f} s; "
        f"launches {na}")

    # (b) light iterations: kernel_cell (two solves each against full, in
    # turns), then lookup
    c_kc = cfg.replace(cbet_gain_mode="kernel_cell")
    for light in (True, False):
        cbet.cbet_solve(c_kc.replace(cbet_max_iters=1,
                                     cbet_light_iterations=light), ctx, dev)
    runs = {"full": [], "light": []}
    for which in ("full", "light", "light", "full"):
        runs[which].append(solve(c_kc.replace(
            cbet_light_iterations=which == "light"), warm=False))
    full, light = runs["full"][-1][0], runs["light"][-1][0]
    nb_ = runs["light"][-1][2]
    # the card's own drift between two identical solves sets the bars
    drift = max(rel_l2(runs["full"][0][0].edep, full.edep),
                rel_l2(runs["full"][0][0].intensity, full.intensity))
    bar_b = max(1e-6, 3 * drift)
    med = {k: statistics.median(x[1] for x in v) for k, v in runs.items()}
    hrel = max(abs(a / b - 1) for a, b in zip(light.history, full.history))
    checks.update({
        "(b) kernel_cell light: same iterations":
            light.iterations == full.iterations
            and light.stats["light_iterations"],
        "(b) kernel_cell light: history within 1e-4": hrel < 1e-4,
        f"(b) kernel_cell light: edep, intensity within {bar_b:.1e}":
            rel_l2(light.edep, full.edep) < bar_b
            and rel_l2(light.intensity, full.intensity) < bar_b,
        "(b) gain-only launches == light windows, K4 == the final trace's":
            nb_["K4 gain-only"] == windows(light, slice(0, -1)) > 0
            and nb_["K4"] == windows(light, slice(-1, None)) > 0,
    })
    lines.append(
        f"(b) kernel_cell light vs full: {light.iterations}/"
        f"{full.iterations} iterations, history max rel {hrel:.3e}; edep "
        f"{rel_l2(light.edep, full.edep):.3e} intensity "
        f"{rel_l2(light.intensity, full.intensity):.3e} (full vs full "
        f"{drift:.3e}; bar {bar_b:.1e}); seeded solve median light "
        f"{med['light']:.6f} s of "
        f"{[round(x[1], 6) for x in runs['light']]}, full "
        f"{med['full']:.6f} s of {[round(x[1], 6) for x in runs['full']]};"
        f" final full trace {light.stats['final_trace_seconds']:.6f} s, "
        f"light iterations' trace "
        f"{[round(x, 6) for x in light.stats['iter_trace_seconds']]} s vs "
        f"full {[round(x, 6) for x in full.stats['iter_trace_seconds']]} "
        f"s; launches {nb_}; card {smi}")
    lk_ref = ref["lookup"]
    rl, sl, nl = solve(cfg.replace(cbet_light_iterations=True))
    hrel_l = max(abs(a / b - 1) for a, b in zip(rl.history, lk_ref.history))
    checks.update({
        "(b) lookup light: same iterations, history within 1e-4":
            rl.iterations == lk_ref.iterations and hrel_l < 1e-4,
        f"(b) lookup light: edep, intensity within {bar_b:.1e}":
            rel_l2(rl.edep, lk_ref.edep) < bar_b
            and rel_l2(rl.intensity, lk_ref.intensity) < bar_b,
        "(b) lookup light: K1 only in the final trace, K2 every window":
            nl["K1"] == windows(rl, slice(-1, None)) > 0
            and nl["K2"] == windows(rl) and nl["K4 gain-only"] == 0,
    })
    lines.append(
        f"(b) lookup light vs the phase-9 solve: {rl.iterations} iterations,"
        f" history max rel {hrel_l:.3e}; edep "
        f"{rel_l2(rl.edep, lk_ref.edep):.3e} intensity "
        f"{rel_l2(rl.intensity, lk_ref.intensity):.3e}; seeded solve "
        f"{sl:.6f} s; launches {nl}")

    # (c) Anderson(m=1) on the warm kernel_cell solver
    rc, sc, nc = solve(c_kc.replace(cbet_accel="anderson"), warm=False)
    h0 = abs(rc.history[0] / full.history[0] - 1)
    d_c = rel_l2(rc.edep, full.edep)
    checks.update({
        "(c) anderson converges in <= the plain iterations":
            rc.converged and rc.iterations <= full.iterations,
        "(c) anderson history[0] = plain's (within 1e-4)": h0 < 1e-4,
        # both stop at a relative intensity change < cbet_tol = 5e-3; the
        # plain solve's last change is ~2e-3, and solves stopped at that
        # truncation differ by ~1e-3 in edep (config.py: cbet_relax)
        "(c) anderson edep vs plain < 2e-3": d_c < 2e-3,
    })
    lines.append(
        f"(c) anderson: {rc.iterations} iterations (plain "
        f"{full.iterations}), history {hist(rc)} (plain {hist(full)}); "
        f"edep vs plain {d_c:.3e} intensity "
        f"{rel_l2(rc.intensity, full.intensity):.3e} (bar 2e-3); seeded "
        f"solve {sc:.6f} s; launches {nc}")

    # (d) the window-strided lookup
    effect_l = norm(lk_ref.edep - ref["uncoupled_lookup"])
    rd, sd, nd = solve(cfg.replace(cbet_gain_stride=batch))
    share_d = norm(rd.edep - lk_ref.edep) / effect_l
    checks.update({
        "(d) stride converges": rd.converged,
        "(d) stride deviation < 0.6 of the CBET effect": share_d < 0.6,
        "(d) K1, K2 launches == windows":
            nd["K1"] == nd["K2"] == windows(rd) > 0,
    })
    lines.append(
        f"(d) cbet_gain_stride={batch}: {rd.iterations} iterations, history"
        f" {hist(rd)}; vs stride 1: {share_d:.4f} of the CBET effect (bar "
        f"0.6); seeded solve {sd:.6f} s; launches {nd}")

    # (e) one lookup trace at zero gain: per-step deposits vs batched
    traces = {}
    for b in (1, batch):
        solver = cbet._get_solver(cfg.replace(deposit_batch_steps=b), ctx,
                                  dev, cbet.kernel_ops())
        traces["per-step" if b == 1 else "batched"] = (solver, [])
    for which in ("per-step", "batched", "batched", "per-step", "per-step",
                  "batched"):
        solver, secs = traces[which]
        gain = solver.make_zero_gain()
        torch.cuda.synchronize()
        t = time.perf_counter()
        solver.trace(gain)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    lines.append("(e) lookup trace at zero gain, median of 3: " + "; ".join(
        f"{k} {statistics.median(v):.6f} s of {[round(x, 6) for x in v]}"
        for k, (_, v) in traces.items()) + f"; card {smi}")
    if not all(checks.values()):
        raise RuntimeError("OMEGA CBET opt-ins failed: "
                           f"{[k for k, v in checks.items() if not v]}")
    return lines, {"tri": na["K4 tri"], "gain_only": nb_["K4 gain-only"],
                   "drift": drift}


def device_init(dev):
    """Phase 14: ``prepare_device`` on the card against the host
    ``prepare`` at OMEGA, float64 and float32, first and second call."""
    import torch
    from cbet_raytracing_3d_tpu_torch.config import Config
    from cbet_raytracing_3d_tpu_torch.models import raytracer as rt

    lines = []
    for dt in ("float64", "float32"):
        cfg = Config(dtype=dt)
        secs = {"host": [], "card": []}
        for _ in range(2):
            t = time.perf_counter()
            ctx_h = rt.prepare(cfg)
            secs["host"].append(time.perf_counter() - t)
            torch.cuda.synchronize()
            t = time.perf_counter()
            ctx_d = rt.prepare_device(cfg, device=dev)
            torch.cuda.synchronize()
            secs["card"].append(time.perf_counter() - t)
        rpt = ctx_h.layout.rays_per_tile
        ids, valid = rt.live_tile_ids(cfg, ctx_h.layout)
        state_h = rt.select_rays(ctx_h.state0, rt.tile_slots(ids[valid], rpt))
        sel = np.nonzero(np.repeat(valid, rpt))[0]
        state_d = rt.select_rays(ctx_d.state0, sel).to("cpu")
        m = state_h.alive
        cells = all(torch.equal(a[m], b[m]) for a, b in
                    zip(state_d.cell, state_h.cell))
        n_vals = n_diff = n_far = 0
        for name in ("frac", "vel", "kick"):
            for a, b in zip(getattr(state_d, name), getattr(state_h, name)):
                a, b = a[m], b[m]
                diff = a != b
                n_vals += a.numel()
                n_diff += int(diff.sum())
                # more than one ulp apart
                n_far += int((diff & (torch.nextafter(b, a) != a)).sum())
        ur = state_d.uray[m] != state_h.uray[m]
        n_vals += int(m.sum())
        n_diff += int(ur.sum())
        pads = np.array_equal(ctx_d.beam_id == -1, np.repeat(~valid, rpt))
        ok = (torch.equal(state_d.alive, m) and cells and pads
              and n_far == 0 and n_diff <= 1e-4 * n_vals
              and ctx_d.compact and ctx_d.state0.uray.is_cuda)
        line = (f"{dt}: {int(m.sum())} launched of {ctx_d.state0.n} slots; "
                f"masks and cells identical; float values differing "
                f"{n_diff} of {n_vals} (bar: <= 1e-4 of them, each by 1 "
                f"ulp), more than 1 ulp {n_far}; beam_id -1 exactly on "
                f"pads {pads}; seconds host prepare "
                f"{[round(x, 6) for x in secs['host']]}, card "
                f"{[round(x, 6) for x in secs['card']]} (first, second)")
        if not ok:
            raise RuntimeError(f"device init failed: {line}")
        lines.append(line)
    return lines


def compacted_trace(cfg, dev, drift, zero_counts, read_counts, smi):
    """Phase 15: ``runner.run(cfg, cache_dir=...)`` (the on-card init, the
    compacted trace) against ``runner.run(cfg)``, f64 and f32, then the
    two traces timed in turns.  Returns (lines, K1 launches)."""
    import torch
    from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
    from cbet_raytracing_3d_tpu_torch.runner import run

    cache = os.path.join(REPO, ".cbet_cache")
    had_cache = os.path.exists(cache)
    zero_counts()
    seg = run(cfg, device=dev, verbose=False, cache_dir=cache)
    n15 = read_counts()
    plain = run(cfg, device=dev, verbose=False)
    c64 = cfg.replace(dtype="float64")
    seg64 = run(c64, device=dev, verbose=False, cache_dir=cache)
    plain64 = run(c64, device=dev, verbose=False)
    st = seg.stats
    d32 = rel_l2(seg.edep, plain.edep)
    d64 = rel_l2(seg64.edep, plain64.edep)
    cons = abs(st["edep_total"] - st["energy_absorbed"]) / st["energy_absorbed"]
    keys = ("rays_launched", "rays_terminated", "rays_alive_at_end")
    checks = {
        "segmented, >= 2 compactions": st["segmented"]
        and not plain.stats["segmented"] and len(st["tile_widths"]) >= 3,
        "f64 edep vs plain <= 1e-12": d64 <= 1e-12,
        f"f32 edep vs plain <= 2 x phase 7's drift ({2 * drift:.2e})":
            d32 <= 2 * drift,
        "trace_stats counts identical": all(
            st[k] == plain.stats[k] and seg64.stats[k] == plain64.stats[k]
            for k in keys),
        "energy conserved (1e-5)": cons < 1e-5,
        "K1 launches == steps / 5 > 0":
            n15["K1"] * cfg.deposit_batch_steps == st["steps_executed"] > 0,
        "nothing written to the cache dir": had_cache or not os.path.exists(
            cache),
    }
    if not all(checks.values()):
        raise RuntimeError(f"compacted OMEGA trace failed: "
                           f"{[k for k, v in checks.items() if not v]}; "
                           f"rel-L2 f32 {d32} f64 {d64}; stats {st}")
    lines = [f"runner.run(cache_dir=...): tile widths {st['tile_widths']}; "
             f"vs the uncompacted run: f32 rel-L2 {d32:.3e} (bar "
             f"{2 * drift:.3e}), f64 {d64:.3e}; counts {[st[k] for k in keys]}"
             f" identical; absorbed-vs-deposited {cons:.3e}; steps "
             f"{st['steps_executed']}, K1 launches {n15['K1']}; phases "
             + " ".join(f"{k} {v:.6f} s" for k, v in seg.timings.items())]
    ctx = rt.prepare_device(cfg, device=dev)
    fns = {"plain": rt.make_trace_fn(cfg),
           "compacted": rt.make_trace_fn(cfg, compact=True)}
    times = {k: [] for k in fns}
    for which in ("plain", "compacted", "compacted", "plain", "plain",
                  "compacted"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fns[which](ctx.field4, ctx.state0)
        torch.cuda.synchronize()
        times[which].append(time.perf_counter() - t)
    lines.append("traces, median of 3 in turns: " + "; ".join(
        f"{k} {statistics.median(v):.6f} s of {[round(x, 6) for x in v]}"
        for k, v in times.items()) + f"; card {smi}")
    return lines, n15["K1"], seg


def mem_mark() -> int:
    """Start a peak-memory reading: frees the allocator's cache, resets the
    peak and returns the bytes still allocated (earlier phases' cached
    solvers and results)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_line(cfg, with_cbet: bool, base: int, beam_groups: int = 1,
              hold: bool = True) -> str:
    """The peak device memory since :func:`mem_mark` above what was
    allocated then, beside the estimate that ``runner.check_memory`` decides
    on; ``hold`` fails the phase when the peak exceeds the estimate."""
    import torch
    from cbet_raytracing_3d_tpu_torch.runner import estimate_device_bytes
    peak = torch.cuda.max_memory_allocated() - base
    # the CBET phases run cbet_solve_composed on a prepared scene
    est = estimate_device_bytes(cfg, with_cbet, beam_groups,
                                trace=not with_cbet)
    line = (f"peak device memory {peak / 2**30:.3f} GiB above the "
            f"{base / 2**30:.3f} GiB held at the phase's start "
            f"(torch.cuda.max_memory_allocated), estimate_device_bytes "
            f"{est / 2**30:.3f} GiB")
    if hold and peak > est:
        raise RuntimeError(f"the memory estimate is low: {line}")
    return line


def compacted_cbet(cfg, dev, ref, drift, zero_counts, read_counts, smi):
    """Phase 16: the JAX bench's CBET configuration (kernel_cell,
    ``cbet_segmented=True``, ``cbet_plan_headroom=0.5``) and the lookup,
    f32, through ``runner.run(with_cbet=True, cache_dir=...)``, against the
    uncompacted solves of phases 9 and 10; kernel_cell in f64; then seeded
    solves compacted and uncompacted in turns.  Returns (lines, launches of
    the kernel_cell run)."""
    import torch
    from cbet_raytracing_3d_tpu_torch.models import cbet
    from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
    from cbet_raytracing_3d_tpu_torch.runner import run

    cache = os.path.join(REPO, ".cbet_cache")
    batch = cfg.deposit_batch_steps
    bar = max(1e-6, 2 * drift)
    lines, checks, launches = [], {}, None
    for mode in ("kernel_cell", "lookup"):
        c = cfg.replace(cbet_gain_mode=mode, cbet_plan_headroom=0.5)
        zero_counts()
        r = run(c, with_cbet=True, device=dev, verbose=False,
                cache_dir=cache)
        n = read_counts()
        res, want = r.cbet, ref[mode]
        windows = sum(res.stats["trace_steps"]) // batch
        hrel = max(abs(a / b - 1) for a, b in zip(res.history, want.history))
        de, di = rel_l2(res.edep, want.edep), rel_l2(res.intensity,
                                                     want.intensity)
        kernel_ok = (n["K4"] == windows if mode == "kernel_cell" else
                     n["K1"] == windows + r.stats["steps_executed"] // batch)
        checks.update({
            f"{mode}: 5 iterations, segmented": res.iterations == 5
            and res.converged and res.stats["segmented"]
            and res.stats["plan_headroom"] == 0.5,
            f"{mode}: history within 1e-3": hrel < 1e-3,
            f"{mode}: edep, intensity within {bar:.1e}": de < bar
            and di < bar,
            f"{mode}: K2 == windows > 0, K3 == iterations, the pair kernel":
                n["K2"] == windows > 0
                and n["K3"] == n["K3 pairs"] == res.iterations,
            f"{mode}: K4 (kernel_cell) or K1 (lookup) per window": kernel_ok,
        })
        if mode == "kernel_cell":
            launches = n
        lines.append(
            f"{mode}, cbet_segmented, headroom 0.5: {res.iterations} "
            f"iterations, history {[f'{h:.5f}' for h in res.history]} "
            f"(max rel {hrel:.2e} from the uncompacted solve); edep "
            f"{de:.3e} intensity {di:.3e} (bar {bar:.1e}: 2 x phase 13's "
            f"full-vs-full drift); last trace's tile widths "
            f"{res.stats['tile_widths']}; launches {n} over {windows} windows"
            f"; CBET phase {r.timings['CBET']:.6f} s")
    c64 = cfg.replace(dtype="float64", cbet_gain_mode="kernel_cell",
                      cbet_plan_headroom=0.5)
    r64 = run(c64, with_cbet=True, device=dev, verbose=False,
              cache_dir=cache).cbet
    d64 = max(rel_l2(r64.edep, ref["kernel_cell_f64"].edep),
              rel_l2(r64.intensity, ref["kernel_cell_f64"].intensity))
    checks["f64 kernel_cell vs uncompacted <= 1e-10"] = d64 <= 1e-10
    lines.append(f"f64 kernel_cell compacted vs uncompacted: edep/intensity "
                 f"max rel-L2 {d64:.3e} (bar 1e-10), {r64.iterations} "
                 "iterations")
    ctx = rt.prepare_device(cfg, device=dev)
    c_kc = cfg.replace(cbet_gain_mode="kernel_cell", cbet_plan_headroom=0.5)
    variants = {"uncompacted": c_kc,
                "compacted": c_kc.replace(cbet_segmented=True)}
    for c in variants.values():
        cbet.cbet_solve(c.replace(cbet_max_iters=1), ctx, dev)
    solves = {k: [] for k in variants}
    for which in ("uncompacted", "compacted", "compacted", "uncompacted",
                  "uncompacted", "compacted"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = cbet.cbet_solve(variants[which], ctx, dev)
        torch.cuda.synchronize()
        solves[which].append((time.perf_counter() - t, r))
    checks["timed solves: 5 iterations"] = all(
        x[1].iterations == 5 for v in solves.values() for x in v)
    for which, runs in solves.items():
        secs = [x[0] for x in runs]
        st = runs[int(np.argsort(secs)[1])][1].stats
        lines.append(
            f"{which} kernel_cell solve, seeded, median "
            f"{statistics.median(secs):.6f} s of "
            f"{[round(x, 6) for x in secs]}; median solve's trace "
            f"{[round(x, 6) for x in st['iter_trace_seconds']]} s; card {smi}")
    if not all(checks.values()):
        raise RuntimeError("compacted CBET failed: "
                           f"{[k for k, v in checks.items() if not v]}; "
                           + " | ".join(lines))
    return lines, launches


def mma_probe_phase(dev, zero_counts, read_counts, smi):
    """Phase 17: K6 (wgmma + TMA) against its plain version at the six
    shapes, timed in turns with the earlier mma.sync kernel and beside
    ``torch.matmul`` in bf16; the drift and the time per chain length; then
    the probe's entry point in this process (its launches) and once as a
    subprocess.  Returns (lines, the JSON fields of the first shape,
    launches)."""
    import torch
    from cbet_raytracing_3d_tpu_torch.ops import mma_probe as mp
    from cbet_raytracing_3d_tpu_torch.scripts import bench_mma_shapes as bm

    lines, kern = [], None
    products = mp.REPS * mp.GRID
    for label, m, k, n, tr in mp.SHAPES:
        a, b = bm.operands(m, k, n, tr, dev)
        got = mp.mma_probe(a, b, mp.REPS, tr, mp.GRID)
        want = mp.mma_probe_reference(a, b, mp.REPS, tr, mp.GRID)
        old = mp._launch(a, b, mp.REPS, tr, mp.GRID, variant="wmma")
        torch.cuda.synchronize()
        err = rel_l2(got.double().cpu(), want.double().cpu())
        err_old = rel_l2(got.double().cpu(), old.double().cpu())
        mx = float((got.double() - want.double()).abs().max())
        if not (err <= 1e-5 and err_old <= 1e-5
                and bool(torch.isfinite(got).all())):
            raise RuntimeError(f"K6 vs plain failed at {label}: rel-L2 {err}"
                               f" (vs the mma.sync kernel {err_old})")

        def run_new():
            return mp.mma_probe(a, b, mp.REPS, tr, mp.GRID)

        def run_old():
            return mp._launch(a, b, mp.REPS, tr, mp.GRID, variant="wmma")

        # in turns: new, old, old, new
        t_new, t_old = [cuda_ms(run_new, 5)], [cuda_ms(run_old, 5)]
        t_old.append(cuda_ms(run_old, 5))
        t_new.append(cuda_ms(run_new, 5))
        ms, ms_old = min(t_new), min(t_old)
        ms_p = cuda_ms(lambda: mp.mma_probe_reference(a, b, mp.REPS, tr), 5)
        a_op = a.t() if tr else a
        # the library's time for the launch's products: bf16 products, each
        # one torch.matmul call, queued so that they run back to back (a
        # product is shorter than its launch); unqueued for comparison
        lib = cuda_ms(lambda: torch.matmul(a_op, b), 200, queued=True
                      ) * products
        lib_host = cuda_ms(lambda: torch.matmul(a_op, b), 200) * products
        nbytes = 2 * (m * k + k * n) + 4 * m * n
        ops = mp.flops(m, k, n, mp.REPS, mp.GRID)
        kb = bound(nbytes, ops, mp.PEAK_BF16)
        rate = ops / (ms / 1e3)
        lines.append(
            f"{label}: rel-L2 {err:.3e} (<= 1e-5; vs the mma.sync kernel "
            f"{err_old:.3e}); {ms:.4f} ms per launch of "
            f"{products} products (turns {t_new[0]:.4f} / {t_new[1]:.4f}) = "
            f"{1e3 * ms / products:.4f} us per product, "
            f"{rate / 1e12:.1f} TFLOP/s = {100 * rate / mp.PEAK_BF16:.1f} % "
            f"of 989; mma.sync kernel {ms_old:.4f} ms (turns "
            f"{t_old[0]:.4f} / {t_old[1]:.4f}); plain {ms_p:.4f} ms (one "
            f"product, summed); "
            f"torch.matmul {1e3 * lib / products:.4f} us per product queued "
            f"({1e3 * lib_host / products:.4f} us as launched) = {lib:.4f} ms "
            f"for the launch's products; bound {kb['bound_ms']:.4f}"
            f" ms ({kb['bound_by']}); card {smi}")
        if kern is None:
            kern = {"max_abs_err": mx, "ms": ms, "plain_ms": ms_p, **kb,
                    "library_ms": lib, "wmma_ms": ms_old}
            # the drift and the time per chain length at the longest k
            parts = []
            for slices, resident in ((1, True), (2, True), (4, True),
                                     (6, True), (4, False), (None, False)):
                out = mp._launch(a, b, mp.REPS, tr, mp.GRID,
                                 chain_slices=slices, resident=resident)
                torch.cuda.synchronize()
                e = rel_l2(out.double().cpu(), want.double().cpu())
                t = cuda_ms(lambda: mp._launch(
                    a, b, mp.REPS, tr, mp.GRID, chain_slices=slices,
                    resident=resident), 5)
                depth = k if slices is None else 64 * slices
                parts.append(f"{depth}-deep "
                             f"{'resident' if resident else 'streamed'} "
                             f"{e:.2e}, {t:.4f} ms")
            lines.append(f"chain lengths at {label} (rel-L2 vs plain, ms per "
                         "launch): " + "; ".join(parts))
    # the public wrapper takes the wgmma kernel and no other
    zero_counts()
    mp.mma_probe(a, b, mp.REPS, tr, mp.GRID)
    n_pub = read_counts()
    if (n_pub["K6"], n_pub["K6 mma.sync"]) != (1, 0):
        raise RuntimeError(f"mma_probe() launched {n_pub['K6']} wgmma and "
                           f"{n_pub['K6 mma.sync']} mma.sync kernels")
    zero_counts()
    if bm.main() != 0:
        raise RuntimeError("bench_mma_shapes failed in process")
    n17, n17_old = read_counts()["K6"], read_counts()["K6 mma.sync"]
    if not n17 == n17_old == 4 * len(mp.SHAPES):
        raise RuntimeError(f"bench_mma_shapes launched K6 {n17} times and "
                           f"the mma.sync kernel {n17_old} times")
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.scripts.bench_mma_shapes"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    if proc.returncode != 0:
        raise RuntimeError(f"bench_mma_shapes subprocess rc "
                           f"{proc.returncode}: {proc.stderr[-2000:]}")
    lines.append(f"bench_mma_shapes: {n17} K6 launches (all wgmma; the "
                 f"mma.sync kernel {n17_old}) in process; as a "
                 f"subprocess rc 0, {len(proc.stdout.splitlines())} lines")
    return lines, kern, n17


def resumable_trace(cfg, dev, drift, seg15, zero_counts, read_counts, smi):
    """Phase 18: ``runner.run_composed`` at OMEGA, uninterrupted and
    resumed.  Returns (lines, the uninterrupted result)."""
    import shutil
    import torch
    from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
    from cbet_raytracing_3d_tpu_torch.runner import run_composed
    from cbet_raytracing_3d_tpu_torch.utils import checkpoint as ck

    work = os.path.join(REPO, "out", "chip_smoke_ckpt")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    batch = cfg.deposit_batch_steps
    base = mem_mark()
    zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    full = run_composed(cfg, device=dev, verbose=False)
    t_full = time.perf_counter() - t
    n18 = read_counts()
    lines = [peak_line(cfg, False, base)]
    st = full.stats
    keys = [k for k in st if k != "edep_total"]
    d15 = rel_l2(full.edep, seg15.edep)
    checks = {
        "K1 launches == windows > 0":
            n18["K1"] * batch == st["steps_executed"] > 0,
        f"vs phase 15's compacted run <= 2 x drift ({2 * drift:.2e})":
            d15 <= 2 * drift,
        "widths, steps and counts of phase 15": all(
            st[k] == seg15.stats[k] for k in (
                "tile_widths", "steps_executed", "rays_launched",
                "rays_terminated", "rays_alive_at_end", "energy_absorbed")),
    }
    # the chunk loop by hand: which boundaries compact, and a carry to time
    # one checkpoint with
    chunks = rt.ChunkedTrace(cfg, compact=True)
    state0 = rt.traced_state(full.ctx, dev)
    carry = chunks.start(state0)
    bounds, cost = [], None
    fp = ck.run_fingerprint(cfg, dev, "composed")
    while chunks.advance(full.ctx.field4, carry):
        if carry.comp.keep(carry.state.alive, False) is not None:
            bounds.append(carry.chunk)
            if len(bounds) == 2:
                path = os.path.join(work, "cost.npz")
                torch.cuda.synchronize()
                t = time.perf_counter()
                ck.save_composed_checkpoint(
                    path, fp, carry.chunk, carry.steps, carry.master,
                    carry.state, int(carry.oflow), carry.comp.state_dict())
                t_w = time.perf_counter() - t
                t = time.perf_counter()
                ck.load_composed_checkpoint(path, fp, dev)
                torch.cuda.synchronize()
                cost = (t_w, time.perf_counter() - t, os.path.getsize(path),
                        carry.state.n)
    boundary = bounds[1]
    mid = next(c for c in range(2, carry.chunk) if c not in bounds)
    lines.append(
        f"run_composed uninterrupted {t_full:.6f} s (phases "
        + " ".join(f"{k} {v:.6f}" for k, v in full.timings.items())
        + f"); tile widths {st['tile_widths']}, chunks {st['chunks']}, steps "
        f"{st['steps_executed']}, K1 launches {n18['K1']}; vs phase 15 "
        f"rel-L2 {d15:.3e}; boundaries that compact after chunks {bounds}")
    t_w, t_r, size, n = cost
    lines.append(f"one checkpoint after chunk {boundary} ({n} slots + the "
                 f"written-back full state): write {t_w:.4f} s, read "
                 f"{t_r:.4f} s, {size} bytes; card {smi}")
    for where, stop in (("mid-width", mid), ("compaction boundary",
                                             boundary)):
        path = os.path.join(work, f"trace_{stop}.npz")
        out = run_composed(cfg, device=dev, verbose=False,
                           checkpoint_path=path, stop_after_chunks=stop)
        saved = ck.load_composed_checkpoint(path, fp, dev)[0]
        zero_counts()
        res = run_composed(cfg, device=dev, verbose=False,
                           checkpoint_path=path, resume=True)
        n_res = read_counts()["K1"]
        d = rel_l2(res.edep, full.edep)
        same = [k for k in keys if res.stats[k] != st[k]]
        checks.update({
            f"{where}: stopped with a checkpoint of chunk {stop}":
                out is None and saved == stop,
            f"{where}: stats, widths, steps equal": not same,
            f"{where}: edep <= 2 x drift": d <= 2 * drift,
            f"{where}: the resumed part's K1 launches":
                n_res * batch == st["steps_executed"]
                - stop * rt.chunk_lengths(cfg)[0],
        })
        lines.append(f"stopped after chunk {stop} ({where}), resumed: edep "
                     f"rel-L2 {d:.3e} (bar {2 * drift:.3e}), stats that "
                     f"differ {same}, K1 launches of the resumed part "
                     f"{n_res}")
    try:
        run_composed(cfg.replace(intensity=2 * cfg.intensity), device=dev,
                     verbose=False, checkpoint_path=path, resume=True)
        checks["another config's checkpoint refused"] = False
    except ValueError as e:
        checks["another config's checkpoint refused"] = "fingerprint" in str(e)
    shutil.rmtree(work, ignore_errors=True)
    if not all(checks.values()):
        raise RuntimeError("resumable trace failed: "
                           f"{[k for k, v in checks.items() if not v]}; "
                           + " | ".join(lines))
    return lines, full


def composed_cbet(cfg, dev, ctx, ref, drift, zero_counts, read_counts, smi):
    """Phase 19: ``cbet_solve_composed`` at OMEGA against phase 9's lookup
    solve ``ref``; resumed; grouped; through the CLI.  Returns lines."""
    import shutil
    import torch
    from cbet_raytracing_3d_tpu_torch.models.cbet_composed import (
        ACCOUNTING_KEYS, cbet_solve_composed)

    work = os.path.join(REPO, "out", "chip_smoke_ckpt")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    batch = cfg.deposit_batch_steps
    bar = max(1e-6, 2 * drift)
    lines, checks = [], {}

    def solve(c=cfg, **kw):
        zero_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = cbet_solve_composed(c, ctx, device=dev, verbose=False, **kw)
        return r, time.perf_counter() - t, read_counts()

    def hrel(a, b):
        return max(abs(x / y - 1) for x, y in zip(a.history, b.history))

    def launches_ok(r, n, gains):
        """K1 and K2 once per window of this call's traces (summed over the
        groups), K3 once per iteration this call ran, no K4."""
        windows = sum(r.stats["trace_steps"]) // batch
        return (n["K1"] == n["K2"] == windows > 0
                and n["K3"] == n["K3 pairs"] == gains and n["K4"] == 0)

    p1 = os.path.join(work, "cbet_full.npz")
    base = mem_mark()
    full, t_full, n = solve(beam_groups=1, checkpoint_path=p1)
    lines.append(peak_line(cfg, True, base))
    de, di = rel_l2(full.edep, ref.edep), rel_l2(full.intensity,
                                                 ref.intensity)
    checks.update({
        "5 iterations, converged": full.iterations == 5 and full.converged,
        "history within 1e-3 of phase 9's lookup solve":
            hrel(full, ref) < 1e-3,
        f"edep, intensity within {bar:.1e} of phase 9's": de < bar
        and di < bar,
        "K1 == K2 == windows, K3 == iterations (pair kernel), no K4":
            launches_ok(full, n, 5)
            and len(full.stats["trace_steps"]) == 6,
    })
    lines.append(
        f"cbet_solve_composed, 1 group: {full.iterations} iterations, "
        f"history {[f'{h:.5f}' for h in full.history]} (max rel "
        f"{hrel(full, ref):.2e} from phase 9's lookup solve); edep {de:.3e} "
        f"intensity {di:.3e} (bar {bar:.1e}); {t_full:.6f} s, iterations "
        f"{full.stats['iter_seconds']} s; launches {n} over "
        f"{sum(full.stats['trace_steps']) // batch} windows; checkpoint "
        f"{os.path.getsize(p1)} bytes; card {smi}")

    # interrupted after iteration 1 of a solve bounded at 3, resumed with
    # the bound raised
    p2 = os.path.join(work, "cbet_part.npz")
    part, _, _ = solve(cfg.replace(cbet_max_iters=3), beam_groups=1,
                       checkpoint_path=p2, stop_after_iterations=2)
    res, _, n_res = solve(beam_groups=1, checkpoint_path=p2, resume=True)
    d_res = max(rel_l2(res.edep, full.edep),
                rel_l2(res.intensity, full.intensity))
    checks.update({
        "stopped after 2 iterations": part is None,
        "resumed: 5 iterations, history within 1e-4":
            res.iterations == 5 and res.converged and hrel(res, full) < 1e-4,
        f"resumed: edep, intensity within {bar:.1e}": d_res < bar,
        "resumed: 4 traces' launches": launches_ok(res, n_res, 4)
        and len(res.stats["trace_steps"]) == 4,
    })
    lines.append(f"stopped after iteration 1 (cbet_max_iters 3), resumed "
                 f"with the bound raised: {res.iterations} iterations, "
                 f"history max rel {hrel(res, full):.2e}, edep/intensity "
                 f"max rel-L2 {d_res:.3e}; launches {n_res}")

    # a resume on the converged checkpoint: the result without a launch
    again, t_again, n_again = solve(beam_groups=1, checkpoint_path=p1,
                                    resume=True)
    checks.update({
        "converged checkpoint: no launch": not any(n_again.values()),
        "converged checkpoint: the same result": (
            again.iterations == 5 and again.history == full.history
            and np.array_equal(again.edep, full.edep)
            and np.array_equal(again.intensity, full.intensity)),
        "converged checkpoint: accounting kept": all(
            again.stats[k] == full.stats[k] for k in ACCOUNTING_KEYS),
    })
    lines.append(f"resume on the converged checkpoint: {t_again:.6f} s, "
                 f"launches {n_again}, accounting "
                 f"{ {k: again.stats[k] for k in ACCOUNTING_KEYS} }")

    base = mem_mark()
    g4, t_g4, n_g4 = solve(beam_groups=4)
    lines.append("4 groups: " + peak_line(cfg, True, base, 4))
    d_g4 = max(rel_l2(g4.edep, full.edep),
               rel_l2(g4.intensity, full.intensity))
    checks.update({
        "4 groups: 5 iterations, history within 1e-4":
            g4.iterations == 5 and hrel(g4, full) < 1e-4,
        f"4 groups: edep, intensity within {bar:.1e}": d_g4 < bar,
        "4 groups: K2 == windows x groups, K3 == iterations":
            launches_ok(g4, n_g4, 5)
            and g4.stats["chunks_per_iteration"]
            == 4 * full.stats["chunks_per_iteration"],
    })
    lines.append(f"beam_groups=4 against 1: history max rel "
                 f"{hrel(g4, full):.2e}, edep/intensity max rel-L2 "
                 f"{d_g4:.3e}; {t_g4:.6f} s against {t_full:.6f} s; launches "
                 f"{n_g4} over {sum(g4.stats['trace_steps']) // batch} "
                 "windows")

    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.cli", "run", "--composed", "--cbet",
         "--checkpoint", os.path.join(work, "cli_trace.npz"),
         "--cbet-checkpoint", os.path.join(work, "cli_cbet.npz"),
         "--out-dir", os.path.join(work, "cli"), "--formats", "json",
         "--quiet"],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    t_cli = time.perf_counter() - t
    ok = proc.returncode == 0
    if ok:
        with open(os.path.join(work, "cli", "edep.json")) as f:
            payload = json.load(f)
        ok = (payload["cbet"]["iterations"] == 5
              and payload["cbet"]["stats"]["intensity_mode"]
              == "grouped_composed"
              and os.path.exists(os.path.join(work, "cli_trace.npz"))
              and os.path.exists(os.path.join(work, "cli_cbet.npz")))
    checks["cli run --composed --cbet with both checkpoints: rc 0"] = ok
    lines.append(f"cli run --composed --cbet --checkpoint --cbet-checkpoint "
                 f"as a subprocess: rc {proc.returncode}, {t_cli:.1f} s")
    shutil.rmtree(work, ignore_errors=True)
    if not all(checks.values()):
        raise RuntimeError("composed CBET failed: "
                           f"{[k for k, v in checks.items() if not v]}; "
                           + " | ".join(lines) + proc.stderr[-2000:])
    return lines


if __name__ == "__main__":
    sys.exit(main())
