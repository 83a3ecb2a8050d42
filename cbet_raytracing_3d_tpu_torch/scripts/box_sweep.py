"""The tile box's capacity against K1, K2 and K4 "cell" on the main path's
windows.

    python -m cbet_raytracing_3d_tpu_torch.scripts.box_sweep

Builds the OMEGA CBET window that ``chip_smoke.py`` phase 8 times (the CBET
slot layout, 150 ordinary steps in, a smooth seeded gain of both signs) and
runs K2 (the window's ``contrib0 * gamma`` into 60 beam grids) and K4 "cell"
on it, and K1 on the plain trace's window that phase 3 times (the traced
slots, 150 steps in), at each capacity of ``CAPACITIES`` (0 is the direct
kernel, one thread per row; 1 fits no block, so every block takes the window
kernel's own direct path, ray-major), forward then backward.  Prints, per
capacity, each kernel's mean milliseconds per call
(CUDA events, 20 calls, both passes) and its blocks with rows and blocks that
took the box.  The kernels' default capacity (``cbet_box_default_nodes``) was
chosen from this sweep.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import Config
from ..models import cbet
from ..models import raytracer as rt
from ..ops import deposit as dep
from ..ops import gain_deposit as gdep
from ..utils import cuda_build
from .bench_mma_shapes import card_line

CAPACITIES = (0, 1, 1024, 2048, 3072, 4096, 5120)
SEED = 20261020           # chip_smoke.py's SEED + 4: phase 8's window gain


def smooth_gain(rng, cfg, scale, device, block=4):
    """A smooth (B, P) float32 gain of both signs: a normal field on every
    ``block``-th node, repeated over the block, times ``scale``."""
    n = [-(-m // block) for m in (cfg.nx, cfg.ny, cfg.nz)]
    ones = np.ones((block,) * 3)
    out = np.stack([np.kron(rng.standard_normal(n), ones)
                    [:cfg.nx, :cfg.ny, :cfg.nz].reshape(-1)
                    for _ in range(cfg.nbeams)])
    return torch.as_tensor(out * scale, dtype=torch.float32, device=device)


def window(cfg, ctx, device, warm_steps):
    """The CBET layout's window after ``warm_steps`` ordinary steps:
    (K4 "cell" arguments after edep, K2 arguments after the grids)."""
    slots = cbet.live_tile_slots(cfg, ctx)
    rpg = len(slots) // cfg.nbeams
    state = rt.select_rays(ctx.state0, slots).to(device).map(
        lambda a: a.to(torch.float32) if a.is_floating_point() else a)
    field4 = ctx.field4.to(device, torch.float32)
    step = rt.make_deferred_step_fn(cfg)
    for _ in range(warm_steps):
        state, _ = step(state, field4)
    st, w = cbet.make_window_advance(cfg)(state, field4)
    gain = smooth_gain(np.random.default_rng(SEED), cfg, 40.0, device)
    k4 = (w["cx"], w["cy"], w["cz"], w["fx"], w["fy"], w["fz"], w["inc"],
          w["ds"], w["u_nogain"], st.uray_init, w["lcx"], w["lcy"], w["lcz"],
          gain, rpg, cbet.GAIN_CLIP, cfg.stop_fraction)
    _, _, gamma, _ = gdep.deposit_gain_window_reference(
        torch.zeros(cfg.edep_shape, device=device), *k4)
    flat = [w[k].reshape(-1) for k in ("cx", "cy", "cz", "fx", "fy", "fz")]
    k2 = (*flat, (w["contrib0"] * gamma).reshape(-1), rpg, w["cx"].shape[1])
    return k4, k2


def trace_window(cfg, ctx, device, warm_steps, dtype=torch.float32):
    """The plain trace's window after ``warm_steps`` ordinary steps, as
    ``raytracer.make_trace_fn`` builds it (the traced slots, each step
    writing its row of the window buffer): K1's arguments after the grid,
    the seven step-major row tensors and the ray count."""
    state = rt.traced_state(ctx, device).map(
        lambda a: a.to(dtype) if a.is_floating_point() else a)
    field4 = ctx.field4.to(device, dtype)
    step = rt.make_deferred_step_fn(cfg)
    for _ in range(warm_steps):
        state, _ = step(state, field4)
    rows, flat = rt._window_rows(cfg.deposit_batch_steps, state.n, dtype,
                                 device)
    for out in rows:
        state, _ = step(state, field4, out)
    return (*flat, state.n)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, CUDA events, after
    one warm-up call."""
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
    if not torch.cuda.is_available():
        print("box_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = Config()
    print(f"device={torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{card_line()}; torch {torch.__version__}; default capacity "
          f"{cuda_build.load().cbet_box_default_nodes()} nodes", flush=True)
    ctx = rt.prepare(cfg)
    k4, k2 = window(cfg, ctx, dev, 3 * cfg.nt // 8)
    k1 = trace_window(cfg, ctx, dev, 3 * cfg.nt // 8)
    edep = torch.zeros(cfg.edep_shape, device=dev)
    grids = torch.zeros((cfg.nbeams,) + cfg.edep_shape, device=dev)
    launches = {
        "K1": lambda cap, t=None: dep._launch(edep, *k1, box_nodes=cap,
                                              tally=t),
        "K2": lambda cap, t=None: dep._launch_grouped(
            grids, *k2, box_nodes=cap, tally=t),
        "K4 cell": lambda cap, t=None: gdep._launch(
            edep, k4[:9], k4[9], k4[10:13], k4[13], *k4[14:], False,
            box_nodes=cap, tally=t)}
    ms = {cap: {k: [] for k in launches} for cap in CAPACITIES}
    for cap in CAPACITIES + CAPACITIES[::-1]:
        for k, fn in launches.items():
            ms[cap][k].append(cuda_ms(lambda: fn(cap), 20))
    for cap in CAPACITIES:
        parts = []
        for k, fn in launches.items():
            tally = torch.zeros(2, dtype=torch.int32, device=dev)
            fn(cap, tally)
            torch.cuda.synchronize()
            parts.append(f"{k} {sum(ms[cap][k]) / 2:.4f} ms, blocks in the "
                         f"box {int(tally[1])} of {int(tally[0])}")
        print(f"capacity {cap} nodes: " + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
