"""Where a trace's time goes on the card: the OMEGA trace and one CBET
trace, each uncompacted and compacted, and the OMEGA trace with a deposit
per step (``deposit_batch_steps=1``) beside its windows, timed and profiled.

    python -m cbet_raytracing_3d_tpu_torch.scripts.profile_trace [--config4]

For each trace: one warm-up, the median of 3 synchronized wall times (the
traces run in turns, forward then backward, so that drift on the shared host
falls on all of them), then one run under ``torch.profiler``: the device's
busy time (the sum of the kernels' device time), its idle share against the
unprofiled median, the kernels that took most of it and the package's own
kernels (``csrc/``), and the host's aten operator count.  The rays are initialized on the card
(``prepare_device``); the CBET trace is the kernel_cell solver's trace at
zero gain.  Exits non-zero without a CUDA device.

With ``--config4`` the cases are BASELINE config 4's instead
(``scripts/config4.CONFIG4``, a deposit per step): its compacted trace (the
loop of ``runner.run_composed``) and one beam group's compacted lookup CBET
trace at zero gain (15 of the 60 beams, a trace of ``cbet_solve_composed``
with its 4 groups).

The profiler is ``utils/profiling.py``'s, as ``runner.run(profile_dir=...)``
(``cli run --profile-dir``) uses it.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

from ..config import Config
from ..models import cbet
from ..models import raytracer as rt
from ..utils.profiling import activities
from .bench_mma_shapes import card_line


def walls_in_turns(cases: dict, rounds: int = 3) -> dict:
    """Synchronized wall seconds of each case, after one warm-up each,
    ``rounds`` times in turns (forward, backward, forward, ...)."""
    names = list(cases)
    walls = {name: [] for name in names}
    for name in names:
        cases[name]()
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            cases[name]()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t)
    return walls


def profile(fn, walls: list, top: int = 6) -> dict:
    """The device time of one profiled call of ``fn``: busy seconds, the
    idle share against the median of ``walls``, and the ``top`` kernels."""
    from torch.autograd import DeviceType
    with torch.profiler.profile(activities=activities()) as prof:
        fn()
        torch.cuda.synchronize()
    # the device's own events (kernels, copies): the host operators that
    # launched them carry the same time again
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    wall = statistics.median(walls)
    # the host's work: the aten operators it ran (nested ones included)
    ops = sum(e.count for e in prof.key_averages()
              if e.key.startswith("aten::"))
    # the package's own kernels (csrc/, in an anonymous namespace; a
    # template's name starts with its return type), whatever their rank
    hand = [r for r in rows if "(anonymous namespace)::" in r[0]
            and "at::native" not in r[0]]
    return {"wall": wall, "walls": walls, "busy": busy,
            "idle": 1.0 - busy / wall, "top": rows[:top], "hand": hand,
            "host_ops": ops}


def config4_cases(dev) -> dict:
    """Config 4's compacted trace and group 0's compacted lookup CBET trace
    at zero gain (the composed solve's unit of work), on one on-card
    init."""
    from .config4 import CONFIG4, GROUPS
    cfg = CONFIG4
    ctx = rt.prepare_device(cfg, device=dev)
    trace = rt.make_trace_fn(cfg, compact=True)
    cfg_t = cfg.replace(cbet_segmented=True)
    state0, bid, tpg = cbet.solver_state(cfg_t, ctx, dev)
    nb_g, rows_g = cfg.nbeams // GROUPS, state0.n // GROUPS
    group = cbet.make_cbet_trace_fn(cfg_t, ctx, tiles_per_group=tpg,
                                    n_beams=nb_g)
    gain = torch.zeros((nb_g, cfg.nx * cfg.ny * cfg.nz), device=dev)
    state_g = state0.map(lambda a: a[:rows_g])
    return {
        "config 4 trace compacted, a deposit per step":
            lambda: trace(ctx.field4, ctx.state0),
        f"config 4 lookup CBET trace of one group ({nb_g} beams), "
        "compacted, zero gain":
            lambda: group(ctx.field4, gain, bid[:rows_g], state_g)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config4", action="store_true",
                    help="BASELINE config 4's trace and one group's CBET "
                         "trace instead of OMEGA's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_trace: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = Config()
    print(f"device={torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{card_line()}; torch {torch.__version__}", flush=True)
    cases = config4_cases(dev) if args.config4 else omega_cases(cfg, dev)
    walls = walls_in_turns(cases)
    for name, fn in cases.items():
        r = profile(fn, walls[name])
        print(f"{name}: wall median {r['wall']:.6f} s of "
              f"{[round(x, 6) for x in r['walls']]}; device busy "
              f"{r['busy']:.6f} s, idle {100 * r['idle']:.1f} %; host aten ops "
              f"{r['host_ops']}", flush=True)
        for tag, rows in (("top", r["top"]), ("hand kernels", r["hand"])):
            print(f"  {tag}:", flush=True)
            for key, us, count in rows:
                print(f"    {us / 1e3:10.3f} ms "
                      f"{100 * us / 1e6 / r['busy']:5.1f} %  x{count:<6d} "
                      f"{key[:90]}", flush=True)
    return 0


def omega_cases(cfg, dev) -> dict:
    """The OMEGA traces: plain with windows and a deposit per step, and the
    kernel_cell CBET trace at zero gain, each uncompacted and compacted."""
    ctx = rt.prepare_device(cfg, device=dev)
    cases = {}
    for compact in (False, True):
        fn = rt.make_trace_fn(cfg, compact=compact)
        cases[f"trace {'compacted' if compact else 'uncompacted'}"] = (
            lambda fn=fn: fn(ctx.field4, ctx.state0))
        fn1 = rt.make_trace_fn(cfg.replace(deposit_batch_steps=1),
                               compact=compact)
        cases[f"trace {'compacted' if compact else 'uncompacted'}, a "
              "deposit per step"] = (
            lambda fn=fn1: fn(ctx.field4, ctx.state0))
        c = cfg.replace(cbet_gain_mode="kernel_cell", cbet_segmented=compact)
        solver = cbet._get_solver(c, ctx, dev, cbet.kernel_ops())
        gain = solver.make_zero_gain()
        cases[f"kernel_cell CBET trace "
              f"{'compacted' if compact else 'uncompacted'}"] = (
            lambda s=solver, g=gain: s.trace(g))
    return cases


if __name__ == "__main__":
    sys.exit(main())
