"""End-to-end run orchestrator, mirroring the reference driver
(``rayTracing()``, main.cu:96-232): Init (profiles, fields, ray setup, device
upload) -> Tracing (device compute) -> Combining (grid download), with the
reference's phase-timing report, plus run metrics and output writing.

Counterpart of ``cbet_raytracing_3d_tpu/runner.py::run`` and
``write_outputs`` on one device, with the optional CBET stage: no mesh.
The trace and the CBET solve run over the live tiles, compacted mid-trace
when a cache dir is given (the JAX CLI's default).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Any

import numpy as np
import torch

from .config import Config
from .models import raytracer as rt
from .models.cbet import cbet_solve, check_cbet_config
from .models.raytracer import default_device
from .utils.output import HAVE_H5PY, save_hdf5, save_npz
from .utils.timers import PhaseTimers


@dataclasses.dataclass
class RunResult:
    cfg: Config
    edep: np.ndarray             # ghost-padded (nx+2, ny+2, nz+2) float64
    stats: dict[str, Any]
    timings: dict[str, float]
    cbet: Any | None = None      # models.cbet.CbetResult of the CBET stage


def estimate_device_bytes(cfg: Config, with_cbet: bool = False) -> int:
    """Device memory a run needs: the counterpart of the JAX package's
    ``estimate_hbm_bytes`` for the port's layout.

    * the traced ray state (11 float + 3 int32 + 1 bool per slot), the
      step's temporaries (about three more states' worth) and a compacted
      trace's write-back copy (one more),
    * the (P, 4) field table,
    * the grids: the ``edep_dtype`` master and the chunk grid,
    * CBET: the solver's copy of the state and its traces' write-back
      copy; the (B, Ph) intensity iterates
      in the ray dtype (current, new, blend, the zero-gain seed) with the
      float32 copy the gain reads and the float32 gain it returns; the
      (B, P) gain table in the ray dtype (plus the float32 upsampling
      temporaries when the CBET grid is coarsened); the per-beam intensity
      grids (B, hx+2, hy+2, hz+2), chunk grid and master; the window's
      (batch, N) streams: in the kernel gain modes the window advance's,
      in the batched lookup the per-step rows and their concatenation; for
      ``cbet_accel="anderson"``
      three more intensity-sized buffers (the secant history and the
      residual).  The kernel gain modes read the unpadded (B, P) gain table
      counted above: the port makes no padded copy of it."""
    layout = rt.build_tile_layout(cfg)
    n = layout.n_slots
    fbytes = 4 if cfg.dtype == "float32" else 8
    state_bytes = 11 * fbytes + 3 * 4 + 1
    P = cfg.nx * cfg.ny * cfg.nz
    nxp, nyp, nzp = cfg.edep_shape
    master_bytes = 8 if cfg.edep_dtype == "float64" else 4
    grids = nxp * nyp * nzp * (master_bytes + fbytes)
    total = 5 * n * state_bytes + P * 4 * fbytes + grids
    if with_cbet:
        hx, hy, hz = cfg.cbet_grid_shape
        B = cfg.nbeams
        total += 2 * n * state_bytes
        total += B * hx * hy * hz * (4 * fbytes + 2 * 4) + B * P * fbytes
        if cfg.cbet_grid_downsample > 1:
            total += 2 * B * P * 4
        total += 2 * B * (hx + 2) * (hy + 2) * (hz + 2) * fbytes
        batch = max(1, cfg.deposit_batch_steps)
        if cfg.cbet_gain_mode != "lookup":
            # 13 streams (cells, lag cells, fracs, inc, ds, contrib, energy,
            # gamma) of (batch, N), 4-byte ints counted at the float width
            total += 13 * batch * n * fbytes
        else:
            # 8 rows (cells, fracs, inc, contrib) per step, twice
            total += 16 * batch * n * fbytes
        if cfg.cbet_accel == "anderson":
            total += 3 * B * hx * hy * hz * fbytes
    return total


def check_memory(cfg: Config, device, with_cbet: bool = False) -> None:
    """Fail fast with a clear message when the run cannot fit on the card
    (``torch.cuda.mem_get_info``) — unlike the reference, which logs
    allocation errors and continues (SURVEY.md §5.3).  No-op on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    need = estimate_device_bytes(cfg, with_cbet)
    free, total = torch.cuda.mem_get_info(device)
    if need > 0.95 * free:
        raise RuntimeError(
            f"estimated device memory demand {need / 2**30:.1f} GiB exceeds "
            f"the free {free / 2**30:.1f} GiB of {total / 2**30:.1f} GiB on "
            f"{device} — reduce grid or ray counts")


def run(cfg: Config, *, with_cbet: bool = False, device=None,
        verbose: bool = True, cache_dir: str | None = None) -> RunResult:
    """Full simulation run with reference-parity phase accounting, on
    ``device`` (default: the card, ``models.raytracer.default_device``,
    which raises without one; ``"cpu"`` for a CPU run).
    ``with_cbet`` adds the "CBET" phase: the fixed-point solve over the same
    scene (``RunResult.cbet``).

    As ``runner.py:166-250`` of the JAX package: on the card the rays are
    initialized there (``prepare_device``), on the CPU by the host
    ``prepare``; with a ``cache_dir`` the trace drops dead tiles mid-trace
    with final-state write-back (``stats["segmented"]``, the tile counts in
    ``stats["tile_widths"]``) and the CBET solve runs with
    ``cbet_segmented=True``.  The port writes nothing into ``cache_dir``:
    its compaction needs no plan to cache."""
    device = torch.device(device) if device is not None else default_device()
    segmented = cache_dir is not None
    if with_cbet:
        check_cbet_config(cfg)          # refuse before the trace runs
    check_memory(cfg, device, with_cbet)
    timers = PhaseTimers(device)

    with timers.phase("Init"):
        if device.type == "cuda":
            # on-card init (the reference's init() is device code,
            # launch_ray_XZ.cu:65-115): the state is born live-tile
            # compacted on the card
            ctx = rt.prepare_device(cfg, device=device)
        else:
            # host prepare in float64 NumPy, then one upload of the
            # live-tile state and the field table
            ctx = rt.prepare(cfg)
        state0 = rt.traced_state(ctx, device)
        field4 = ctx.field4.to(device)
        fn = rt.make_trace_fn(cfg, compact=segmented)

    widths = []
    with timers.phase("Tracing"):
        edep_dev, state, oflow, steps = fn(field4, state0, widths)
    with timers.phase("Combining"):
        edep = edep_dev.to("cpu", torch.float64).numpy()
        oflow = int(oflow)

    rt.check_overflow(oflow, cfg)

    stats = rt.trace_stats(ctx, state, state0)
    stats["edep_total"] = float(edep.sum())
    stats["devices"] = 1
    stats["steps_executed"] = steps
    stats["segmented"] = segmented
    stats["tile_widths"] = widths

    cbet_result = None
    if with_cbet:
        with timers.phase("CBET"):
            cfg_c = cfg.replace(cbet_segmented=True) if segmented else cfg
            cbet_result = cbet_solve(cfg_c, ctx, device=device)

    timings = timers.as_dict()
    if verbose:
        print(timers.report(), file=sys.stderr)
    return RunResult(cfg=cfg, edep=edep, stats=stats, timings=timings,
                     cbet=cbet_result)


def write_outputs(res: RunResult, outdir: str, formats: tuple[str, ...] = ("npz",),
                  basename: str = "edep") -> list[str]:
    """Persist a run in the given formats (npz, hdf5, txt, json).  With the
    CBET stage, its coupled deposition, per-beam intensity fields and
    convergence record are written as the JAX package writes them: npz
    ``cbet_*`` extras, a ``*_cbet`` sibling for the schema-fixed hdf5 and
    txt formats, and a "cbet" json section."""
    os.makedirs(outdir, exist_ok=True)
    cbet = res.cbet
    written = []
    for fmt in formats:
        path = os.path.join(outdir, f"{basename}.{fmt}")
        cpath = os.path.join(outdir, f"{basename}_cbet.{fmt}")
        if fmt == "npz":
            extras = {}
            if cbet is not None:
                extras = {"cbet_edep": cbet.edep,
                          "cbet_intensity": cbet.intensity,
                          "cbet_iterations": np.int64(cbet.iterations),
                          "cbet_converged": np.bool_(cbet.converged),
                          "cbet_history": np.asarray(cbet.history)}
            save_npz(path, res.cfg, res.edep, res.stats, extras=extras)
        elif fmt == "hdf5":
            if not HAVE_H5PY:
                print("warning: h5py unavailable, skipping hdf5 output",
                      file=sys.stderr)
                continue
            save_hdf5(path, res.cfg, res.edep)
            if cbet is not None:
                save_hdf5(cpath, res.cfg, cbet.edep)
                written.append(cpath)
        elif fmt == "txt":
            from .utils.native import write_print_dump
            write_print_dump(path, res.edep)
            if cbet is not None:
                write_print_dump(cpath, cbet.edep)
                written.append(cpath)
        elif fmt == "json":
            payload = {"stats": res.stats, "timings": res.timings}
            if cbet is not None:
                payload["cbet"] = {
                    "iterations": cbet.iterations,
                    "converged": cbet.converged,
                    "history": [float(h) for h in cbet.history],
                    "edep_total": float(cbet.edep.sum()),
                    "stats": cbet.stats,
                }
            with open(path, "w") as f:
                json.dump(payload, f, indent=2)
        else:
            raise ValueError(f"unknown output format: {fmt}")
        written.append(path)
    return written
