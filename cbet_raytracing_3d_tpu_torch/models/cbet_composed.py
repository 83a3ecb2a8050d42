"""The composed (resumable) CBET solve: the large-scale variant of
``models.cbet.cbet_solve``.

Counterpart of ``cbet_raytracing_3d_tpu/models/cbet_composed.py``.  It is
the same fixed point built from the same pieces (``make_gain_fn``,
``make_gain_upsampler``, the lookup trace of ``make_cbet_trace_fn``,
``_step_update``), not a second solver; what it adds:

* an **iteration-boundary checkpoint** of the fixed-point state, which is
  just the (B, Ph) intensity, since every iteration retraces from the same
  launch state; a resumed solve continues from the saved iteration.  The
  converged iteration's checkpoint also carries the coupled edep and the
  run's accounting scalars, so a resume that lands there returns the whole
  result without a trace;
* **serial beam groups**: the beams split into G groups traced one after
  another, each needing only its own beams' full-resolution gain rows (the
  (B, P) table is the largest CBET-only term of a large scene), its own
  per-beam intensity grids and its own rows of the state.  A group's
  intensity rows are exact row blocks of the whole trace's; edep is summed
  over the groups into the ``edep_dtype`` master.  Grouping changes data
  movement, not values (edep to the rounding of another order of adds);
* the traces are always compacted (``cbet_segmented``) and iteration 0,
  the zero-gain trace, always runs (there is no plain trace to reuse).

Dropped from the JAX module, with the reason: the pairwise float32
accumulator (the master is float64 on the card); the gain-proof tile plan,
its cache and the plan's fingerprint (compaction reads the trace's own
``alive`` mask, exact under any gain); host-dispatched chunk programs (the
port's traces are eager chunk loops).  ``cache_dir`` is accepted and
unused.  The port's CBET checkpoints are not the JAX package's format
(``utils/checkpoint.py``).

Scope, as in the JAX module: the lookup gain model, the plain relaxed
update, gain sampled at every step, every iteration a full trace; other
settings are refused rather than silently replaced.

Resume.  On the CPU a resumed solve equals the uninterrupted one bit for
bit.  On the card the intensity goes through atomic adds and feeds the
gain, so a resumed solve equals the uninterrupted one as two uninterrupted
solves equal each other, with the same number of iterations.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any

import torch

from ..config import Config
from . import raytracer as rt
from .cbet import (CbetResult, _step_update, _sync, make_cbet_trace_fn,
                   make_gain_fn, make_gain_upsampler, resolve_cbet_ops,
                   solver_state)

#: the accounting keys a converged checkpoint keeps (``raytracer.trace_stats``)
ACCOUNTING_KEYS = ("rays_total", "rays_launched", "rays_alive_at_end",
                   "rays_terminated", "energy_launched", "energy_absorbed")


def check_composed_config(cfg: Config) -> None:
    """The JAX module's refusals (``cbet_composed.py:270-289``)."""
    if cfg.cbet_gain_mode != "lookup":
        raise ValueError(
            f"cbet_solve_composed applies gain in the lookup model only; "
            f"cbet_gain_mode={cfg.cbet_gain_mode!r} would be silently "
            "substituted — set cbet_gain_mode='lookup' or use cbet_solve")
    if cfg.cbet_accel != "none":
        raise ValueError(
            f"cbet_solve_composed runs the plain relaxed iteration only; "
            f"cbet_accel={cfg.cbet_accel!r} is not supported here — use "
            "cbet_solve for accelerated mixing")
    if cfg.cbet_light_iterations:
        raise ValueError(
            "cbet_light_iterations is not supported by the composed path "
            "(every iteration's deposit feeds the edep master)")
    if cfg.cbet_gain_stride != 1:
        raise ValueError(
            f"cbet_solve_composed samples gain at every step (the exact "
            f"lookup model); cbet_gain_stride={cfg.cbet_gain_stride} is the "
            "monolithic solver's window-strided approximation — use "
            "cbet_solve")


def cbet_fingerprint(cfg: Config, groups: int, device) -> str:
    """Everything that shapes the iteration map and the state layouts.
    ``cbet_max_iters`` and ``cbet_tol`` are normalized out: they bound and
    stop the outer loop only, and the non-convergence error below tells the
    user to raise ``cbet_max_iters`` and resume, which must not invalidate
    the checkpoint."""
    from ..utils.checkpoint import run_fingerprint
    cfg_n = cfg.replace(cbet_max_iters=1, cbet_tol=0.0)
    return run_fingerprint(cfg_n, device, f"cbet-g{groups}")


def default_beam_groups(cfg: Config) -> int:
    """The smallest divisor of ``nbeams`` whose full-resolution gain-row
    block stays under 1 GiB at 4 bytes a value
    (``cbet_composed.py:219-229``)."""
    P = cfg.nx * cfg.ny * cfg.nz
    for g in range(1, cfg.nbeams + 1):
        if cfg.nbeams % g:
            continue
        if (cfg.nbeams // g) * P * 4 <= 2 ** 30:
            return g
    return cfg.nbeams


def cbet_solve_composed(cfg: Config, ctx: rt.TraceContext, *,
                        device=None, beam_groups: int | None = None,
                        cache_dir: str | None = None,
                        checkpoint_path: str | None = None,
                        resume: bool = False, verbose: bool = True,
                        stop_after_iterations: int | None = None
                        ) -> CbetResult | None:
    """Resumable fixed-point CBET solve on ``device`` (default: the card,
    ``raytracer.default_device``; ``"cpu"`` for a CPU run); see the module
    docstring.

    ``checkpoint_path`` + ``resume``: the solve saves the blended intensity
    after every iteration and continues from the saved one.
    ``stop_after_iterations`` (tests, drills): checkpoint and return
    ``None`` after that many iterations executed in this invocation.  A
    resume at or beyond ``cbet_max_iters`` without convergence raises
    ``RuntimeError``: the last iteration's edep is only in the converged
    checkpoint.  ``beam_groups`` must divide ``nbeams`` (default:
    :func:`default_beam_groups`)."""
    from ..runner import check_memory
    from ..utils.checkpoint import load_cbet_checkpoint, save_cbet_checkpoint
    del cache_dir
    check_composed_config(cfg)
    device = torch.device(device) if device is not None \
        else rt.default_device()
    nb = cfg.nbeams
    G = beam_groups or default_beam_groups(cfg)
    if G < 1 or nb % G:
        raise ValueError(f"beam_groups={G} does not divide nbeams={nb}")
    if resume and not checkpoint_path:
        raise ValueError("resume requires checkpoint_path")
    nb_g = nb // G
    hx, hy, hz = cfg.cbet_grid_shape
    P = cfg.nx * cfg.ny * cfg.nz
    dtype = getattr(torch, cfg.dtype)
    master_dtype = getattr(torch, cfg.edep_dtype)
    check_memory(cfg, device, with_cbet=True, beam_groups=G, trace=False)
    fingerprint = cbet_fingerprint(cfg, G, device)

    cfg_t = cfg.replace(cbet_segmented=True)
    ops = resolve_cbet_ops(cfg_t, device)
    state0, bid, tpg = solver_state(cfg_t, ctx, device)
    field4 = ctx.field4.to(device)
    rows_g = state0.n // G            # a group's rows: beam-contiguous blocks
    trace = make_cbet_trace_fn(cfg_t, ctx, tiles_per_group=tpg, ops=ops,
                               n_beams=nb_g)
    gain_fn = make_gain_fn(cfg_t, ctx, device, ops.gain)
    upsample = (make_gain_upsampler(cfg_t, device)
                if cfg.cbet_grid_downsample > 1 else (lambda g: g))
    widths: list = []
    trace_steps: list = []    # per trace of this call, summed over the groups

    def run_iteration(gain_h):
        """One gain-coupled trace over all groups; ``gain_h`` is the coarse
        (B, Ph) gain, or None for zero gain.  Returns the (B, Ph)
        intensity, the edep master and the final uray / alive."""
        master = torch.zeros(cfg.edep_shape, dtype=master_dtype,
                             device=device)
        inten, uray, alive = [], [], []
        oflow = steps = 0
        for g in range(G):
            if gain_h is None:
                gain_rows = torch.zeros((nb_g, P), dtype=dtype, device=device)
            else:
                gain_rows = upsample(gain_h[g * nb_g:(g + 1) * nb_g]
                                     ).to(dtype)
            lo, hi = g * rows_g, (g + 1) * rows_g
            state_g = state0.map(lambda a: a[lo:hi])
            widths.clear()
            # beam ids from the group's first beam (dead padding slots
            # carry beam 0: clamped, never read as a live ray's)
            bid_g = (bid[lo:hi] - g * nb_g).clamp_(min=0)
            edep, inodes, st, of, n_steps = trace(field4, gain_rows, bid_g,
                                                  state_g, widths)
            master += edep
            oflow += int(of)
            steps += n_steps
            inten.append(inodes)
            uray.append(st.uray)
            alive.append(st.alive)
            del gain_rows, edep, st
        rt.check_overflow(oflow, cfg)
        trace_steps.append(steps)
        _sync(device)
        return (torch.cat(inten) if G > 1 else inten[0], master,
                (torch.cat(uray), torch.cat(alive)))

    history: list = []
    start_it = 0
    intensity = master = acct = None
    edep_h = acct_saved = None
    converged = False
    if resume:
        start_it, intensity, history, edep_h, acct_saved = \
            load_cbet_checkpoint(checkpoint_path, fingerprint, device)
        converged = edep_h is not None
        if verbose:
            print(f"cbet composed: resumed after iteration {start_it}"
                  + (" (converged)" if converged else ""), file=sys.stderr)

    def save(it, edep=None, accounting=None):
        if checkpoint_path:
            save_cbet_checkpoint(checkpoint_path, fingerprint, it, intensity,
                                 history, edep=edep, accounting=accounting)

    def accounting():
        uray, alive = acct
        final = dataclasses.replace(state0, uray=uray, alive=alive)
        return rt.trace_stats(ctx, final, state0)

    it = start_it
    executed = 0
    iter_seconds: list = []
    t_all0 = time.perf_counter()
    if intensity is None:
        # iteration 0, the zero-gain trace, always runs on a fresh solve
        t0 = time.perf_counter()
        intensity, master, acct = run_iteration(None)
        iter_seconds.append(round(time.perf_counter() - t0, 3))
        executed += 1
        if verbose:
            print(f"cbet composed iter 0 (zero gain): "
                  f"{iter_seconds[-1]:.1f}s", file=sys.stderr)
        save(0)
        if stop_after_iterations and executed >= stop_after_iterations:
            return None

    relax = float(cfg.cbet_relax)
    while not converged and it < cfg.cbet_max_iters:
        it += 1
        t0 = time.perf_counter()
        gain_h = gain_fn(intensity.to(torch.float32))
        master = acct = None     # release the iteration before
        i_new, master, acct = run_iteration(gain_h)
        d_dev, s_dev, blended = _step_update(i_new, intensity, relax)
        delta = float(d_dev) / max(float(s_dev), 1e-300)
        history.append(delta)
        iter_seconds.append(round(time.perf_counter() - t0, 3))
        if verbose:
            print(f"cbet composed iter {it}: rel delta {delta:.3e} "
                  f"[{iter_seconds[-1]:.1f}s]", file=sys.stderr)
        if delta < cfg.cbet_tol:
            intensity = i_new
            converged = True
            edep_h = master.to("cpu", torch.float64).numpy()
            acct_saved = accounting()
            save(it, edep=edep_h, accounting=acct_saved)
            break
        intensity = blended
        executed += 1
        save(it)
        if stop_after_iterations and executed >= stop_after_iterations:
            return None

    if edep_h is None:
        if master is None:
            # resumed at or past max_iters without convergence: only the
            # converged checkpoint carries an edep
            raise RuntimeError(
                f"resumed at iteration {start_it} >= cbet_max_iters="
                f"{cfg.cbet_max_iters} without convergence — raise "
                "cbet_max_iters to continue the fixed point")
        edep_h = master.to("cpu", torch.float64).numpy()
        acct_saved = accounting()
    inten_h = intensity.to("cpu", torch.float64).numpy().reshape(
        nb, hx, hy, hz)
    _, n_chunks, _ = rt.chunk_lengths(cfg)
    stats: dict[str, Any] = {
        "intensity_mode": "grouped_composed",
        "gain_mode": "lookup",
        "segmented": True,
        "beam_groups": G,
        "edep_total": float(edep_h.sum()),
        "iter_seconds": iter_seconds,
        "wall_seconds": round(time.perf_counter() - t_all0, 1),
        "chunks_per_iteration": int(n_chunks * G),
        "trace_steps": trace_steps,
        # the last group's tile widths of the last trace (empty when the
        # result came from the converged checkpoint)
        "tile_widths": list(widths),
        "device": str(device),
    }
    stats.update({k: acct_saved[k] for k in ACCOUNTING_KEYS
                  if k in acct_saved})
    return CbetResult(edep=edep_h, intensity=inten_h, iterations=it,
                      converged=converged, history=history, stats=stats)
