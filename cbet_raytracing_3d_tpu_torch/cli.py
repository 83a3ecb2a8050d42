"""Command-line interface of the PyTorch port.

Counterpart of ``cbet_raytracing_3d_tpu/cli.py``.  Every config field is a
flag:

* ``run``  — full simulation (the plain trace; with ``--cbet`` also the CBET
              fixed-point solve), outputs to ``--out-dir``; by default
              (``--cache-dir .cbet_cache``) both are compacted mid-trace,
              as the JAX CLI runs them; ``--cache-dir ''`` does not
              ``--composed`` (implied by ``--checkpoint``, ``--resume``,
              ``--cbet-checkpoint`` and ``--cbet-only``) runs the resumable
              forms, ``runner.run_composed`` and, with ``--cbet``,
              ``models.cbet_composed.cbet_solve_composed``; their
              checkpoints are the port's own format, not the JAX package's
              ``--profile-dir DIR`` records the Tracing phase with
              ``torch.profiler`` into DIR.  Under ``torchrun`` (``WORLD_SIZE``
              set) every rank joins one process group and ``runner.run``
              shards the trace and the CBET solve over the ranks; rank 0
              writes and prints.  ``--dist-backend`` is NCCL by default on
              the card (one card per rank, ``cuda:$LOCAL_RANK``) and gloo
              with ``--device cpu``; ``--device cuda:0 --dist-backend gloo``
              lets several ranks share one card.  NCCL refuses two ranks on
              one device, before the group forms
* ``dump`` — reference-compatible -D PRINT text dump to stdout
              (Makefile:14-17 golden-test replacement)
* ``track`` — per-step trajectories of selected rays (``--pairs
              beam:ray,...``, ``--out`` npz; models/tracker.py), a JSON
              summary on stdout; exit 2 on malformed or out-of-range pairs

All run on the card; without one they stop unless ``--device cpu`` is
given (``--device`` overrides).

Usage examples::

    python -m cbet_raytracing_3d_tpu_torch.cli run --out-dir out \\
        --formats npz,json
    python -m cbet_raytracing_3d_tpu_torch.cli run --cbet --out-dir out
    python -m cbet_raytracing_3d_tpu_torch.cli run --cbet \\
        --cbet-gain-mode kernel --cbet-light-iterations true
    python -m cbet_raytracing_3d_tpu_torch.cli run --cbet \\
        --cbet-accel anderson --cbet-gain-stride 5
    python -m cbet_raytracing_3d_tpu_torch.cli run --composed --cbet \\
        --checkpoint out/trace.ckpt.npz --cbet-checkpoint out/cbet.ckpt.npz
    python -m cbet_raytracing_3d_tpu_torch.cli run --cbet --resume \\
        --checkpoint out/trace.ckpt.npz --cbet-checkpoint out/cbet.ckpt.npz
    python -m cbet_raytracing_3d_tpu_torch.cli dump --nbeams 1 > edep.txt
    torchrun --nproc-per-node 4 -m cbet_raytracing_3d_tpu_torch.cli run \
        --cbet --cbet-gain-mode kernel_cell
    torchrun --nproc-per-node 2 -m cbet_raytracing_3d_tpu_torch.cli run \
        --device cuda:0 --dist-backend gloo
    python -m cbet_raytracing_3d_tpu_torch.cli run --profile-dir out/prof
    python -m cbet_raytracing_3d_tpu_torch.cli track --pairs 0:9800,17:4321 \
        --out out/trajectories.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import typing

import torch

from .config import Config
from .runner import (RunResult, default_device, run, run_composed,
                     write_outputs)
from .utils.output import dump_print_format


def _parse_bool(s: str) -> bool:
    """Strict bool parse: an unrecognized value must ERROR, not silently
    become False."""
    v = s.lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(
        f"expected a boolean (true/false/1/0/yes/no/on/off), got {s!r}")


def _parse_bool_or_none(s: str) -> bool | None:
    """Tri-state for ``bool | None`` config fields: 'none'/'auto' keep
    None, everything else parses strictly as a bool."""
    if s.lower() in ("none", "auto"):
        return None
    return _parse_bool(s)


def _add_config_flags(p: argparse.ArgumentParser) -> None:
    hints = typing.get_type_hints(Config)
    for f in dataclasses.fields(Config):
        name = "--" + f.name.replace("_", "-")
        hint = hints.get(f.name)
        choices = (typing.get_args(hint)
                   if typing.get_origin(hint) is typing.Literal else None)
        if hint == typing.Optional[bool]:
            p.add_argument(name, type=_parse_bool_or_none,
                           default=f.default, metavar="BOOL|none")
        elif isinstance(f.default, bool):
            p.add_argument(name, type=_parse_bool,
                           default=f.default, metavar="BOOL")
        elif isinstance(f.default, int):
            p.add_argument(name, type=int, default=f.default)
        elif isinstance(f.default, float):
            p.add_argument(name, type=float, default=f.default)
        else:
            # Literal-typed fields reject unknown values at parse time
            p.add_argument(name, type=str, default=f.default,
                           choices=choices)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; without a card the "
                        "run stops unless --device cpu is given)")


def config_from_args(args: argparse.Namespace) -> Config:
    kw = {f.name: getattr(args, f.name) for f in dataclasses.fields(Config)}
    return Config(**kw)


def _run_composed(cfg: Config, args: argparse.Namespace) -> RunResult:
    """The composed flow of the JAX CLI (cli.py:177-220): the resumable
    trace unless ``--cbet-only``, then the resumable CBET solve on the
    trace's own prepared scene.  (The port donates no buffers, so that
    reuse is sound here.)"""
    from .models import raytracer as rt
    from .models.cbet_composed import cbet_solve_composed
    device = torch.device(args.device)
    res = None
    if not (args.cbet and args.cbet_only):
        res = run_composed(
            cfg, min_tiles=args.min_tiles, device=device,
            cache_dir=args.cache_dir or None,
            checkpoint_path=args.checkpoint,
            resume=bool(args.resume and args.checkpoint),
            verbose=not args.quiet)
    if not args.cbet:
        return res
    if res is not None and res.ctx is not None:
        ctx = res.ctx
    else:
        ctx = (rt.prepare_device(cfg, device=device)
               if device.type == "cuda" else rt.prepare(cfg))
    cres = cbet_solve_composed(
        cfg, ctx, device=device, beam_groups=args.beam_groups,
        cache_dir=args.cache_dir or None,
        checkpoint_path=args.cbet_checkpoint,
        resume=bool(args.resume and args.cbet_checkpoint),
        verbose=not args.quiet)
    if res is None:
        # --cbet-only: the coupled grid doubles as the primary output
        return RunResult(cfg=cfg, edep=cres.edep, stats=dict(cres.stats),
                         timings={}, cbet=cres)
    return dataclasses.replace(res, cbet=cres)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="cbet-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="full simulation")
    _add_config_flags(p_run)
    p_run.add_argument("--out-dir", default="out")
    p_run.add_argument("--formats", default="npz,json",
                       help="comma list: npz,hdf5,txt,json")
    p_run.add_argument("--cbet", action="store_true",
                       help="also run the CBET fixed-point solve")
    p_run.add_argument("--quiet", action="store_true")
    p_run.add_argument("--cache-dir", default=".cbet_cache",
                       help="as in the JAX CLI: with a directory ('' "
                            "disables) the trace and the CBET solve drop "
                            "dead tiles mid-trace; the port writes nothing "
                            "there")

    p_run.add_argument("--composed", action="store_true",
                       help="the resumable large-scale run "
                            "(runner.run_composed: the compacted trace with "
                            "chunk-boundary checkpoints); with --cbet the "
                            "CBET stage is the resumable composed solve "
                            "(models.cbet_composed)")
    p_run.add_argument("--checkpoint", default=None, metavar="PATH",
                       help="composed-run checkpoint file (saved at "
                            "compaction boundaries; implies --composed)")
    p_run.add_argument("--resume", action="store_true",
                       help="resume a composed run from --checkpoint / "
                            "--cbet-checkpoint")
    p_run.add_argument("--min-tiles", type=int, default=0,
                       help="accepted as in the JAX CLI and inert: there "
                            "is no static plan whose segments it could "
                            "bound")
    p_run.add_argument("--cbet-checkpoint", default=None, metavar="PATH",
                       help="composed CBET: iteration-boundary checkpoint "
                            "file (the fixed-point intensity; resume with "
                            "--resume)")
    p_run.add_argument("--beam-groups", type=int, default=None,
                       help="composed CBET: trace the beams in this many "
                            "serial groups (device memory control; default "
                            "sizes the full-resolution gain rows of a "
                            "group under 1 GiB)")
    p_run.add_argument("--cbet-only", action="store_true",
                       help="composed --cbet: skip the plain composed trace "
                            "and run only the CBET stage")
    p_run.add_argument("--profile-dir", default=None, metavar="DIR",
                       help="record the Tracing phase with torch.profiler "
                            "and export it into DIR (trace_rank<r>.json)")
    p_run.add_argument("--dist-backend", default=None,
                       choices=("nccl", "gloo"),
                       help="under torchrun: the process group's backend "
                            "(default nccl on the card, gloo with --device "
                            "cpu; gloo lets ranks share one card)")

    p_dump = sub.add_parser("dump", help="-D PRINT compatible dump to stdout")
    _add_config_flags(p_dump)

    p_track = sub.add_parser(
        "track", help="record per-step trajectories of selected rays")
    _add_config_flags(p_track)
    p_track.add_argument(
        "--pairs", required=True,
        help="comma list of beam:ray thread ids, e.g. '0:9800,17:4321'")
    p_track.add_argument("--out", default="out/trajectories.npz",
                         help="npz output path")

    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    rank = 0
    if args.cmd == "run" and "WORLD_SIZE" in os.environ:
        from .parallel.multihost import join_torchrun_group
        try:
            rank, args.device = join_torchrun_group(args.device,
                                                    args.dist_backend)
        except ValueError as e:
            parser.error(str(e))
    if args.device is None:
        try:
            args.device = default_device()
        except RuntimeError as e:
            parser.error(str(e))

    if args.cmd == "run":
        # the JAX CLI's rules (cli.py:159-176)
        if args.cbet_only and not args.cbet:
            print("--cbet-only requires --cbet", file=sys.stderr)
            return 2
        if args.cbet_checkpoint and not args.cbet:
            # without the guard the flag (and --resume with it) would be
            # silently dropped: hours of unintended retracing at scale
            print("--cbet-checkpoint requires --cbet", file=sys.stderr)
            return 2
        composed = (args.composed or args.checkpoint or args.resume
                    or args.cbet_checkpoint or args.cbet_only)
        if composed and args.profile_dir:
            print("--profile-dir records runner.run's Tracing phase, not "
                  "the composed forms", file=sys.stderr)
            return 2
        if composed:
            if args.resume and not (args.checkpoint or args.cbet_checkpoint):
                print("--resume requires --checkpoint PATH (trace) and/or "
                      "--cbet-checkpoint PATH (CBET stage)", file=sys.stderr)
                return 2
            res = _run_composed(cfg, args)
        else:
            res = run(cfg, with_cbet=args.cbet, device=args.device,
                      verbose=not args.quiet,
                      cache_dir=args.cache_dir or None,
                      profile_dir=args.profile_dir)
        if rank != 0:
            return 0            # every rank holds the result; rank 0 writes
        paths = write_outputs(res, args.out_dir,
                              tuple(args.formats.split(",")))
        if not args.quiet:
            print(json.dumps(res.stats, indent=2))
            if res.cbet is not None:
                print(f"cbet: {res.cbet.iterations} iterations, converged="
                      f"{res.cbet.converged}, history "
                      f"{[round(h, 5) for h in res.cbet.history]}",
                      file=sys.stderr)
            for p in paths:
                print(f"wrote {p}", file=sys.stderr)
        return 0

    if args.cmd == "dump":
        res = run(cfg, device=args.device, verbose=False)
        sys.stdout.write(dump_print_format(res.edep))
        return 0

    if args.cmd == "track":
        return _track(cfg, args)

    return 1


def _track(cfg: Config, args: argparse.Namespace) -> int:
    """``cli track`` (JAX ``cli.py:238-268``): the JSON summary on stdout,
    exit 2 on malformed or out-of-range pairs."""
    from .models.tracker import track_rays
    try:
        pairs = [tuple(int(v) for v in p.split(":"))
                 for p in args.pairs.split(",")]
        if any(len(p) != 2 for p in pairs):
            raise ValueError
    except ValueError:
        print(f"--pairs: expected 'beam:ray,beam:ray,...', got "
              f"{args.pairs!r}", file=sys.stderr)
        return 2
    try:
        traj = track_rays(cfg, [p[0] for p in pairs], [p[1] for p in pairs],
                          device=args.device)
    except ValueError as e:     # out-of-range ids: the same clean exit
        print(f"--pairs: {e}", file=sys.stderr)
        return 2
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    traj.save_npz(args.out)
    print(json.dumps({
        "rays": traj.n,
        "launched": int(traj.launched.sum()),
        "steps": traj.steps.tolist(),
        "crossings": traj.crossing_counts().tolist(),
        "out": args.out,
    }, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
