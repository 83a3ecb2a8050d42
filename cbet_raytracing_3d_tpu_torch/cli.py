"""Command-line interface of the PyTorch port.

Counterpart of the ``run`` and ``dump`` subcommands of
``cbet_raytracing_3d_tpu/cli.py``.  Every config field is a flag:

* ``run``  — full simulation (the plain trace; with ``--cbet`` also the CBET
              fixed-point solve), outputs to ``--out-dir``; by default
              (``--cache-dir .cbet_cache``) both are compacted mid-trace,
              as the JAX CLI runs them; ``--cache-dir ''`` does not
* ``dump`` — reference-compatible -D PRINT text dump to stdout
              (Makefile:14-17 golden-test replacement)

Both run on the card; without one they stop unless ``--device cpu`` is
given (``--device`` overrides).

Usage examples::

    python -m cbet_raytracing_3d_tpu_torch.cli run --out-dir out \\
        --formats npz,json
    python -m cbet_raytracing_3d_tpu_torch.cli run --cbet --out-dir out
    python -m cbet_raytracing_3d_tpu_torch.cli run --cbet \\
        --cbet-gain-mode kernel --cbet-light-iterations true
    python -m cbet_raytracing_3d_tpu_torch.cli run --cbet \\
        --cbet-accel anderson --cbet-gain-stride 5
    python -m cbet_raytracing_3d_tpu_torch.cli dump --nbeams 1 > edep.txt
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import typing

from .config import Config
from .runner import default_device, run, write_outputs
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

    p_dump = sub.add_parser("dump", help="-D PRINT compatible dump to stdout")
    _add_config_flags(p_dump)

    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    if args.device is None:
        try:
            args.device = default_device()
        except RuntimeError as e:
            parser.error(str(e))

    if args.cmd == "run":
        res = run(cfg, with_cbet=args.cbet, device=args.device,
                  verbose=not args.quiet, cache_dir=args.cache_dir or None)
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

    return 1


if __name__ == "__main__":
    raise SystemExit(main())
