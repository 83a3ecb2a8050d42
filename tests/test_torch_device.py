"""The port's entry points run on the card and never pick the CPU on their
own: without a CUDA device each raises (the CLI exits non-zero) with a
message that names ``device="cpu"``, and each still runs on the CPU when
the caller asks for it."""

import pytest
import torch

from cbet_raytracing_3d_tpu_torch import cli
from cbet_raytracing_3d_tpu_torch.config import Config
from cbet_raytracing_3d_tpu_torch.models import cbet
from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
from cbet_raytracing_3d_tpu_torch.models.cbet_composed import \
    cbet_solve_composed
from cbet_raytracing_3d_tpu_torch.runner import (run, run_composed,
                                                 run_resumable)

torch.set_num_threads(1)

TINY = dict(nbeams=2, rays_per_zone=1, nx=16, ny=16, nz=16,
            dtype="float64", cbet_max_iters=1)
TINY_FLAGS = ["--nbeams", "2", "--rays-per-zone", "1", "--nx", "16",
              "--ny", "16", "--nz", "16", "--dtype", "float64"]


def _cli(cmd, device, tmp_path, *more):
    argv = [cmd, *TINY_FLAGS, *more]
    if cmd == "run":
        argv += ["--out-dir", str(tmp_path), "--formats", "json", "--quiet"]
    if device is not None:
        argv += ["--device", device]
    return cli.main(argv)


ENTRY_POINTS = {
    "runner.run": lambda cfg, dev, tmp: run(cfg, device=dev, verbose=False),
    "cbet_solve": lambda cfg, dev, tmp: cbet.cbet_solve(cfg, rt.prepare(cfg),
                                                        dev),
    "prepare_device": lambda cfg, dev, tmp: rt.prepare_device(cfg,
                                                              device=dev),
    "raytracer.trace": lambda cfg, dev, tmp: rt.trace(rt.prepare(cfg), dev),
    "cli run": lambda cfg, dev, tmp: _cli("run", dev, tmp),
    "cli dump": lambda cfg, dev, tmp: _cli("dump", dev, tmp),
    "run_resumable": lambda cfg, dev, tmp: run_resumable(
        cfg, checkpoint_path=str(tmp / "c.npz"), device=dev, verbose=False),
    "run_composed": lambda cfg, dev, tmp: run_composed(cfg, device=dev,
                                                       verbose=False),
    "cbet_solve_composed": lambda cfg, dev, tmp: cbet_solve_composed(
        cfg, rt.prepare(cfg), device=dev, verbose=False),
    "cli run --composed": lambda cfg, dev, tmp: _cli("run", dev, tmp,
                                                     "--composed"),
}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_without_card_refuses(no_card, entry, tmp_path, capsys):
    """No device given and no card: a RuntimeError (the CLI: a usage error,
    exit code 2) that says how to ask for the CPU, before any work."""
    fn = ENTRY_POINTS[entry]
    if entry.startswith("cli"):
        with pytest.raises(SystemExit) as exc:
            fn(Config(**TINY), None, tmp_path)
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert '--device cpu' in err and 'device="cpu"' in err
        assert not list(tmp_path.iterdir())          # nothing written
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn(Config(**TINY), None, tmp_path)


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_cpu_when_asked(no_card, entry, tmp_path,
                                            capsys):
    """``device="cpu"`` (``--device cpu``) runs the same entry point on the
    CPU."""
    out = ENTRY_POINTS[entry](Config(**TINY), "cpu", tmp_path)
    if entry in ("run_resumable", "run_composed"):
        assert out.edep.shape == Config(**TINY).edep_shape
        assert out.stats["steps_executed"] > 0 and out.stats["chunks"] > 0
        if entry == "run_composed":
            assert out.stats["device"] == "cpu"
    elif entry == "cbet_solve_composed":
        assert out.iterations == 1 and out.stats["device"] == "cpu"
    elif entry == "runner.run":
        assert out.edep.shape == Config(**TINY).edep_shape
        assert out.stats["steps_executed"] > 0
    elif entry == "cbet_solve":
        assert out.iterations == 1 and out.stats["device"] == "cpu"
    elif entry == "prepare_device":
        assert out.state0.uray.device.type == "cpu" and out.compact
    elif entry == "raytracer.trace":
        edep, state = out
        assert edep.shape == Config(**TINY).edep_shape and edep.sum() > 0
        assert state.uray.device.type == "cpu"
    else:
        assert out == 0
        if entry.startswith("cli run"):
            assert any(p.suffix == ".json" for p in tmp_path.iterdir())
        else:
            assert capsys.readouterr().out.strip()
