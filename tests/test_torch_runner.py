"""The port's runner, outputs and CLI against the JAX package's, on a small
scene; and the rule that the port never imports jax or the JAX package."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from cbet_raytracing_3d_tpu import runner as jrunner
from cbet_raytracing_3d_tpu.config import Config as JConfig
from cbet_raytracing_3d_tpu.utils import output as joutput
from cbet_raytracing_3d_tpu_torch import cli
from cbet_raytracing_3d_tpu_torch.config import Config
from cbet_raytracing_3d_tpu_torch.profiles import DEFAULT_NE_FILE
from cbet_raytracing_3d_tpu_torch.runner import (check_memory,
                                                 estimate_device_bytes, run,
                                                 write_outputs)
from cbet_raytracing_3d_tpu_torch.utils import native, output
from cbet_raytracing_3d_tpu_torch.utils.timers import PhaseTimers

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "cbet_raytracing_3d_tpu_torch")
SMALL = dict(nbeams=2, rays_per_zone=1, nx=32, ny=32, nz=32, dtype="float64")
SMALL_FLAGS = ["--nbeams", "2", "--rays-per-zone", "1", "--nx", "32",
               "--ny", "32", "--nz", "32", "--dtype", "float64"]


@pytest.fixture(scope="module")
def port_run():
    return run(Config(**SMALL), device="cpu", verbose=False)


def test_run_matches_jax_run(port_run):
    """The whole slice: the port's run against the JAX package's run (no
    cache dir: the unsegmented trace over live tiles)."""
    want = jrunner.run(JConfig(**SMALL), verbose=False)
    got = port_run
    rel = (np.linalg.norm(got.edep - want.edep)
           / np.linalg.norm(want.edep))
    assert rel < 1e-12
    for key in ("rays_total", "rays_launched", "rays_alive_at_end",
                "rays_terminated"):
        assert got.stats[key] == want.stats[key], key
    for key in ("energy_launched", "energy_absorbed", "edep_total"):
        np.testing.assert_allclose(got.stats[key], want.stats[key],
                                   rtol=1e-12)
    np.testing.assert_allclose(got.stats["edep_total"],
                               got.stats["energy_absorbed"], rtol=1e-12)
    assert set(got.timings) >= {"Init", "Tracing", "Combining", "Total"}
    assert 0 < got.stats["steps_executed"] <= Config(**SMALL).nt


def test_write_outputs(port_run, tmp_path):
    fmts = ("npz", "json", "txt") + (("hdf5",) if output.HAVE_H5PY else ())
    paths = write_outputs(port_run, str(tmp_path), fmts)
    assert all(os.path.exists(p) for p in paths) and len(paths) == len(fmts)
    with np.load(tmp_path / "edep.npz") as z:
        assert np.array_equal(z["edep"], port_run.edep)
        # each package averages with its native library or, where that
        # failed to load, with NumPy; the two sum in another order
        np.testing.assert_allclose(
            z["edepavg"],
            joutput.edep_box_average(JConfig(**SMALL), port_run.edep),
            rtol=1e-14)
        assert int(z["stat_rays_launched"]) == port_run.stats["rays_launched"]
    meta = json.load(open(tmp_path / "edep.json"))
    assert meta["stats"] == port_run.stats
    assert (tmp_path / "edep.txt").read_text() == joutput.dump_print_format(
        port_run.edep)
    with pytest.raises(ValueError):
        write_outputs(port_run, str(tmp_path), ("csv",))


def test_dump_byte_identical_to_jax(rng):
    e = rng.uniform(-1e14, 1e14, size=(5, 4, 3))
    e[0, 0, 0] = 0.0
    assert output.dump_print_format(e) == joutput.dump_print_format(e)


def test_native_io_matches(rng, tmp_path, profiles):
    r, ne = native.parse_profile(DEFAULT_NE_FILE, 443)
    assert np.array_equal(r, profiles.r) and np.array_equal(ne, profiles.ne)
    e = rng.uniform(0, 1e14, size=(6, 5, 4))
    native.write_print_dump(str(tmp_path / "d.txt"), e)
    assert (tmp_path / "d.txt").read_text() == joutput.dump_print_format(e)
    cfg = JConfig(nx=9, ny=8, nz=7)
    g = rng.uniform(size=cfg.edep_shape)
    np.testing.assert_allclose(native.box_average27(g),
                               joutput.edep_box_average(cfg, g), rtol=1e-14)


def test_cli_run_and_dump(tmp_path, capsys, port_run):
    rc = cli.main(["run", *SMALL_FLAGS, "--device", "cpu", "--out-dir",
                   str(tmp_path), "--formats", "npz,json", "--quiet"])
    assert rc == 0
    with np.load(tmp_path / "edep.npz") as z:
        assert np.array_equal(z["edep"], port_run.edep)
    assert os.path.exists(tmp_path / "edep.json")
    capsys.readouterr()
    assert cli.main(["dump", *SMALL_FLAGS, "--device", "cpu"]) == 0
    assert capsys.readouterr().out == joutput.dump_print_format(port_run.edep)


def test_cli_run_cache_dir_takes_the_compacted_path(tmp_path, port_run):
    """As the JAX CLI: ``cli run`` passes ``--cache-dir .cbet_cache`` by
    default and then compacts the trace mid-trace (``stats["segmented"]``);
    ``--cache-dir ''`` does not; the grids are equal bit for bit and the
    port writes no cache."""
    grids = {}
    for tag, extra in (("default", []), ("off", ["--cache-dir", ""])):
        out = tmp_path / tag
        rc = cli.main(["run", *SMALL_FLAGS, "--device", "cpu", "--out-dir",
                       str(out), "--formats", "npz,json", "--quiet",
                       *extra])
        assert rc == 0
        stats = json.load(open(out / "edep.json"))["stats"]
        assert stats["segmented"] == (tag == "default")
        assert bool(stats["tile_widths"]) == (tag == "default")
        with np.load(out / "edep.npz") as z:
            grids[tag] = z["edep"]
    assert np.array_equal(grids["default"], grids["off"])
    assert np.array_equal(grids["off"], port_run.edep)
    assert not os.path.exists(".cbet_cache/") or not os.listdir(".cbet_cache")


@pytest.mark.parametrize("argv", [
    ["run", "--checkpoint"], ["run", "--beam-groups", "some"],
    ["run", "--min-tiles", "many"], ["run", "--cbet-checkpoint"],
    ["track"],
    ["run", "--profile-dir", "p"], ["track", "--pairs", "0:1"],
    ["run", "--deposit-backend", "pallas"], ["run", "--parity", "Reference"],
])
def test_cli_rejects_later_slices_and_bad_values(argv, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2


def test_phase_timers_and_memory_preflight():
    t = PhaseTimers("cpu")
    with t.phase("Init"):
        pass
    with t.phase("Tracing"):
        pass
    rep = t.report()
    assert "rt: Init" in rep and "rt: Tracing" in rep and "Total" in rep
    assert set(t.as_dict()) >= {"Init", "Tracing", "Total"}
    check_memory(Config(), "cpu")         # no card: nothing to check
    # OMEGA: ~1.23M traced slots x ~490 bytes + tables + grids
    assert 2e8 < estimate_device_bytes(Config()) < 1e9


def test_memory_estimate_covers_the_trace_measured_on_the_card():
    """The trace's terms: the traced slots (live tiles, block-padded), the
    window's seven (batch, N) rows, and no less than the peaks that
    ``scripts/peak_memory.py`` read on an NVIDIA H100 80GB HBM3 (OMEGA f32
    585,352,704 bytes, f64 983,540,736; BASELINE config 4 f32
    26,153,766,912)."""
    from cbet_raytracing_3d_tpu_torch import runner
    cfg = Config()
    n = runner.traced_slots(cfg)
    assert n == 4800 * 256
    est = estimate_device_bytes(cfg)
    assert estimate_device_bytes(cfg.replace(deposit_batch_steps=25)) - est \
        == 20 * 28 * n
    assert est >= 585352704
    assert estimate_device_bytes(cfg.replace(dtype="float64")) >= 983540736
    c4 = Config(nx=200, ny=200, nz=200, rays_per_zone=15, tile_zones=2,
                deposit_box_x=24, deposit_box_y=24, deposit_box_z=24)
    assert runner.traced_slots(c4) == 60480 * 900
    assert 26153766912 <= estimate_device_bytes(c4) < 1.1 * 26153766912
    # the CBET stage alone never needs more than the run with it
    for g in (1, 4):
        alone = estimate_device_bytes(c4, True, g, trace=False)
        assert alone <= estimate_device_bytes(c4, True, g)


def test_package_never_imports_jax_statically():
    pat = re.compile(r"^\s*(from|import)\s+(jax|cbet_raytracing_3d_tpu)\b"
                     r"(?!_torch)", re.M)
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                assert not pat.search(src), os.path.join(root, f)


def test_import_and_run_leave_jax_unloaded(tmp_path):
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import cbet_raytracing_3d_tpu_torch as p\n"
        "from cbet_raytracing_3d_tpu_torch import cli, convert\n"
        "from cbet_raytracing_3d_tpu_torch.runner import run\n"
        "r = run(p.Config(nbeams=1, rays_per_zone=1, nx=20, ny=20, nz=20),"
        " device='cpu', verbose=False)\n"
        "assert r.stats['edep_total'] > 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'cbet_raytracing_3d_tpu'"
        " or m.startswith('cbet_raytracing_3d_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"
