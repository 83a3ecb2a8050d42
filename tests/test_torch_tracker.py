"""The port's ray tracker (``models/tracker.py``) against the JAX package's
``track_rays`` and the float64 oracle's recorded paths
(``oracle.trace_ray(record_path=True)``) on the pairs of
``tests/test_tracker.py``; the JAX tests' cases for the port; ``cli track``
as a subprocess (its JSON and exit codes) and ``cli run --profile-dir``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cbet_raytracing_3d_tpu.beams import load_beam_norms, power_table
from cbet_raytracing_3d_tpu.config import Config as JConfig
from cbet_raytracing_3d_tpu.models import raytracer as jrt
from cbet_raytracing_3d_tpu.models.tracker import RayTrajectories as JTraj
from cbet_raytracing_3d_tpu.models.tracker import track_rays as jtrack
from cbet_raytracing_3d_tpu.oracle import trace_ray
from cbet_raytracing_3d_tpu_torch import cli
from cbet_raytracing_3d_tpu_torch.config import Config
from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
from cbet_raytracing_3d_tpu_torch.models.tracker import (RayTrajectories,
                                                         track_rays)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_tracker.py: a pupil-center ray, an oblique one, and a
# pupil-rejected thread id (the launch lattice's corner)
BEAMS = [0, 17, 3]
RAYS = [9800, 4321, 0]


@pytest.fixture(scope="module")
def ctx64():
    return rt.prepare(Config(dtype="float64"))


@pytest.fixture(scope="module")
def traj(ctx64):
    return track_rays(ctx64.cfg, BEAMS, RAYS, ctx=ctx64, device="cpu")


@pytest.fixture(scope="module")
def jtraj(profiles):
    jcfg = JConfig(dtype="float64")
    return jtrack(jcfg, BEAMS, RAYS, ctx=jrt.prepare(jcfg, profiles))


def _oracle_path(cfg, profiles, beam, ray):
    jcfg = JConfig(dtype="float64")
    edep = np.zeros((cfg.nx + 2, cfg.ny + 2, cfg.nz + 2))
    return trace_ray(jcfg, profiles, load_beam_norms(nbeams=cfg.nbeams),
                     power_table(jcfg),
                     np.linspace(0.0, cfg.pow_table_max, cfg.pow_table_len),
                     beam, ray, edep, record_path=True)


def test_matches_jax_track(traj, jtraj):
    """Every recorded step: the same cells and mask, positions and energies
    within 1e-12 relative."""
    assert np.array_equal(traj.recorded, jtraj.recorded)
    assert np.array_equal(traj.steps, jtraj.steps)
    assert np.array_equal(traj.launched, jtraj.launched)
    m = traj.recorded
    assert m.sum() > 100
    assert np.array_equal(traj.cell[m], jtraj.cell[m])
    np.testing.assert_allclose(traj.pos[m], jtraj.pos[m], rtol=1e-12)
    np.testing.assert_allclose(traj.uray[m], jtraj.uray[m], rtol=1e-12)
    np.testing.assert_allclose(traj.uray_init, jtraj.uray_init, rtol=1e-12)
    assert np.array_equal(traj.crossing_counts(), jtraj.crossing_counts())


def test_paths_match_oracle(ctx64, traj, profiles):
    for i, (b, r) in enumerate(zip(BEAMS, RAYS)):
        ref = _oracle_path(ctx64.cfg, profiles, b, r)
        got = traj.path(i)
        assert len(got) == len(ref), (b, r)
        for t, (g, o) in enumerate(zip(got, ref)):
            assert g[:3] == o[:3], (b, r, t)          # cells exact
            np.testing.assert_allclose(g[3:6], o[3:6], rtol=1e-12, atol=0)
            np.testing.assert_allclose(g[6], o[6], rtol=1e-12)


def test_pupil_rejected_ray_records_nothing(traj):
    i = RAYS.index(0)
    assert not traj.launched[i] and traj.steps[i] == 0
    assert traj.path(i) == []
    steps, cells = traj.crossings(i)
    assert steps.shape == (0,) and cells.shape == (0, 3)


def test_crossings_bounded_and_adjacent(ctx64, traj):
    counts = traj.crossing_counts()
    assert counts[traj.launched].min() >= 1
    # def.cuh:96 sizes the crossing store at ncrossings = 3 nx per ray
    assert counts.max() <= ctx64.cfg.ncrossings
    for i in range(traj.n):
        steps, cells = traj.crossings(i)
        if cells.shape[0] < 2:
            continue
        assert np.abs(np.diff(cells, axis=0)).max() <= 1
        assert (np.diff(steps) >= 1).all()


def test_energy_monotone_and_terminal(ctx64, traj):
    cfg = ctx64.cfg
    for i in range(traj.n):
        p = traj.path(i)
        if not p:
            continue
        u = np.array([e[6] for e in p])
        assert (np.diff(u) <= 0).all()            # absorption only drains
        if traj.steps[i] < cfg.nt:                # ended in the box or < 5 %
            x, y, z = p[-1][3:6]
            out = (u[-1] <= cfg.stop_fraction * traj.uray_init[i]
                   or x < cfg.xmin - cfg.dx / 2 or x > cfg.xmax + cfg.dx / 2
                   or y < cfg.ymin - cfg.dy / 2 or y > cfg.ymax + cfg.dy / 2
                   or z < cfg.zmin - cfg.dz / 2 or z > cfg.zmax + cfg.dz / 2)
            assert out, i


def test_npz_roundtrip(tmp_path, traj):
    """The port's file loads back, and the JAX class reads it too (the same
    fields)."""
    f = str(tmp_path / "traj.npz")
    traj.save_npz(f)
    for cls in (RayTrajectories, JTraj):
        back = cls.load_npz(f)
        np.testing.assert_array_equal(back.cell, traj.cell)
        np.testing.assert_array_equal(back.recorded, traj.recorded)
        np.testing.assert_array_equal(back.uray, traj.uray)


def test_rejects_bad_ids(ctx64):
    cfg = ctx64.cfg
    for beams, rays in (([0], [cfg.nrays]), ([cfg.nbeams], [0]),
                        ([0, 1], [0])):
        with pytest.raises(ValueError):
            track_rays(cfg, beams, rays, ctx=ctx64, device="cpu")


def test_rejects_mismatched_cfg(ctx64):
    with pytest.raises(ValueError, match="ctx.cfg"):
        track_rays(ctx64.cfg.replace(rays_per_zone=2), [0], [0], ctx=ctx64,
                   device="cpu")


def test_slots_of_rays_matches_slot_of(ctx64):
    """The closed form against the layout's ``slot_of`` map and the JAX
    package's ``slots_of_rays``."""
    cfg = ctx64.cfg
    rng = np.random.default_rng(7)
    beams = rng.integers(0, cfg.nbeams, 200).astype(np.int64)
    rays = rng.integers(0, cfg.nrays, 200).astype(np.int64)
    gtile, rit = rt.slots_of_rays(cfg, beams, rays)
    np.testing.assert_array_equal(gtile * ctx64.layout.rays_per_tile + rit,
                                  ctx64.layout.slot_of[beams, rays])
    jg, jr = jrt.slots_of_rays(JConfig(dtype="float64"), beams, rays)
    assert np.array_equal(gtile, jg) and np.array_equal(rit, jr)


def test_compact_context_matches_host(ctx64, traj):
    """A compact (``prepare_device``) context maps the global tiles through
    the traced tile order: the host context's trajectories."""
    dev = track_rays(ctx64.cfg, BEAMS, RAYS,
                     ctx=rt.prepare_device(ctx64.cfg, device="cpu"),
                     device="cpu")
    for name in ("launched", "steps", "recorded"):
        assert np.array_equal(getattr(dev, name), getattr(traj, name)), name
    m = traj.recorded
    assert np.array_equal(dev.cell[m], traj.cell[m])
    np.testing.assert_allclose(dev.pos[m], traj.pos[m], rtol=0, atol=1e-12)
    np.testing.assert_allclose(dev.uray[m], traj.uray[m], rtol=1e-12)


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "cbet_raytracing_3d_tpu_torch.cli", *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)


def test_cli_track(tmp_path):
    """``cli track`` as a subprocess: the JSON summary, the npz, and exit
    2 (one line, no traceback) on malformed and out-of-range pairs."""
    small = ["--nbeams", "2", "--rays-per-zone", "2", "--nx", "32", "--ny",
             "32", "--nz", "32", "--device", "cpu"]
    out_npz = str(tmp_path / "traj.npz")
    out = _cli("track", *small, "--pairs", "0:242,1:243", "--out", out_npz)
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout)
    assert summary["rays"] == 2 and summary["out"] == out_npz
    back = RayTrajectories.load_npz(out_npz)
    assert back.n == 2 and (back.steps == np.array(summary["steps"])).all()
    assert summary["crossings"] == back.crossing_counts().tolist()
    want = track_rays(Config(nbeams=2, rays_per_zone=2, nx=32, ny=32, nz=32),
                      [0, 1], [242, 243], device="cpu")
    assert np.array_equal(back.cell, want.cell)
    for pairs, msg in (("0-3", "beam:ray"), ("99:0", "out of range")):
        bad = _cli("track", *small, "--pairs", pairs)
        assert bad.returncode == 2 and msg in bad.stderr, bad.stderr
        assert "Traceback" not in bad.stderr


def test_cli_run_profile_dir(tmp_path):
    """``cli run --profile-dir``: a torch.profiler trace of the Tracing
    phase, exported as Chrome trace JSON into the directory."""
    prof = tmp_path / "prof"
    rc = cli.main(["run", "--nbeams", "1", "--rays-per-zone", "1", "--nx",
                   "20", "--ny", "20", "--nz", "20", "--device", "cpu",
                   "--out-dir", str(tmp_path / "out"), "--formats", "json",
                   "--quiet", "--profile-dir", str(prof)])
    assert rc == 0
    trace = json.load(open(prof / "trace_rank0.json"))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert (tmp_path / "out" / "edep.json").exists()
