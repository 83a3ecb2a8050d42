"""The port's multi-rank trace (``parallel/sharding.py``, ``runner.run`` on
a process group) against the JAX package's ``make_sharded_trace_fn`` on as
many virtual CPU devices (conftest provides 8) and against the port's
single-rank trace, in float64: the ray subset of ``tests/test_sharding.py``
(64 slots spread over beams and pupil), ``pad_rays`` padding, and a whole
small scene plain and compacted per rank, with its ``trace_stats``.

The ranks are spawned once per world size (gloo, ``file://`` rendezvous:
``multihost.spawn_ranks``) and each runs every check's trace; the
comparisons run here."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from cbet_raytracing_3d_tpu.config import Config as JConfig
from cbet_raytracing_3d_tpu.models import raytracer as jrt
from cbet_raytracing_3d_tpu.parallel import sharding as jsh
from cbet_raytracing_3d_tpu_torch import cli
from cbet_raytracing_3d_tpu_torch.config import Config
from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
from cbet_raytracing_3d_tpu_torch.parallel import dryrun
from cbet_raytracing_3d_tpu_torch.parallel import multihost as mh
from cbet_raytracing_3d_tpu_torch.parallel import sharding as sh
from cbet_raytracing_3d_tpu_torch.runner import run, run_resumable

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_sharding.py::small_ctx and :113
SUBSET = dict(dtype="float64")
SCENE = dict(nbeams=4, rays_per_zone=1, nx=40, ny=40, nz=40,
             dtype="float64", tiles_per_block=1, chunk_steps=10)
WORLDS = (2, 4)


def _close(got, want, tol):
    """rel-L2 <= tol; an all-zero ``want`` must be matched exactly."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) <= tol * np.linalg.norm(want)


def _subset_idx(n_slots, n):
    """tests/test_sharding.py::_subset: slots spread over beams and pupil."""
    return np.linspace(0, n_slots - 1, n).astype(np.int64)


def _rank(rank, world):
    """One rank's share of every check; NumPy results for the parent."""
    torch.set_num_threads(1)
    mesh = sh.make_mesh()
    out = {"world": mesh.world, "rank": mesh.rank, "backend": mesh.backend}
    cfg = Config(**SUBSET)
    ctx = rt.prepare(cfg)
    fn = sh.make_sharded_trace_fn(cfg, mesh)
    for n in (64, 61):
        sub = rt.select_rays(ctx.state0, _subset_idx(ctx.layout.n_slots, n))
        local = sh.local_state(sub, mesh, 8)
        edep, _, oflow, steps, mine = fn(ctx.field4, local)
        out[f"subset{n}"] = (edep.numpy(), oflow, steps, mine["steps"],
                             local.n, int(local.alive.sum()))
    scene = Config(**SCENE)
    for tag, cache in (("plain", None), ("compacted", "unused")):
        r = run(scene, device="cpu", verbose=False, cache_dir=cache)
        out[tag] = (r.edep, r.stats)
    out["run_sharded"] = sh.run_sharded(rt.prepare(scene), device="cpu",
                                        compact=True)[0]
    # the collectives: uneven row blocks, a rank with none
    counts = [r + 1 if r < world - 1 else 0 for r in range(world)]
    rows = torch.full((counts[rank], 3), float(rank), dtype=torch.float64)
    out["gathered"] = sh.all_gather_rows(rows, mesh, counts).numpy()
    out["rank_rows"] = sh.rank_rows(list(range(rank + 1)), mesh)
    try:
        run_resumable(scene, checkpoint_path="unused.npz", device="cpu")
    except ValueError as e:
        out["resumable"] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks():
    return {w: mh.spawn_ranks(_rank, w, timeout=300) for w in WORLDS}


@pytest.fixture(scope="module")
def single():
    """The port's single-rank results of the same traces."""
    cfg = Config(**SUBSET)
    ctx = rt.prepare(cfg)
    out = {}
    for n in (64, 61):
        sub = rt.select_rays(ctx.state0, _subset_idx(ctx.layout.n_slots, n))
        edep, _, oflow, steps = rt.make_trace_fn(cfg)(ctx.field4, sub)
        out[f"subset{n}"] = (edep.numpy(), int(oflow), steps)
    scene = Config(**SCENE)
    out["plain"] = run(scene, device="cpu", verbose=False)
    return out


def _jax_sharded(jcfg, jctx, state0, world):
    mesh = jsh.make_mesh(jax.devices()[:world])
    fn = jsh.make_sharded_trace_fn(jcfg, mesh, jctx.layout.rays_per_tile)
    edep, _, oflow = fn(jctx.field4, state0)
    assert int(oflow) == 0
    return np.asarray(edep)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("n", [64, 61])
def test_subset_matches_jax_sharded(ranks, single, world, n):
    """tests/test_sharding.py::test_sharded_matches_single_device and
    ::test_pad_rays_are_inert: the ray subset on ``world`` ranks against the
    JAX sharded trace on as many devices and the port's single-rank trace;
    the padding slots are dead, and every rank returns the same grid."""
    jcfg = JConfig(**SUBSET)
    jctx = jrt.prepare(jcfg)
    sub = jrt.select_rays(jctx.state0, _subset_idx(jctx.layout.n_slots, n))
    want = _jax_sharded(jcfg, jctx, jsh.pad_rays(sub, world), world)
    e1, of1, steps1 = single[f"subset{n}"]
    launched = 0
    for r in ranks[world]:
        edep, oflow, steps, mine, n_local, alive = r[f"subset{n}"]
        assert oflow == of1 == 0 and steps == steps1 and mine <= steps
        assert n_local * world == n + (-n) % (8 * world)
        assert _close(edep, want, 1e-13)
        assert _close(edep, e1, 1e-13)
        assert np.array_equal(edep, ranks[world][0][f"subset{n}"][0])
        launched += alive
    # pad_rays: the padding adds no live ray
    assert launched == int(np.asarray(sub.alive).sum())
    assert (launched > 0) == (n == 64)


@pytest.mark.parametrize("world", WORLDS)
def test_scene_matches_jax_sharded(ranks, single, world):
    """The whole small scene through ``runner.run`` on ``world`` ranks, plain
    and compacted per rank, and through ``sharding.run_sharded``: against
    the JAX sharded trace of the live-tile state padded to ranks x tiles,
    and against the single-rank run."""
    jcfg = JConfig(**SCENE)
    jctx = jrt.prepare(jcfg)
    rpt = jctx.layout.rays_per_tile
    state0 = jsh.pad_rays(jrt.select_rays(jctx.state0, jctx.live_slots),
                          world * rpt * jcfg.tiles_per_block)
    want = _jax_sharded(jcfg, jctx, state0, world)
    one = single["plain"]
    for r in ranks[world]:
        # sharding.run_sharded, the convenience entry (sharding.py:231)
        assert _close(r["run_sharded"], want, 1e-13)
        for tag in ("plain", "compacted"):
            edep, stats = r[tag]
            assert _close(edep, want, 1e-13), tag
            assert _close(edep, one.edep, 1e-13), tag
            assert np.array_equal(edep, ranks[world][0][tag][0]), tag
            assert stats["devices"] == world
            assert stats["dist_backend"] == "gloo"
            assert stats["steps_executed"] == one.stats["steps_executed"]
            assert max(stats["rank_steps_executed"]) == \
                stats["steps_executed"]
            assert len(stats["rank_busy_seconds"]) == world
            assert stats["busy_slowest_over_mean"] >= 1.0


@pytest.mark.parametrize("world", WORLDS)
def test_trace_stats_equal_single_rank(ranks, single, world):
    """``trace_stats`` reduced over the ranks: the counts exactly, the
    energies to float64 rounding; compacted per rank = uncompacted."""
    one = single["plain"].stats
    for r in ranks[world]:
        plain, comp = r["plain"], r["compacted"]
        assert _close(comp[0], plain[0], 1e-13)
        for stats in (plain[1], comp[1]):
            for key in ("rays_total", "rays_launched", "rays_alive_at_end",
                        "rays_terminated"):
                assert stats[key] == one[key], key
            for key in ("energy_launched", "energy_absorbed"):
                np.testing.assert_allclose(stats[key], one[key], rtol=1e-13)
        assert comp[1]["segmented"] and not plain[1]["segmented"]
        widths = comp[1]["rank_tile_widths"]
        assert len(widths) == world and all(w for w in widths)
        assert comp[1]["tile_widths"] == widths[r["rank"]]


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_and_refusals(ranks, world):
    """``all_gather_rows`` with uneven blocks (and a rank without rows),
    ``rank_rows``, and the resumable forms' refusal of several ranks."""
    counts = [r + 1 if r < world - 1 else 0 for r in range(world)]
    want = np.concatenate([np.full((c, 3), float(r))
                           for r, c in enumerate(counts)])
    for r in ranks[world]:
        assert (r["world"], r["backend"]) == (world, "gloo")
        assert np.array_equal(r["gathered"], want)
        assert r["rank_rows"] == [list(map(float, range(i + 1)))
                                  for i in range(world)]
        assert "runs on one device" in r["resumable"]
    assert [r["rank"] for r in ranks[world]] == list(range(world))


def test_partition_helpers():
    """The rank's slot range (``multihost.py:83-106``) and whole beams per
    rank; one rank without a process group."""
    assert mh.local_slot_slice(12, 3, 1) == slice(4, 8)
    with pytest.raises(ValueError, match="divisible"):
        mh.local_slot_slice(10, 3, 0)
    with pytest.raises(ValueError, match="rank"):
        mh.local_slot_slice(12, 3, 3)
    assert sh.rank_beams(7, 2) == [(0, 4), (4, 3)]
    assert sh.rank_beams(60, 4) == [(0, 15), (15, 15), (30, 15), (45, 15)]
    assert sh.rank_beams(2, 4) == [(0, 1), (1, 1), (2, 0), (2, 0)]
    mesh = sh.make_mesh()
    assert (mesh.world, mesh.rank, mesh.distributed) == (1, 0, False)
    t = torch.ones(3)
    assert sh.all_reduce_sum(t, mesh) is t
    state = rt.select_rays(rt.prepare(Config(**SCENE)).state0,
                           np.arange(300))
    assert sh.local_state(state, mesh, 256) is state


@pytest.mark.parametrize("world", [1, 2])
def test_dryrun(world):
    """``parallel/dryrun.py``, the counterpart of
    ``__graft_entry__.dryrun_multichip``, on one and two gloo ranks (one
    rank: the group's collectives around the single-device layout)."""
    sums = dryrun.dryrun_multichip(world, timeout=300)
    assert len(sums) == 2 + 2 * len(dryrun.cbet_cases(world))
    assert all(np.isfinite(sums)) and min(sums) > 0


def test_cli_run_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 -m ...cli run --device cpu``: the ranks
    join one gloo group (``WORLD_SIZE`` set), rank 0 alone writes, and the
    grid equals the single-rank run's."""
    flags = ["--nbeams", "2", "--rays-per-zone", "1", "--nx", "24", "--ny",
             "24", "--nz", "24", "--dtype", "float64", "--device", "cpu",
             "--formats", "npz,json", "--quiet"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "cbet_raytracing_3d_tpu_torch.cli",
         "run", *flags, "--out-dir", str(tmp_path / "two")],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert cli.main(["run", *flags, "--out-dir", str(tmp_path / "one")]) == 0
    stats = json.load(open(tmp_path / "two" / "edep.json"))["stats"]
    assert stats["devices"] == 2 and stats["dist_backend"] == "gloo"
    assert len(stats["rank_tile_widths"]) == 2
    with np.load(tmp_path / "two" / "edep.npz") as z2, \
            np.load(tmp_path / "one" / "edep.npz") as z1:
        assert _close(z2["edep"], z1["edep"], 1e-13)
        assert json.loads(str(z2["stat_rank_tile_widths"])) == \
            stats["rank_tile_widths"]


def test_cli_refuses_nccl_on_one_device(monkeypatch, capsys):
    """NCCL cannot run two ranks on one device: refused before the group
    forms, naming ``--dist-backend gloo``; NCCL needs CUDA devices."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    for device, msg in (("cuda:0", "--dist-backend gloo"),
                        ("cpu", "needs CUDA devices")):
        with pytest.raises(SystemExit) as e:
            cli.main(["run", "--device", device, "--dist-backend", "nccl"])
        assert e.value.code == 2 and msg in capsys.readouterr().err
