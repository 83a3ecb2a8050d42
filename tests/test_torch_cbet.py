"""The port's CBET solve against the JAX package's, at two-beam scale: the
slot layout and beam ids of the solver, the grouped intensity deposit (K2's
plain version) against the JAX beam-offset scatter, one gain-coupled trace
per gain mode (K4's plain version inside kernel_cell) against the JAX
scatter trace, the float64 oracle's first iteration, whole solves, the seed
memo, the runner/CLI outputs, and the switches the port refuses."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbet_raytracing_3d_tpu import runner as jrunner
from cbet_raytracing_3d_tpu.config import Config as JConfig
from cbet_raytracing_3d_tpu.models import cbet as jcbet
from cbet_raytracing_3d_tpu.models import raytracer as jrt
from cbet_raytracing_3d_tpu.oracle import oracle_cbet_iteration
from cbet_raytracing_3d_tpu.parallel.sharding import pad_rays as jpad
from cbet_raytracing_3d_tpu.utils import output as joutput
from cbet_raytracing_3d_tpu_torch import cli, convert
from cbet_raytracing_3d_tpu_torch.config import Config
from cbet_raytracing_3d_tpu_torch.models import cbet
from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
from cbet_raytracing_3d_tpu_torch.ops import deposit as dep
from cbet_raytracing_3d_tpu_torch.parallel.sharding import pad_rays
from cbet_raytracing_3d_tpu_torch.runner import (estimate_device_bytes, run,
                                                 write_outputs)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(nbeams=2, rays_per_zone=1, nx=24, ny=24, nz=24, dtype="float64")
# kernel_cell needs the window to divide every chunk: nt = 96 at 24^3
WIN = dict(chunk_steps=8, deposit_batch_steps=4)
# tests/test_cbet.py::two_beam_cfg
TWO_BEAM = dict(nbeams=2, rays_per_zone=1, nx=40, ny=40, nz=40,
                cbet_max_iters=12, cbet_tol=1e-3)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _smooth_gain(cfg, scale):
    """tests/test_cbet.py:1063-1069: a smooth field of both signs."""
    rng = np.random.default_rng(3)
    g = np.zeros((cfg.nbeams, cfg.nx, cfg.ny, cfg.nz))
    for b in range(cfg.nbeams):
        g[b] = np.kron(rng.standard_normal((6, 6, 6)),
                       np.ones((4, 4, 4))) * scale
    return g.reshape(cfg.nbeams, -1)


def _jax_layout(jcfg, jctx):
    """The JAX solver's state and beam ids (models/cbet.py:1220-1225,
    :1302-1303)."""
    rpt = jctx.layout.rays_per_tile
    slots = jcbet.live_tile_slots(jcfg, jctx)
    tpg = (len(slots) // rpt) // jcfg.nbeams
    state0 = jpad(jrt.select_rays(jctx.state0, slots),
                  rpt * jcfg.tiles_per_block)
    bid = np.maximum(np.asarray(jctx.beam_id)[slots], 0).astype(np.int32)
    bid = np.pad(bid, (0, state0.n - bid.shape[0]))
    return slots, tpg, state0, bid


@pytest.fixture(scope="module")
def scene(profiles):
    kw = dict(SMALL, **WIN)
    jcfg = JConfig(**kw)
    jctx = jrt.prepare(jcfg, profiles)
    return jcfg, jctx, Config(**kw), rt.prepare(Config(**kw))


def test_live_tile_slots_and_bid_match_jax(scene):
    jcfg, jctx, cfg, ctx = scene
    slots, tpg, jstate0, jbid = _jax_layout(jcfg, jctx)
    assert np.array_equal(cbet.live_tile_slots(cfg, ctx), slots)
    solver = cbet._build_solver(cfg, ctx, torch.device("cpu"),
                                cbet.plain_ops())
    assert np.array_equal(solver.bid.numpy(), jbid)
    got = convert.state_to_numpy(solver.state0)
    want = convert.state_to_numpy(jstate0)
    for key in ("uray", "uray_init", "alive"):
        assert np.array_equal(got[key], want[key]), key
    for key in ("frac", "cell"):
        assert all(np.array_equal(a, b) for a, b in zip(got[key], want[key]))
    assert solver.state0.n == cfg.nbeams * tpg * ctx.layout.rays_per_tile


def test_live_tile_slots_refuses_unequal_beams(scene):
    _, _, cfg, ctx = scene
    alive = ctx.state0.alive.clone()
    alive[: ctx.layout.rays_per_tile * ctx.layout.tiles_per_beam] = False
    bad = dataclasses.replace(ctx, state0=dataclasses.replace(
        ctx.state0, alive=alive))
    with pytest.raises(RuntimeError, match="live-tile counts differ"):
        cbet.live_tile_slots(cfg, bad)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_deposit_grouped_reference_matches_jax_scatter(n_steps, rng):
    """K2's plain version against the beam-offset scatter of the JAX lookup
    trace (models/cbet.py:935-941), one step or a step-major window."""
    jcfg = JConfig(**SMALL)
    dims = (10, 9, 8)
    groups, rpg = 3, 40
    n = n_steps * groups * rpg
    cell = [rng.integers(0, d, size=n).astype(np.int32) for d in dims]
    frac = [rng.uniform(-0.9, 0.9, size=n) for _ in range(3)]
    inc = rng.uniform(0.5, 2.0, size=n) * (rng.uniform(size=n) > 0.2)
    bid = (np.arange(n) % (groups * rpg)) // rpg
    idx, val = jrt._scatter_corner_parts(
        jcfg, tuple(jnp.asarray(c) for c in cell),
        tuple(jnp.asarray(f) for f in frac), jnp.asarray(inc), dims=dims)
    gshape = (groups,) + tuple(d + 2 for d in dims)
    elems = int(np.prod(gshape[1:]))
    off = jnp.concatenate([jnp.asarray(bid * elems)] * 8)
    want = np.asarray(jnp.zeros(gshape).reshape(-1).at[idx + off].add(val)
                      ).reshape(gshape)
    args = ([torch.from_numpy(c) for c in cell]
            + [torch.from_numpy(f) for f in frac] + [torch.from_numpy(inc)])
    grids = torch.zeros(gshape, dtype=torch.float64)
    before = dep.GROUPED_LAUNCHES
    got, of = dep.deposit_grouped(grids, *args, rpg, groups * rpg)
    assert got is grids and int(of) == 0
    assert dep.GROUPED_LAUNCHES == before      # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    assert _rel_l2(got.numpy(), want) < 1e-12
    with pytest.raises(ValueError, match="rays"):
        dep.deposit_grouped(grids, *args, rpg - 1, groups * rpg)
    with pytest.raises(ValueError, match="whole steps"):
        dep.deposit_grouped(grids, *args, rpg, groups * rpg - 1)


@pytest.mark.parametrize("mode,scale", [("lookup", 2e-2), ("lookup", 20.0),
                                        ("kernel_cell", 2e-2),
                                        ("kernel_cell", 20.0)])
def test_trace_matches_jax_scatter(scene, mode, scale):
    """One gain-coupled trace with a fixed synthetic gain, f64, against the
    JAX scatter trace: edep, intensity, uray and alive.  Scale 20 makes
    g*ds ~0.1, so the clip engages and rays die mid-window."""
    jcfg, jctx, cfg, ctx = scene
    jcfg = jcfg.replace(cbet_gain_mode=mode)
    cfg = cfg.replace(cbet_gain_mode=mode)
    _, tpg, jstate0, jbid = _jax_layout(jcfg, jctx)
    g = _smooth_gain(cfg, scale)
    tr = jax.jit(jcbet.make_cbet_trace_fn(jcfg, jctx, backend="scatter",
                                          tiles_per_group=tpg)())
    e_j, i_j, st_j, of_j = tr(jctx.field4, jnp.asarray(g), jnp.asarray(jbid),
                              jstate0)
    field4, state0, bid, gain = convert.from_jax_cbet(
        np.asarray(jctx.field4), convert.state_to_numpy(jstate0), jbid, g)
    e_p, i_p, st_p, of_p, steps = cbet.make_cbet_trace_fn(
        cfg, ctx, tiles_per_group=tpg)(field4, gain, bid, state0)
    assert int(of_j) == int(of_p) == 0 and steps > 0
    assert _rel_l2(e_p.numpy(), np.asarray(e_j)) < 1e-12
    assert _rel_l2(i_p.numpy(), np.asarray(i_j)) < 1e-12
    launched = state0.alive.numpy()
    np.testing.assert_allclose(st_p.uray.numpy()[launched],
                               np.asarray(st_j.uray)[launched], rtol=1e-12)
    assert np.array_equal(st_p.alive.numpy(), np.asarray(st_j.alive))


def test_kernel_cell_needs_whole_windows(scene):
    _, _, cfg, ctx = scene
    with pytest.raises(ValueError, match="deposit_batch_steps"):
        cbet.make_cbet_trace_fn(cfg.replace(cbet_gain_mode="kernel_cell",
                                            chunk_steps=10), ctx)


def test_kernel_cell_solve_equals_lookup_solve():
    """tests/test_cbet.py::test_cbet_gain_kernel_cell_exact for the port:
    the window model equals the per-step lookup with the stop rule active
    (mid-window deaths included)."""
    cfg = Config(**TWO_BEAM).replace(dtype="float64", chunk_steps=10,
                                     deposit_batch_steps=5, cbet_max_iters=3)
    ctx = rt.prepare(cfg)
    exact = cbet.cbet_solve(cfg, ctx, "cpu")
    cell = cbet.cbet_solve(cfg.replace(cbet_gain_mode="kernel_cell"), ctx,
                           "cpu")
    assert cell.iterations == exact.iterations
    assert _rel_l2(cell.edep, exact.edep) < 1e-12
    assert _rel_l2(cell.intensity, exact.intensity) < 1e-12
    for key in ("rays_terminated", "rays_alive_at_end"):
        assert cell.stats[key] == exact.stats[key], key
    np.testing.assert_allclose(cell.stats["energy_absorbed"],
                               exact.stats["energy_absorbed"], rtol=1e-12)


def test_values_match_oracle(profiles):
    """tests/test_cbet.py::test_cbet_values_match_oracle for the port: the
    first fixed-point iteration against the float64 per-ray oracle."""
    cfg = Config(nbeams=2, rays_per_zone=1, nx=24, ny=24, nz=24,
                 dtype="float64", tiles_per_block=1)
    ctx = rt.prepare(cfg)
    i0_o, gain_o, edep1_o, i1_o = oracle_cbet_iteration(
        JConfig(**dataclasses.asdict(cfg)), profiles, ctx.beam_norm)
    state0 = pad_rays(ctx.state0, ctx.layout.rays_per_tile)
    bid = np.maximum(ctx.beam_id, 0).astype(np.int32)
    bid = torch.from_numpy(np.pad(bid, (0, state0.n - bid.shape[0])))
    P = cfg.nx * cfg.ny * cfg.nz
    tr = cbet.make_cbet_trace_fn(cfg, ctx)
    _, i0_p, _, _, _ = tr(ctx.field4, torch.zeros((2, P), dtype=torch.float64),
                          bid, state0)
    assert _rel_l2(i0_p.numpy(), i0_o.reshape(2, P)) < 1e-8
    g_p = cbet.make_gain_fn(cfg, ctx)(i0_p.float()).numpy()
    assert _rel_l2(g_p, gain_o.reshape(2, P)) < 1e-5
    assert np.abs(g_p).max() > 0
    edep1_p, i1_p, _, _, _ = tr(ctx.field4,
                                torch.from_numpy(gain_o.reshape(2, P)), bid,
                                state0)
    assert _rel_l2(edep1_p.numpy(), edep1_o) < 1e-8
    assert _rel_l2(i1_p.numpy(), i1_o.reshape(2, P)) < 1e-8
    assert np.abs(i1_o - i0_o).max() > 0


_JAX_SOLVES = {}


def _jax_solve(kw):
    key = tuple(sorted(kw.items()))
    if key not in _JAX_SOLVES:
        jcfg = JConfig(**kw)
        _JAX_SOLVES[key] = (jcbet.cbet_solve(jcfg, jrt.prepare(jcfg),
                                             backend="scatter"), jcfg)
    return _JAX_SOLVES[key]


def _solve_kw(s):
    return dict(SMALL, cbet_max_iters=3, cbet_grid_downsample=s)


@pytest.mark.parametrize("s", [1, 2])
def test_solve_matches_jax_with_its_gain(s):
    """The whole single-device solve (trace, update, loop, convergence,
    upsampling) against JAX ``cbet_solve(backend="scatter")`` in f64, with
    the JAX XLA gain reduction injected: the two f32 gain reductions round
    differently (XLA contracts into FMAs on the CPU), which the next test
    measures."""
    jres, jcfg = _jax_solve(_solve_kw(s))
    jgain = jcbet.make_gain_fn(jcfg, jrt.prepare(jcfg), backend="xla")

    def gain_op(pu, rp, inten):
        return torch.from_numpy(np.array(jgain(jnp.asarray(inten.numpy()))))

    ops = dataclasses.replace(cbet.plain_ops(), gain=gain_op)
    cfg = Config(**_solve_kw(s))
    res = cbet.cbet_solve(cfg, rt.prepare(cfg), "cpu", ops=ops)
    assert res.iterations == jres.iterations
    np.testing.assert_allclose(res.history, jres.history, rtol=1e-10)
    assert _rel_l2(res.edep, jres.edep) < 1e-10
    assert _rel_l2(res.intensity, jres.intensity) < 1e-10
    assert res.intensity.shape == jres.intensity.shape


@pytest.mark.parametrize("s", [1, 2])
def test_solve_matches_jax_with_own_gain(s):
    """The port's own solve against the JAX one: the same iterations; the
    f32 gain's last-bit differences (<= 2.2e-7 relative) move the f64
    fixed point by ~1e-9 (measured 1.5e-9 intensity, 1.6e-8 history)."""
    jres, _ = _jax_solve(_solve_kw(s))
    cfg = Config(**_solve_kw(s))
    res = cbet.cbet_solve(cfg, rt.prepare(cfg), "cpu")
    assert res.iterations == jres.iterations and res.converged
    np.testing.assert_allclose(res.history, jres.history, rtol=1e-6)
    assert _rel_l2(res.edep, jres.edep) < 1e-7
    assert _rel_l2(res.intensity, jres.intensity) < 1e-7
    for key in ("rays_launched", "rays_terminated", "rays_alive_at_end"):
        assert res.stats[key] == jres.stats[key], key


def test_seed_memo_bit_identical():
    """cbet_seed_zero_gain: a seeded solve (warm solver memo) is identical
    to an unseeded one, through one cached solver."""
    cfg = Config(**TWO_BEAM)
    ctx = rt.prepare(cfg)
    cbet._SOLVER_CACHE.clear()
    off = cbet.cbet_solve(cfg.replace(cbet_seed_zero_gain=False), ctx, "cpu")
    assert off.stats["seeded_zero_gain"] is False
    first = cbet.cbet_solve(cfg, ctx, "cpu")
    assert first.stats["seeded_zero_gain"] is False
    again = cbet.cbet_solve(cfg, ctx, "cpu")
    assert again.stats["seeded_zero_gain"] is True
    assert len(cbet._SOLVER_CACHE) == 1
    assert again.history == off.history and again.converged
    assert np.array_equal(again.edep, off.edep)
    assert np.array_equal(again.intensity, off.intensity)
    assert len(again.stats["iter_seconds"]) == again.iterations
    assert len(again.stats["trace_steps"]) == again.iterations
    assert len(off.stats["trace_steps"]) == off.iterations + 1


@pytest.fixture(scope="module")
def cbet_run():
    cfg = Config(**dict(SMALL, cbet_max_iters=2))
    return run(cfg, with_cbet=True, device="cpu", verbose=False)


def test_runner_outputs_match_jax(cbet_run, tmp_path):
    """``runner.run(with_cbet=True)`` and ``write_outputs`` against the JAX
    ``write_outputs`` of the JAX single-device solve: the same npz keys,
    sibling files and json "cbet" section."""
    jcfg = JConfig(**dict(SMALL, cbet_max_iters=2))
    jctx = jrt.prepare(jcfg)
    jres = jcbet.cbet_solve(jcfg, jctx, backend="scatter")
    jedep, _ = jrt.trace(jctx, backend="scatter")
    jrun = jrunner.RunResult(cfg=jcfg, edep=jedep, stats=cbet_run.stats,
                             timings={}, cbet=jres)
    fmts = ("npz", "json", "txt")
    jpaths = jrunner.write_outputs(jrun, str(tmp_path / "jax"), fmts)
    paths = write_outputs(cbet_run, str(tmp_path / "port"), fmts)
    assert ([os.path.basename(p) for p in paths]
            == [os.path.basename(p) for p in jpaths])
    with np.load(tmp_path / "jax" / "edep.npz") as zj, \
            np.load(tmp_path / "port" / "edep.npz") as zp:
        assert set(zj) <= set(zp)
        assert {k for k in zp if k.startswith("cbet_")} == {
            k for k in zj if k.startswith("cbet_")}
        assert np.array_equal(zp["cbet_edep"], cbet_run.cbet.edep)
        assert int(zp["cbet_iterations"]) == int(zj["cbet_iterations"])
        assert _rel_l2(zp["cbet_edep"], zj["cbet_edep"]) < 1e-7
    jj = json.load(open(tmp_path / "jax" / "edep.json"))["cbet"]
    jp = json.load(open(tmp_path / "port" / "edep.json"))["cbet"]
    assert set(jp) == set(jj) and set(jj["stats"]) <= set(jp["stats"])
    assert jp["iterations"] == jj["iterations"]
    np.testing.assert_allclose(jp["history"], jj["history"], rtol=1e-6)
    np.testing.assert_allclose(jp["edep_total"], jj["edep_total"], rtol=1e-7)
    assert jp["stats"]["intensity_mode"] == "grouped"
    assert (tmp_path / "port" / "edep_cbet.txt").read_text() == \
        joutput.dump_print_format(cbet_run.cbet.edep)


def test_cli_run_cbet(cbet_run, tmp_path):
    flags = ["--nbeams", "2", "--rays-per-zone", "1", "--nx", "24", "--ny",
             "24", "--nz", "24", "--dtype", "float64", "--cbet-max-iters",
             "2"]
    rc = cli.main(["run", *flags, "--cbet", "--device", "cpu", "--out-dir",
                   str(tmp_path), "--formats", "npz,json", "--quiet"])
    assert rc == 0
    with np.load(tmp_path / "edep.npz") as z:
        assert np.array_equal(z["cbet_edep"], cbet_run.cbet.edep)
        assert np.array_equal(z["cbet_history"], cbet_run.cbet.history)
    meta = json.load(open(tmp_path / "edep.json"))
    assert meta["cbet"]["iterations"] == cbet_run.cbet.iterations
    assert "CBET" in meta["timings"]


@pytest.mark.parametrize("field,value", [
    ("cbet_gain_mode", "kernel"), ("cbet_light_iterations", True),
    ("cbet_accel", "anderson"), ("cbet_gain_stride", 5)])
def test_unported_switches_raise(field, value):
    """The opt-ins are ported, so none raises NotImplementedError.  On this
    unbatched configuration (deposit_batch_steps 5 does not divide the last
    chunk, 21 steps) the JAX package's rules refuse the three window
    switches with ValueError, before any trace; Anderson mixing runs."""
    cfg = Config(**SMALL, cbet_max_iters=1).replace(**{field: value})
    if field == "cbet_accel":
        res = run(cfg, with_cbet=True, device="cpu", verbose=False)
        assert res.cbet.stats["accel"] == "anderson"
        assert res.cbet.iterations == 1
        return
    match = {"cbet_gain_mode": "deposit_batch_steps",
             "cbet_light_iterations": "light", "cbet_gain_stride":
             "cbet_gain_stride"}[field]
    with pytest.raises(ValueError, match=match):
        run(cfg, with_cbet=True, device="cpu", verbose=False)
    with pytest.raises(ValueError, match=match):
        cbet.cbet_solve(cfg, rt.prepare(cfg), "cpu")


def test_memory_estimate_counts_cbet():
    """OMEGA, f32: the CBET buffers (the (B, P) fields and the 60 beam
    grids) add well over a GB; f64 doubles the float buffers."""
    base = estimate_device_bytes(Config())
    add = estimate_device_bytes(Config(), with_cbet=True) - base
    assert 60 * 10 ** 6 * 4 * 5 < add < 8e9
    add64 = (estimate_device_bytes(Config(dtype="float64"), True)
             - estimate_device_bytes(Config(dtype="float64")))
    assert add64 > 1.5 * add


def test_cbet_run_leaves_jax_unloaded(tmp_path):
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from cbet_raytracing_3d_tpu_torch import Config, cbet_solve\n"
        "from cbet_raytracing_3d_tpu_torch.runner import run\n"
        "r = run(Config(nbeams=2, rays_per_zone=1, nx=20, ny=20, nz=20,"
        " cbet_max_iters=1), with_cbet=True, device='cpu', verbose=False)\n"
        "assert r.cbet.iterations == 1 and r.cbet.edep.sum() > 0\n"
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
