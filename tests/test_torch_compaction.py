"""Mid-trace tile compaction (``models/tileplan.py``): the compacted plain
trace and every compacted CBET mode against the uncompacted ones (bit for
bit on the CPU: dropped rows are dead and add exact zeros, and the plain
deposit adds row by row), against the JAX package's segmented trace and
segmented solve, the coasting-rays accounting case, and the dropped-alive
guard."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbet_raytracing_3d_tpu.config import Config as JConfig
from cbet_raytracing_3d_tpu.models import cbet as jcbet
from cbet_raytracing_3d_tpu.models import raytracer as jrt
from cbet_raytracing_3d_tpu.models import tileplan as jtp
from cbet_raytracing_3d_tpu.parallel.sharding import pad_rays as jpad
from cbet_raytracing_3d_tpu_torch import convert
from cbet_raytracing_3d_tpu_torch.config import Config
from cbet_raytracing_3d_tpu_torch.models import cbet
from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
from cbet_raytracing_3d_tpu_torch.models import tileplan as tp
from cbet_raytracing_3d_tpu_torch.ops import deposit as dep_ops
from cbet_raytracing_3d_tpu_torch.runner import run

torch.set_num_threads(1)

# tests/test_tileplan.py::_setup's scene: it loses tiles mid-trace
SCENE = dict(nbeams=2, rays_per_zone=1, nx=40, ny=40, nz=40,
             tiles_per_block=2)
# CBET: windows of 4 divide the 8-step chunks (nt = 128 at 32^3)
CBET_SCENE = dict(nbeams=3, rays_per_zone=1, nx=32, ny=32, nz=32,
                  dtype="float64", chunk_steps=8, deposit_batch_steps=4,
                  cbet_max_iters=3, tiles_per_block=2)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _states_equal(a: rt.RayState, b: rt.RayState) -> bool:
    pa, pb = convert.state_to_numpy(a), convert.state_to_numpy(b)
    return all(np.array_equal(np.asarray(pa[k]), np.asarray(pb[k]))
               for k in pa)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_compacted_trace_equals_plain_bitwise(dtype):
    """edep and the written-back final state equal the uncompacted trace's
    bit for bit; the scene really compacts (two or more re-gathers)."""
    cfg = Config(**SCENE, dtype=dtype)
    ctx = rt.prepare(cfg)
    state0 = rt.traced_state(ctx, "cpu")
    e_p, s_p, of_p, n_p = rt.make_trace_fn(cfg)(ctx.field4, state0)
    widths = []
    e_c, s_c, of_c, n_c = rt.make_trace_fn(cfg, compact=True)(
        ctx.field4, state0, widths)
    assert int(of_p) == int(of_c) == 0 and n_p == n_c > 0
    assert torch.equal(e_c, e_p) and float(e_p.abs().max()) > 0
    assert _states_equal(s_c, s_p)
    assert widths[0] == state0.n // ctx.layout.rays_per_tile
    assert len(widths) >= 2 and all(
        b < a for a, b in zip(widths, widths[1:]))
    # state0 is left as it was
    assert _states_equal(state0, rt.traced_state(ctx, "cpu"))


def _counting(calls):
    def deposit(*a):
        calls.append(a[1].shape[0])
        return dep_ops.deposit(*a)
    return deposit


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_windowed_trace_equals_per_step_bitwise(dtype, compact):
    """The plain trace deposits ``deposit_batch_steps`` windows where they
    divide the chunks: a fifth of the deposit calls, each of whole steps of
    the rays then traced, and on the CPU the per-step trace's grid and final
    state bit for bit (the plain deposit adds a step-major window row by
    row), compacted or not."""
    cfg = Config(**SCENE, dtype=dtype)
    assert rt.batched(cfg) and cfg.deposit_batch_steps == 5
    per_step = cfg.replace(deposit_batch_steps=1)
    assert not rt.batched(per_step)
    ctx = rt.prepare(cfg)
    state0 = rt.traced_state(ctx, "cpu")
    calls_w, calls_1, widths = [], [], []
    e_w, s_w, of_w, n_w = rt.make_trace_fn(
        cfg, _counting(calls_w), compact=compact)(ctx.field4, state0, widths)
    e_1, s_1, of_1, n_1 = rt.make_trace_fn(
        per_step, _counting(calls_1), compact=compact)(ctx.field4, state0)
    assert n_w == n_1 > 0 and int(of_w) == int(of_1) == 0
    assert len(calls_1) == n_1 and len(calls_w) == n_w // 5
    assert sum(calls_w) == sum(calls_1) and all(c % 5 == 0 for c in calls_w)
    if compact:
        assert len(set(calls_w)) >= 2      # the ray count shrinks by chunk
        rpt = ctx.layout.rays_per_tile
        assert set(calls_w) <= {5 * w * rpt for w in widths}
    else:
        assert set(calls_w) == {5 * state0.n}
    assert torch.equal(e_w, e_1) and float(e_w.abs().max()) > 0
    assert _states_equal(s_w, s_1)


@pytest.mark.parametrize("chunk,batch,windowed", [
    (25, 5, True),        # 160 steps: chunks of 25 and a last one of 10
    (7, 5, False),        # 5 divides neither 7 nor the last chunk
    (30, 5, True),        # chunks of 30 and a last one of 10
    (30, 4, False),       # 4 does not divide 30
    (16, 4, True), (25, 1, False)])
def test_windowed_trace_falls_back_where_the_batch_does_not_divide(
        chunk, batch, windowed):
    """As the JAX trace (``models/raytracer.py:793-795``): windows only
    where the batch divides the chunk length and the last chunk's, else a
    deposit per step; the grid is the same either way."""
    cfg = Config(**SCENE, dtype="float64", chunk_steps=chunk,
                 deposit_batch_steps=batch)
    assert rt.batched(cfg) == windowed
    ctx = rt.prepare(cfg)
    state0 = rt.traced_state(ctx, "cpu")
    calls = []
    e, _, _, steps = rt.make_trace_fn(cfg, _counting(calls))(ctx.field4,
                                                            state0)
    assert len(calls) == (steps // batch if windowed else steps)
    want, _, _, steps_1 = rt.make_trace_fn(
        cfg.replace(deposit_batch_steps=1))(ctx.field4, state0)
    assert steps == steps_1 and torch.equal(e, want)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_windowed_trace_matches_jax_trace(dtype):
    """The windowed trace against the JAX package's trace (its scatter
    backend) on the same padded live tiles, at the per-step trace's
    tolerances (tests/test_torch_trace.py)."""
    jcfg = JConfig(**SCENE, dtype=dtype)
    jctx = jrt.prepare(jcfg)
    rpt = jctx.layout.rays_per_tile
    js0 = jpad(jrt.select_rays(jctx.state0, jctx.live_slots), rpt)
    want, jstate, _ = jax.jit(jrt.make_trace_fn(jcfg, rpt,
                                                backend="scatter"))(
        jctx.field4, js0)
    cfg = Config(**SCENE, dtype=dtype)
    assert rt.batched(cfg)
    got, state = rt.trace(rt.prepare(cfg), "cpu")
    tol = 1e-12 if dtype == "float64" else 1e-5
    assert _rel_l2(got, np.asarray(want, np.float64)) < tol
    assert np.array_equal(state.alive.numpy(), np.asarray(jstate.alive))


def test_compacted_trace_matches_jax_segmented_trace():
    """Against ``make_segmented_trace_fn(track_final_state=True)`` on the
    JAX package's measured tile plan (float64, its scatter backend): edep
    and the final energies and liveness of every slot."""
    jcfg = JConfig(**SCENE, dtype="float64")
    jctx = jrt.prepare(jcfg)
    rpt = jctx.layout.rays_per_tile
    jstate0 = jpad(jrt.select_rays(jctx.state0, jctx.live_slots),
                   rpt * jcfg.tiles_per_block)
    plan = jtp.measure_plan(jcfg, jctx, jstate0)
    segments = jtp.build_segments(plan, jcfg, jcfg.nt)
    assert len(segments) > 1
    seg = jax.jit(jrt.make_segmented_trace_fn(
        jcfg, rpt, segments, backend="scatter", track_final_state=True))
    e_j, _, of_j, (uray_j, alive_j) = seg(jctx.field4, jstate0)

    cfg = Config(**SCENE, dtype="float64")
    state0 = convert.state_from_numpy(convert.state_to_numpy(jstate0))
    field4 = torch.from_numpy(np.array(jctx.field4))
    e_p, s_p, of_p, _ = rt.make_trace_fn(cfg, compact=True)(field4, state0)
    assert int(of_j) == int(of_p) == 0
    assert _rel_l2(e_p.numpy(), np.asarray(e_j)) < 1e-12
    assert np.array_equal(s_p.alive.numpy(), np.asarray(alive_j))
    np.testing.assert_allclose(s_p.uray.numpy(), np.asarray(uray_j),
                               rtol=1e-12, atol=0)


def test_run_accounting_with_coasting_rays(tmp_path):
    """tests/test_runner.py::test_run_segmented_accounting_with_coasting_rays
    for the port: rays that coast through zero-absorption cells keep their
    tiles (liveness is ``alive``, not deposit activity), so the compacted
    run (a cache dir) has the plain run's grid and accounting exactly."""
    cfg = Config(nbeams=4, rays_per_zone=1, nx=40, ny=40, nz=40,
                 dtype="float64", chunk_steps=10)
    plain = run(cfg, device="cpu", verbose=False)
    seg = run(cfg, device="cpu", verbose=False,
              cache_dir=str(tmp_path / "cache"))
    assert seg.stats["segmented"] and not plain.stats["segmented"]
    assert len(seg.stats["tile_widths"]) >= 3
    assert np.array_equal(seg.edep, plain.edep)
    for key in ("rays_launched", "rays_terminated", "rays_alive_at_end",
                "energy_absorbed", "energy_launched", "steps_executed"):
        assert seg.stats[key] == plain.stats[key], key
    assert not (tmp_path / "cache").exists()      # the port caches nothing


def test_dropping_an_alive_ray_raises():
    """The dropped-alive guard: a compaction told to drop a tile that
    holds an alive ray raises instead of losing its energy."""
    cfg = Config(**SCENE, dtype="float64")
    ctx = rt.prepare(cfg)
    state0 = rt.traced_state(ctx, "cpu")
    rpt = ctx.layout.rays_per_tile
    comp = tp.TileCompactor(state0, rpt)
    live = state0.alive.view(-1, rpt).any(dim=1)
    first_live = int(torch.nonzero(live)[0])
    kept = torch.tensor([t for t in range(live.shape[0]) if t != first_live])
    with pytest.raises(tp.DroppedAliveRaysError, match="still-alive"):
        comp.gather(state0, (), kept)
    with pytest.raises(ValueError, match="whole tiles"):
        tp.TileCompactor(rt.select_rays(state0, np.arange(rpt + 1)), rpt)
    # grouped mode: each group keeps its live tiles in order, then its own
    # dead ones up to the width; a dead group keeps width-many dead tiles
    two = tp.TileCompactor(state0, rpt, n_groups=2)
    w = two.width
    alive = torch.zeros_like(state0.alive)
    alive[(w + 2) * rpt] = alive[w * rpt + 5] = True
    assert two.keep(alive, first=True).tolist() == [0, 1, w, w + 2]
    assert two.keep(alive, first=False).tolist() == [0, 1, w, w + 2]
    alive[w * rpt: 2 * w * rpt] = True
    assert two.keep(alive, first=True) is None


CBET_MODES = {
    "lookup": {},
    "lookup-per-step": dict(deposit_batch_steps=1),
    "kernel_cell": dict(cbet_gain_mode="kernel_cell"),
    "tri": dict(cbet_gain_mode="kernel"),
    "light": dict(cbet_gain_mode="kernel_cell", cbet_light_iterations=True),
    "light-lookup": dict(cbet_light_iterations=True),
    "anderson": dict(cbet_accel="anderson"),
    "stride": dict(cbet_gain_stride=4),
}


@pytest.mark.parametrize("mode", list(CBET_MODES))
def test_compacted_cbet_equals_plain_bitwise(mode):
    """``cbet_segmented=True`` in every mode the port has: the same
    iterations, history, edep, intensity and accounting, bit for bit; the
    per-beam width shrinks; ``cbet_plan_headroom`` changes nothing and is
    reported."""
    cfg = Config(**{**CBET_SCENE, **CBET_MODES[mode]})
    ctx = rt.prepare(cfg)
    plain = cbet.cbet_solve(cfg, ctx, "cpu")
    seg = cbet.cbet_solve(cfg.replace(cbet_segmented=True,
                                      cbet_plan_headroom=0.5), ctx, "cpu")
    assert seg.stats["segmented"] and not plain.stats["segmented"]
    assert seg.stats["plan_headroom"] == 0.5
    assert seg.iterations == plain.iterations and seg.history == plain.history
    assert np.array_equal(seg.edep, plain.edep)
    assert np.array_equal(seg.intensity, plain.intensity)
    for key in ("rays_launched", "rays_terminated", "rays_alive_at_end",
                "energy_absorbed"):
        assert seg.stats[key] == plain.stats[key], key
    w = seg.stats["tile_widths"]
    assert len(w) >= 3 and all(b < a for a, b in zip(w, w[1:]))
    assert plain.stats["tile_widths"] == []


def test_compacted_cbet_needs_beam_groups():
    cfg = Config(**CBET_SCENE, cbet_segmented=True)
    ctx = rt.prepare(cfg)
    solver = cbet._build_solver(cfg, ctx, torch.device("cpu"),
                                cbet.plain_ops())
    tr = cbet.make_cbet_trace_fn(cfg, ctx, tiles_per_group=1)
    with pytest.raises(ValueError, match="beam groups"):
        tr(ctx.field4, solver.make_zero_gain(), solver.bid, solver.state0)


def test_compacted_solve_matches_jax_segmented_solve():
    """The whole compacted solve against JAX ``cbet_solve(cbet_segmented=
    True)`` (its gain-proof tile plan, scatter backend, float64) with the
    JAX XLA gain reduction injected, at test_torch_cbet.py's solve
    tolerances."""
    kw = dict(nbeams=2, rays_per_zone=1, nx=24, ny=24, nz=24,
              dtype="float64", cbet_max_iters=3, cbet_segmented=True)
    jcfg = JConfig(**kw)
    jres = jcbet.cbet_solve(jcfg, jrt.prepare(jcfg), backend="scatter")
    jgain = jcbet.make_gain_fn(jcfg, jrt.prepare(jcfg), backend="xla")

    def gain_op(pu, rp, inten):
        return torch.from_numpy(np.array(jgain(jnp.asarray(inten.numpy()))))

    ops = dataclasses.replace(cbet.plain_ops(), gain=gain_op)
    cfg = Config(**kw)
    res = cbet.cbet_solve(cfg, rt.prepare(cfg), "cpu", ops=ops)
    assert res.stats["segmented"] and jres.stats["segmented"]
    assert res.iterations == jres.iterations
    np.testing.assert_allclose(res.history, jres.history, rtol=1e-10)
    assert _rel_l2(res.edep, jres.edep) < 1e-10
    assert _rel_l2(res.intensity, jres.intensity) < 1e-10
    for key in ("rays_launched", "rays_terminated", "rays_alive_at_end"):
        assert res.stats[key] == jres.stats[key], key
