"""The port's trace against the JAX package's: the config-1 golden, the JAX
scatter-backend trace on the tests/test_integrator.py subset (beams 0 and
17, identical state0 carried over by ``convert``), the float64 oracle,
energy conservation, determinism and the run accounting."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbet_raytracing_3d_tpu.config import Config as JConfig
from cbet_raytracing_3d_tpu.models import raytracer as jrt
from cbet_raytracing_3d_tpu.oracle import oracle_edep
from cbet_raytracing_3d_tpu_torch import convert
from cbet_raytracing_3d_tpu_torch.config import Config
from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
from cbet_raytracing_3d_tpu_torch.ops import deposit as dep

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "config1_oracle.npz")
RAY_IDS = list(range(0, 19600, 700))
BEAMS = [0, 17]


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _run(cfg, field4, state0):
    edep, state, oflow, steps = rt.make_trace_fn(cfg)(field4, state0)
    assert int(oflow) == 0
    assert edep.dtype == torch.float64 and edep.shape == cfg.edep_shape
    return edep.numpy(), state, steps


def _cast32(state):
    return state.map(lambda a: a.float() if a.is_floating_point() else a)


def test_config1_golden():
    """BASELINE config 1 against the committed float64 oracle golden, with
    the ray selection of tests/test_golden.py."""
    data = np.load(GOLDEN)
    cfg = Config(nbeams=1, rays_per_zone=1, nx=40, ny=40, nz=40,
                 dtype="float64")
    ctx = rt.prepare(cfg)
    state0 = rt.select_rays(ctx.state0, ctx.layout.slot_of[0, data["rays"]])
    got, _, _ = _run(cfg, ctx.field4, state0)
    assert _rel_l2(got, data["edep"]) < 1e-9
    np.testing.assert_allclose(got.sum(), data["edep"].sum(), rtol=1e-10)


@pytest.fixture(scope="module")
def jctx64(profiles):
    return jrt.prepare(JConfig(dtype="float64"), profiles, host_state=True)


@pytest.fixture(scope="module")
def subset(jctx64):
    slots = np.concatenate([jctx64.layout.slot_of[b, np.asarray(RAY_IDS)]
                            for b in BEAMS])
    jstate0 = jrt.select_rays(jctx64.state0, slots)
    field4, state0, _ = convert.from_jax_context(
        jctx64.field4, convert.state_to_numpy(jstate0), jctx64.live_slots)
    return jstate0, field4, state0


@pytest.fixture(scope="module")
def jax_scatter64(jctx64, subset):
    fn = jax.jit(jrt.make_trace_fn(jctx64.cfg, jctx64.layout.rays_per_tile,
                                   backend="scatter"))
    edep, state, _ = fn(jnp.asarray(jctx64.field4),
                        jax.tree_util.tree_map(jnp.asarray, subset[0]))
    return np.asarray(edep, np.float64), state


@pytest.fixture(scope="module")
def port64(subset):
    return _run(Config(dtype="float64"), subset[1], subset[2])


def test_f64_matches_jax_scatter_trace(port64, jax_scatter64):
    got, state, _ = port64
    want, jstate = jax_scatter64
    assert _rel_l2(got, want) < 1e-12
    assert np.array_equal(state.alive.numpy(), np.asarray(jstate.alive))
    for ax in range(3):
        assert np.array_equal(state.cell[ax].numpy(),
                              np.asarray(jstate.cell[ax]))
    np.testing.assert_allclose(state.uray.numpy(), np.asarray(jstate.uray),
                               rtol=1e-12, atol=0)


def test_f32_matches_jax_scatter_trace(jctx64, subset):
    jstate32 = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32)
        if np.asarray(a).dtype == np.float64 else jnp.asarray(a), subset[0])
    fn = jax.jit(jrt.make_trace_fn(jctx64.cfg, jctx64.layout.rays_per_tile,
                                   backend="scatter"))
    want, _, _ = fn(jnp.asarray(jctx64.field4, jnp.float32), jstate32)
    got, _, _ = _run(Config(), subset[1].float(), _cast32(subset[2]))
    assert _rel_l2(got, np.asarray(want, np.float64)) < 1e-5


def test_f64_matches_oracle(port64, profiles):
    want = oracle_edep(JConfig(dtype="float64"), profiles, beams=BEAMS,
                       rays=RAY_IDS)
    assert _rel_l2(port64[0], want) < 1e-9


def test_energy_conservation(port64, subset):
    """Sum of deposited energy == sum of per-ray energy decrements."""
    got, state, _ = port64
    s0 = subset[2]
    mask = s0.alive.numpy()
    decrement = (s0.uray.numpy() - state.uray.numpy())[mask]
    np.testing.assert_allclose(got.sum(), decrement.sum(), rtol=1e-12)


def test_bitwise_determinism_on_cpu(port64, subset):
    again, _, _ = _run(Config(dtype="float64"), subset[1], subset[2])
    assert np.array_equal(again, port64[0])


def test_trace_stats_match_jax(jctx64, port64, jax_scatter64, subset):
    _, state, steps = port64
    want = jrt.trace_stats(jctx64, jax_scatter64[1], subset[0])
    ctx = rt.prepare(Config(nbeams=1, rays_per_zone=1, nx=20, ny=20, nz=20))
    # trace_stats reads only cfg.total_rays from the context
    got = rt.trace_stats(dataclasses.replace(ctx, cfg=Config(dtype="float64")),
                         state, subset[2])
    for key in ("rays_total", "rays_launched", "rays_alive_at_end",
                "rays_terminated"):
        assert got[key] == want[key], key
    for key in ("energy_launched", "energy_absorbed"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)
    assert got["rays_launched"] > 0 and got["rays_terminated"] > 0
    assert 0 < steps <= Config().nt and steps % Config().chunk_steps == 0
    with pytest.raises(ValueError):
        rt.trace_stats(ctx, state, rt.select_rays(subset[2], [0, 1]))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_live_tile_trace_matches_jax(dtype, profiles):
    """The whole small scene: every live tile, padded, traced by both
    packages from their own prepare."""
    kw = dict(nbeams=3, rays_per_zone=1, nx=32, ny=32, nz=32, dtype=dtype)
    jctx = jrt.prepare(JConfig(**kw), profiles)
    from cbet_raytracing_3d_tpu.parallel.sharding import pad_rays as jpad
    js0 = jpad(jrt.select_rays(jctx.state0, jctx.live_slots),
               jctx.layout.rays_per_tile)
    want, jstate, _ = jax.jit(jrt.make_trace_fn(
        jctx.cfg, jctx.layout.rays_per_tile, backend="scatter"))(
            jctx.field4, js0)
    cfg = Config(**kw)
    got_np, state = rt.trace(rt.prepare(cfg), "cpu")
    tol = 1e-12 if dtype == "float64" else 1e-5
    assert _rel_l2(got_np, np.asarray(want, np.float64)) < tol
    assert np.array_equal(state.alive.numpy(), np.asarray(jstate.alive))


def test_early_exit_counts_steps():
    """The trace stops at the first chunk boundary with no ray alive; the
    step count is the number of deposit calls."""
    cfg = Config(nbeams=1, rays_per_zone=1, nx=24, ny=24, nz=24,
                 dtype="float64", chunk_steps=7)
    ctx = rt.prepare(cfg)
    s0 = rt.select_rays(ctx.state0, ctx.live_slots)
    calls = []

    def counting(*a):
        calls.append(1)
        return dep.deposit(*a)

    edep, state, oflow, steps = rt.make_trace_fn(cfg, counting)(
        ctx.field4, s0)
    assert not bool(state.alive.any())
    assert steps == len(calls) < cfg.nt and steps % 7 == 0
    # no ray alive at all: nothing runs
    dead = s0.map(lambda a: a)
    dead.alive = torch.zeros_like(s0.alive)
    _, _, _, steps0 = rt.make_trace_fn(cfg)(ctx.field4, dead)
    assert steps0 == 0
