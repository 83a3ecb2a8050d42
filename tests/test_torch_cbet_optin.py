"""The port's CBET opt-ins against the JAX package, at two-beam 24^3 scale:
the trilinear window model (``cbet_gain_mode="kernel"``, K4 "tri"'s plain
version) against the JAX scatter trace and the float64 oracle, its solve;
light iterations (K4's gain-only form) against full ones; Anderson mixing;
the window-strided lookup against the JAX Pallas (interpret) trace; the
batched lookup against the per-step one; the gain-only plain versions; and
the JAX package's rules for the switches."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbet_raytracing_3d_tpu.config import Config as JConfig
from cbet_raytracing_3d_tpu.models import cbet as jcbet
from cbet_raytracing_3d_tpu.models import raytracer as jrt
from cbet_raytracing_3d_tpu.oracle import oracle_cbet_iteration
from cbet_raytracing_3d_tpu.parallel.sharding import pad_rays as jpad
from cbet_raytracing_3d_tpu_torch import cli, convert
from cbet_raytracing_3d_tpu_torch.config import Config
from cbet_raytracing_3d_tpu_torch.models import cbet
from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
from cbet_raytracing_3d_tpu_torch.ops import deposit as dep
from cbet_raytracing_3d_tpu_torch.ops import gain_deposit as gdep
from cbet_raytracing_3d_tpu_torch.parallel.sharding import pad_rays
from cbet_raytracing_3d_tpu_torch.runner import (CBET_MARGIN,
                                                 estimate_device_bytes, run,
                                                 traced_slots)

torch.set_num_threads(1)

SMALL = dict(nbeams=2, rays_per_zone=1, nx=24, ny=24, nz=24, dtype="float64")
# whole windows of 4 steps in every chunk: nt = 96 at 24^3
WIN = dict(chunk_steps=8, deposit_batch_steps=4)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _smooth_gain(cfg, scale, seed=3):
    """tests/test_cbet.py:1063-1069: a smooth field of both signs."""
    rng = np.random.default_rng(seed)
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
    return tpg, state0, bid


def _both_traces(kw, g, backend="scatter", **jkw):
    """One gain-coupled trace of the same inputs through the JAX package
    (``backend``) and the port (the wrappers on CPU tensors: the plain
    versions)."""
    jcfg = JConfig(**kw)
    jctx = jrt.prepare(jcfg)
    tpg, jstate0, jbid = _jax_layout(jcfg, jctx)
    tr = jax.jit(jcbet.make_cbet_trace_fn(jcfg, jctx, backend=backend,
                                          tiles_per_group=tpg, **jkw)())
    out_j = tr(jctx.field4, jnp.asarray(g), jnp.asarray(jbid), jstate0)
    cfg = Config(**kw)
    field4, state0, bid, gain = convert.from_jax_cbet(
        np.asarray(jctx.field4), convert.state_to_numpy(jstate0), jbid, g)
    ctx = rt.prepare(cfg)
    out_p = cbet.make_cbet_trace_fn(cfg, ctx, tiles_per_group=tpg)(
        field4, gain, bid, state0)
    return out_j, out_p, (cfg, ctx, tpg, (field4, gain, bid, state0))


@pytest.mark.parametrize("scale", [2e-2, 20.0])
def test_tri_trace_matches_jax_scatter(scale):
    """cbet_gain_mode="kernel", one trace with a fixed synthetic gain, f64:
    the port's K4 "tri" plain version inside the port's window trace against
    the JAX XLA window form (8-corner gathers from the zero-ghost padded
    table) at 1e-10.  Scale 20 makes g*ds ~0.1: the clip engages and rays
    die mid-window."""
    before = gdep.TRI_LAUNCHES
    (e_j, i_j, st_j, of_j), (e_p, i_p, st_p, of_p, steps), port = \
        _both_traces(dict(SMALL, **WIN, cbet_gain_mode="kernel"),
                     _smooth_gain(Config(**SMALL), scale))
    launched = port[-1][-1].alive.numpy()
    assert gdep.TRI_LAUNCHES == before          # CPU: the plain versions
    assert int(of_j) == int(of_p) == 0 and steps > 0
    assert _rel_l2(e_p.numpy(), np.asarray(e_j)) < 1e-10
    assert _rel_l2(i_p.numpy(), np.asarray(i_j)) < 1e-10
    np.testing.assert_allclose(st_p.uray.numpy()[launched],
                               np.asarray(st_j.uray)[launched], rtol=1e-10)
    assert np.array_equal(st_p.alive.numpy(), np.asarray(st_j.alive))


def test_tri_trace_matches_oracle(profiles):
    """tests/test_cbet.py::test_cbet_window_kernel_model_matches_oracle for
    the port: the uncoupled intensity and the retrace under the window
    model with the f64 oracle's gain, against the per-ray f64 oracle
    (window = the deposit batch) at < 1e-8."""
    batch = WIN["deposit_batch_steps"]
    cfg = Config(**SMALL, **WIN, tiles_per_block=1, cbet_gain_mode="kernel")
    ctx = rt.prepare(cfg)
    i0_o, gain_o, edep1_o, i1_o = oracle_cbet_iteration(
        JConfig(**dataclasses.asdict(cfg)), profiles, ctx.beam_norm,
        window=batch)
    state0 = pad_rays(ctx.state0, ctx.layout.rays_per_tile)
    bid = np.maximum(ctx.beam_id, 0).astype(np.int32)
    bid = torch.from_numpy(np.pad(bid, (0, state0.n - bid.shape[0])))
    P = cfg.nx * cfg.ny * cfg.nz
    tr = cbet.make_cbet_trace_fn(cfg, ctx)
    _, i0_p, _, _, _ = tr(ctx.field4, torch.zeros((2, P), dtype=torch.float64),
                          bid, state0)
    assert _rel_l2(i0_p.numpy(), i0_o.reshape(2, P)) < 1e-8
    edep1_p, i1_p, _, of, _ = tr(ctx.field4,
                                 torch.from_numpy(gain_o.reshape(2, P)), bid,
                                 state0)
    assert int(of) == 0
    assert _rel_l2(edep1_p.numpy(), edep1_o) < 1e-8
    assert _rel_l2(i1_p.numpy(), i1_o.reshape(2, P)) < 1e-8
    assert np.abs(i1_o - i0_o).max() > 0


def test_tri_solve_converges_near_lookup():
    """tests/test_cbet.py::test_cbet_window_kernel_solve_converges for the
    port, on its 40^3 scene: the trilinear window model converges, and its
    distance from the lookup solve stays below the CBET effect itself (two
    discretizations of one gain model).  Not at 24^3: there the cells are so
    coarse that the JAX package's own solves sit 2.3e-2 apart against an
    effect of 7.1e-3 (the port's agree with them to 2e-9)."""
    cfg = Config(nbeams=2, rays_per_zone=1, nx=40, ny=40, nz=40,
                 dtype="float64", chunk_steps=10, deposit_batch_steps=5,
                 cbet_max_iters=12, cbet_tol=1e-3)
    ctx = rt.prepare(cfg)
    res_l = cbet.cbet_solve(cfg, ctx, "cpu")
    res_k = cbet.cbet_solve(cfg.replace(cbet_gain_mode="kernel"), ctx, "cpu")
    assert res_l.converged and res_k.converged
    assert res_k.stats["gain_mode"] == "kernel"
    base, _ = rt.trace(ctx, "cpu")
    effect = _rel_l2(res_l.edep, base)
    dev = _rel_l2(res_k.edep, res_l.edep)
    assert effect > 1e-4, "no CBET effect in the test scene"
    assert dev < effect, (dev, effect)


@pytest.mark.parametrize("mode", ["kernel_cell", "kernel", "lookup"])
def test_light_iterations_equal_full(mode):
    """tests/test_cbet.py::test_cbet_light_iterations_identical and
    ::test_cbet_light_iterations_lookup_grouped for the port: the light
    solve (iterations without the edep deposit, then one full trace with
    the last gain) equals the full solve bit for bit on the CPU."""
    cfg = Config(**SMALL, **WIN, cbet_max_iters=3, cbet_tol=1e-9,
                 cbet_gain_mode=mode)
    ctx = rt.prepare(cfg)
    full = cbet.cbet_solve(cfg.replace(cbet_light_iterations=False), ctx,
                           "cpu")
    light = cbet.cbet_solve(cfg.replace(cbet_light_iterations=True), ctx,
                            "cpu")
    assert light.stats["light_iterations"]
    assert not full.stats["light_iterations"]
    assert light.iterations == full.iterations == 3
    assert light.history == full.history
    assert np.array_equal(light.edep, full.edep)
    assert np.array_equal(light.intensity, full.intensity)
    for key in ("rays_terminated", "rays_alive_at_end", "energy_absorbed"):
        assert light.stats[key] == full.stats[key], key
    # the iterations' traces, then the final full one with the same steps
    assert len(light.stats["trace_steps"]) == light.iterations + 2
    assert light.stats["trace_steps"][-1] == full.stats["trace_steps"][-1]
    assert light.stats["final_trace_seconds"] > 0


def test_light_iterations_refused_where_unbatched():
    """tests/test_cbet.py::test_cbet_light_iterations_unsupported_raises:
    explicit light iterations on the per-step path fail loud; auto (None)
    runs full iterations there."""
    cfg = Config(**SMALL, cbet_max_iters=1, cbet_light_iterations=True)
    assert not cbet.batched(cfg)
    ctx = rt.prepare(cfg)
    with pytest.raises(ValueError, match="edep_skip|light"):
        cbet.cbet_solve(cfg, ctx, "cpu")
    with pytest.raises(ValueError, match="edep_skip|light"):
        cbet.make_cbet_trace_fn(cfg.replace(cbet_light_iterations=None), ctx,
                                light=True)
    res = cbet.cbet_solve(cfg.replace(cbet_light_iterations=None), ctx, "cpu")
    assert not res.stats["light_iterations"]


def test_anderson_same_fixed_point_in_fewer_iterations():
    """tests/test_cbet.py::test_cbet_accel_anderson_fixed_point for the
    port: Anderson(m=1) converges to the plain iteration's fixed point in
    <= iterations, through ONE cached solver; its first update is the plain
    relaxed step, so history[0] and history[1] are bit-equal."""
    cfg = Config(**SMALL, cbet_tol=1e-5, cbet_max_iters=40)
    ctx = rt.prepare(cfg)
    cbet._SOLVER_CACHE.clear()
    plain = cbet.cbet_solve(cfg, ctx, "cpu")
    acc = cbet.cbet_solve(cfg.replace(cbet_accel="anderson"), ctx, "cpu")
    assert len(cbet._SOLVER_CACHE) == 1, "accel must share one solver"
    assert plain.converged and acc.converged
    assert acc.iterations <= plain.iterations
    assert acc.history[:2] == plain.history[:2]
    assert acc.history[2] != plain.history[2]
    assert acc.stats["accel"] == "anderson"
    # both are within cbet_tol of the same fixed point
    assert _rel_l2(acc.edep, plain.edep) < 1e-4


def test_anderson_matches_jax_with_its_gain():
    """The port's Anderson solve against JAX ``cbet_solve(backend=
    "scatter")`` with ``cbet_accel="anderson"`` in f64, with the JAX XLA
    gain reduction injected (its CPU f32 arithmetic contracts into FMAs,
    ROADMAP "Faults"): the same iterations, history and fields at 1e-10."""
    kw = dict(SMALL, cbet_max_iters=6, cbet_tol=1e-6, cbet_accel="anderson")
    jcfg = JConfig(**kw)
    jres = jcbet.cbet_solve(jcfg, jrt.prepare(jcfg), backend="scatter")
    jgain = jcbet.make_gain_fn(jcfg, jrt.prepare(jcfg), backend="xla")

    def gain_op(pu, rp, inten):
        return torch.from_numpy(np.array(jgain(jnp.asarray(inten.numpy()))))

    ops = dataclasses.replace(cbet.plain_ops(), gain=gain_op)
    cfg = Config(**kw)
    res = cbet.cbet_solve(cfg, rt.prepare(cfg), "cpu", ops=ops)
    assert res.iterations == jres.iterations >= 3   # the secant steps ran
    np.testing.assert_allclose(res.history, jres.history, rtol=1e-10)
    assert _rel_l2(res.edep, jres.edep) < 1e-10
    assert _rel_l2(res.intensity, jres.intensity) < 1e-10


def test_anderson_degenerate_secant_is_the_plain_step():
    """gamma is 0 on a degenerate secant (no change of the residual), so
    the update is the relaxed step; gamma is clipped to [-2, 2]."""
    rng = np.random.default_rng(7)
    x, prev_x = (torch.from_numpy(rng.uniform(1, 2, (2, 50)))
                 for _ in range(2))
    x_new = torch.from_numpy(rng.uniform(1, 2, (2, 50)))
    f = x_new - x
    _, _, got, f_cur = cbet._accel_next(x_new, x, prev_x, f.clone(), 0.9)
    assert torch.equal(f_cur, f)
    assert torch.allclose(got, x + 0.9 * f, rtol=0, atol=0)
    # a tiny secant (|df| << |f|) would give |gamma| >> 2: clipped to 2
    _, _, got, _ = cbet._accel_next(x_new, x, prev_x, f * (1 - 1e-6), 0.9)
    want = (x + 0.9 * f) - 2.0 * ((x - prev_x) + 0.9 * (f * 1e-6))
    assert torch.allclose(got, want, rtol=1e-12, atol=0)


def test_stride_trace_matches_jax_pallas():
    """cbet_gain_stride = deposit_batch_steps: one gain lookup at the
    window-entry cell for the whole window, against the JAX batched grouped
    Pallas trace (interpret, precise, exact boundary, tiles_per_block=1),
    the only JAX path with this model.  The ray energies carry the gain
    model and agree to rounding (1e-12); the intensity comes from the
    precise grouped kernel's f32 (measured 5e-8; bar 1e-6).  The JAX edep
    deposit of that path is the bf16 hi/lo build, which sits 6.3e-4 from
    the exact scatter deposit on this scene at stride 1 as well (measured),
    so edep is held at 1e-3."""
    kw = dict(SMALL, **WIN, tiles_per_block=1, cbet_gain_stride=4,
              deposit_boundary_exact=True)
    g = _smooth_gain(Config(**SMALL), 2e-2)
    (e_j, i_j, st_j, of_j), (e_p, i_p, st_p, of_p, steps), port = \
        _both_traces(kw, g, backend="pallas_interpret", kernel_precise=True)
    cfg, ctx, tpg, args = port
    launched = args[-1].alive.numpy()
    assert int(of_j) == int(of_p) == 0 and steps > 0
    np.testing.assert_allclose(st_p.uray.numpy()[launched],
                               np.asarray(st_j.uray)[launched], rtol=1e-12)
    assert np.array_equal(st_p.alive.numpy(), np.asarray(st_j.alive))
    assert _rel_l2(i_p.numpy(), np.asarray(i_j)) < 1e-6
    assert _rel_l2(e_p.numpy(), np.asarray(e_j)) < 1e-3
    # and it is another model than the per-step lookup
    e_1 = cbet.make_cbet_trace_fn(cfg.replace(cbet_gain_stride=1), ctx,
                                  tiles_per_group=tpg)(*args)[0]
    assert _rel_l2(e_p.numpy(), e_1.numpy()) > 1e-5


def _count_ops():
    """The plain versions, counting their calls."""
    calls = {"deposit": 0, "grouped": 0}
    plain = cbet.plain_ops()

    def deposit(*a):
        calls["deposit"] += 1
        return plain.deposit(*a)

    def grouped(*a):
        calls["grouped"] += 1
        return plain.grouped(*a)

    return dataclasses.replace(plain, deposit=deposit, grouped=grouped), calls


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_batched_lookup_equals_per_step(dtype):
    """The batched lookup (one K1 and one K2 call per window of step-major
    rows) equals the per-step lookup (a call per step) bit for bit on the
    CPU: the same step physics, and the plain deposits add the rows in the
    same order.  It makes a quarter of the deposit calls."""
    cfg = Config(**dict(SMALL, **WIN, dtype=dtype))
    ctx = rt.prepare(cfg)
    solver = cbet._build_solver(cfg, ctx, torch.device("cpu"),
                                cbet.plain_ops())
    tpg = solver.state0.n // (cfg.nbeams * ctx.layout.rays_per_tile)
    gain = torch.from_numpy(_smooth_gain(cfg, 20.0)).to(getattr(torch, dtype))
    outs = {}
    for b in (1, 4):
        c = cfg.replace(deposit_batch_steps=b)
        assert cbet.batched(c) == (b > 1)
        ops, calls = _count_ops()
        outs[b] = cbet.make_cbet_trace_fn(c, ctx, tiles_per_group=tpg,
                                          ops=ops)(
            ctx.field4.to(gain.dtype), gain, solver.bid, solver.state0)
        outs[b] += (calls,)
    (e1, i1, s1, of1, n1, c1), (e4, i4, s4, of4, n4, c4) = outs[1], outs[4]
    assert n1 == n4 and int(of1) == int(of4) == 0
    assert torch.equal(e1, e4) and torch.equal(i1, i4)
    assert torch.equal(s1.uray, s4.uray) and torch.equal(s1.alive, s4.alive)
    assert all(torch.equal(a, b) for a, b in zip(s1.cell, s4.cell))
    assert c1 == {"deposit": n1, "grouped": n1}
    assert c4 == {"deposit": n4 // 4, "grouped": n4 // 4}


def _window_args(tri, dtype=torch.float64, off_grid=0, scale=20.0):
    """A mid-trace window of the SMALL scene's CBET layout (K4's
    arguments after ``edep``), with a smooth gain; ``off_grid`` live rows
    get a deposit cell outside the grid."""
    cfg = Config(**SMALL, **WIN)
    ctx = rt.prepare(cfg)
    solver = cbet._build_solver(cfg, ctx, torch.device("cpu"),
                                cbet.plain_ops())
    state = solver.state0.map(lambda a: a.to(dtype) if a.is_floating_point()
                              else a)
    field4 = ctx.field4.to(dtype)
    step = rt.make_deferred_step_fn(cfg)
    for _ in range(24):
        state, _ = step(state, field4)
    st, w = cbet.make_window_advance(cfg)(state, field4)
    live = torch.nonzero(w["inc"][0] != 0).reshape(-1)[:off_grid]
    w["cx"][0, live] = cfg.nx + 5
    gain = torch.from_numpy(_smooth_gain(cfg, scale)).to(dtype)
    rpg = solver.state0.n // cfg.nbeams
    rows = (w["cx"], w["cy"], w["cz"], w["fx"], w["fy"], w["fz"], w["inc"],
            w["ds"], w["u_nogain"], st.uray_init)
    lags = () if tri else (w["lcx"], w["lcy"], w["lcz"])
    return cfg, rows + lags + (gain, rpg, cbet.GAIN_CLIP, cfg.stop_fraction)


@pytest.mark.parametrize("tri", [False, True])
@pytest.mark.parametrize("off_grid", [0, 3])
def test_gain_only_plain_equals_full_plain(tri, off_grid):
    """K4's gain-only plain version: the full plain version's gamma, uout
    and overflow (deposit corners off the grid still counted), and edep
    left untouched."""
    cfg, args = _window_args(tri, off_grid=off_grid)
    fn = (gdep.deposit_gain_window_tri_reference if tri
          else gdep.deposit_gain_window_reference)
    e_f, of_f, g_f, u_f = fn(torch.zeros(cfg.edep_shape, dtype=torch.float64),
                             *args)
    e0 = torch.full(cfg.edep_shape, 0.25, dtype=torch.float64)
    e_g, of_g, g_g, u_g = fn(e0.clone(), *args, gain_only=True)
    assert torch.equal(e_g, e0) and float(e_f.abs().sum()) > 0
    assert int(of_g) == int(of_f) == off_grid
    assert torch.equal(g_g, g_f) and torch.equal(u_g, u_f)
    assert 0 < int((g_f[-1] == 0).sum()) < g_f.shape[1]
    # the wrappers take the plain versions for CPU tensors
    wrap = gdep.deposit_gain_window_tri if tri else gdep.deposit_gain_window
    before = (gdep.LAUNCHES, gdep.TRI_LAUNCHES, gdep.GAIN_ONLY_LAUNCHES)
    e_w, of_w, g_w, u_w = wrap(e0.clone(), *args, gain_only=True)
    assert torch.equal(e_w, e0) and torch.equal(g_w, g_f)
    assert before == (gdep.LAUNCHES, gdep.TRI_LAUNCHES,
                      gdep.GAIN_ONLY_LAUNCHES)


def test_tri_plain_samples_the_deposit_corners():
    """K4 "tri"'s gain sample is the transpose of the deposit: with unit
    increments and no deaths, ``g = sum_c w_c G[node_c]`` equals the dot
    product of the gain table (zero ghosts) with the rows' own deposit."""
    cfg, args = _window_args(True, scale=1e-2)
    cx, cy, cz, fx, fy, fz, inc, ds, u_ng, uinit, gain, rpg, clip, _ = args
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    j, r = 1, int(torch.nonzero(inc[1] != 0)[0, 0])
    one = torch.ones(1, dtype=torch.float64)
    grid = torch.zeros(cfg.edep_shape, dtype=torch.float64)
    dep.deposit_reference(grid, cx[j, r:r + 1], cy[j, r:r + 1],
                          cz[j, r:r + 1], fx[j, r:r + 1], fy[j, r:r + 1],
                          fz[j, r:r + 1], one)
    table = torch.nn.functional.pad(
        gain[r // rpg].reshape(nx, ny, nz), (1, 1, 1, 1, 1, 1))
    want = float((grid * table).sum())
    # unit ds and a stop rule that never fires: gamma_j = prod exp(g_k)
    unit = torch.ones_like(ds)
    _, _, gam, _ = gdep.deposit_gain_window_tri_reference(
        torch.zeros(cfg.edep_shape, dtype=torch.float64), cx, cy, cz, fx, fy,
        fz, inc, unit, torch.ones_like(u_ng), uinit, gain, rpg, 10.0, 0.0)
    g = torch.log(gam[j, r] / gam[j - 1, r])
    assert abs(float(g) - want) <= 1e-12 * max(1.0, abs(want))
    assert want != 0


@pytest.mark.parametrize("over,error", [
    (dict(cbet_gain_mode="kernel"), None),
    (dict(cbet_light_iterations=True), None),
    (dict(cbet_light_iterations=True, cbet_gain_mode="kernel_cell"), None),
    (dict(cbet_accel="anderson"), None),
    (dict(cbet_gain_stride=4), None),
    (dict(cbet_gain_stride=3), "cbet_gain_stride must be 1 or"),
    (dict(cbet_gain_stride=4, cbet_gain_mode="kernel"), "subsumes"),
    (dict(cbet_gain_mode="kernel", chunk_steps=10), "deposit_batch_steps"),
    (dict(cbet_gain_stride=4, chunk_steps=10), "batched deposit path"),
    (dict(cbet_accel="secant"), "cbet_accel"),
])
def test_switch_rules(over, error):
    """No opt-in raises NotImplementedError any more; the JAX package's
    rules (models/cbet.py:498-532) raise ValueError before any trace."""
    cfg = Config(**SMALL, **WIN, cbet_max_iters=1).replace(**over)
    if error is None:
        cbet.check_cbet_config(cfg)
        res = run(cfg, with_cbet=True, device="cpu", verbose=False)
        assert res.cbet.iterations == 1
        assert np.isfinite(res.cbet.edep).all() and res.cbet.edep.sum() > 0
        assert res.cbet.stats["light_iterations"] == bool(
            cfg.cbet_light_iterations)
    else:
        with pytest.raises(ValueError, match=error):
            run(cfg, with_cbet=True, device="cpu", verbose=False)


@pytest.mark.parametrize("flags", [
    ["--cbet-gain-mode", "kernel", "--cbet-light-iterations", "true"],
    ["--cbet-accel", "anderson", "--cbet-gain-stride", "4",
     "--cbet-light-iterations", "true"],
])
def test_cli_run_cbet_optins(flags, tmp_path):
    base = ["--nbeams", "2", "--rays-per-zone", "1", "--nx", "24", "--ny",
            "24", "--nz", "24", "--dtype", "float64", "--chunk-steps", "8",
            "--deposit-batch-steps", "4", "--cbet-max-iters", "2"]
    rc = cli.main(["run", *base, *flags, "--cbet", "--device", "cpu",
                   "--out-dir", str(tmp_path), "--formats", "npz,json",
                   "--quiet"])
    assert rc == 0
    st = json.load(open(tmp_path / "edep.json"))["cbet"]["stats"]
    assert st["light_iterations"] is True
    opts = dict(zip(flags[::2], flags[1::2]))
    assert st["gain_mode"] == opts.get("--cbet-gain-mode", "lookup")
    assert st["accel"] == opts.get("--cbet-accel", "none")
    with np.load(tmp_path / "edep.npz") as z:
        assert z["cbet_edep"].sum() > 0 and int(z["cbet_iterations"]) == 2


def test_memory_estimate_counts_the_optins():
    """Anderson adds three intensity-sized buffers; the tri window's
    streams are the kernel_cell window's; no padded gain table is counted;
    the batched lookup counts its per-step rows twice (eight rows, three
    int32 and five floats, and their concatenation, against the window
    advance's 13 streams of the kernel modes).  The CBET stage carries its
    margin (``runner.CBET_MARGIN``) on every term and is rounded down to
    whole bytes, so the differences hold to a byte."""
    base = Config()
    look = estimate_device_bytes(base, with_cbet=True)
    acc = estimate_device_bytes(base.replace(cbet_accel="anderson"), True)
    assert acc - look == pytest.approx(CBET_MARGIN * 3 * 60 * 10 ** 6 * 4,
                                       abs=1)
    n = traced_slots(base)
    cell = estimate_device_bytes(base.replace(cbet_gain_mode="kernel_cell"),
                                 True)
    tri = estimate_device_bytes(base.replace(cbet_gain_mode="kernel"), True)
    assert cell == tri
    assert look - cell == pytest.approx(
        CBET_MARGIN * 5 * n * (2 * (3 * 4 + 5 * 4) - 13 * 4), abs=1)
