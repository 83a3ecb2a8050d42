"""The composed (resumable) CBET solve of the port on the CPU
(``models/cbet_composed.py``) and the composed flow of its CLI: against the
port's segmented lookup ``cbet_solve``, against the JAX package's
``cbet_solve_composed`` (run as its own tests run it), resumed solves
against uninterrupted ones bit for bit, serial beam groups, the refusals,
and the CLI's rules."""

import json

import numpy as np
import pytest
import torch

from cbet_raytracing_3d_tpu.config import Config as JConfig
from cbet_raytracing_3d_tpu.models import cbet_composed as jcomposed
from cbet_raytracing_3d_tpu.models import raytracer as jrt
from cbet_raytracing_3d_tpu_torch import cli, runner
from cbet_raytracing_3d_tpu_torch.config import Config
from cbet_raytracing_3d_tpu_torch.models import cbet, cbet_composed
from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
from cbet_raytracing_3d_tpu_torch.models.cbet_composed import \
    cbet_solve_composed
from cbet_raytracing_3d_tpu_torch.ops import deposit as dep_ops
from cbet_raytracing_3d_tpu_torch.utils import checkpoint as ck

torch.set_num_threads(1)

# tests/test_cbet_composed.py's scene: 4 beams so that 1, 2 and 4 groups
# divide; 8-step chunks carry the 4-step deposit window
COMP = dict(nbeams=4, rays_per_zone=1, nx=40, ny=40, nz=40,
            cbet_max_iters=8, cbet_tol=1e-3, dtype="float32",
            tiles_per_block=1, chunk_steps=8, deposit_batch_steps=4)
ACCOUNTING = cbet_composed.ACCOUNTING_KEYS


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope="module")
def scene():
    cfg = Config(**COMP)
    return cfg, rt.prepare(cfg)


@pytest.fixture(scope="module")
def full(scene):
    """The uninterrupted solve, two beam groups."""
    cfg, ctx = scene
    return cbet_solve_composed(cfg, ctx, device="cpu", beam_groups=2,
                               verbose=False)


def _solve(scene, **kw):
    cfg, ctx = scene
    kw.setdefault("beam_groups", 2)
    cfg = cfg.replace(**kw.pop("cfg", {}))
    return cbet_solve_composed(cfg, ctx, device="cpu", verbose=False, **kw)


def _same(a, b):
    assert a.iterations == b.iterations and a.converged == b.converged
    assert a.history == b.history
    assert np.array_equal(a.intensity, b.intensity)
    assert np.array_equal(a.edep, b.edep)
    for key in ACCOUNTING + ("edep_total", "beam_groups"):
        assert a.stats[key] == b.stats[key], key


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("float64", 1e-12)])
def test_composed_matches_segmented_lookup_solve(dtype, tol):
    """One group: the port's segmented lookup ``cbet_solve`` -- the same
    iterations, history, fields and accounting."""
    cfg = Config(**dict(COMP, dtype=dtype))
    ctx = rt.prepare(cfg)
    mono = cbet.cbet_solve(cfg.replace(cbet_segmented=True), ctx, "cpu")
    comp = cbet_solve_composed(cfg, ctx, device="cpu", beam_groups=1,
                               verbose=False)
    assert comp.converged and mono.converged
    assert comp.iterations == mono.iterations >= 2
    np.testing.assert_allclose(comp.history, mono.history, rtol=1e-5)
    assert _rel_l2(comp.intensity, mono.intensity) <= tol
    assert _rel_l2(comp.edep, mono.edep) <= tol
    for key in ACCOUNTING:
        assert comp.stats[key] == pytest.approx(mono.stats[key], rel=1e-6)
    s = comp.stats
    assert s["intensity_mode"] == "grouped_composed" and s["segmented"]
    assert s["gain_mode"] == "lookup" and s["beam_groups"] == 1
    assert s["device"] == "cpu" and len(s["iter_seconds"]) == \
        comp.iterations + 1
    assert s["chunks_per_iteration"] == rt.chunk_lengths(cfg)[1]
    assert s["edep_total"] == pytest.approx(comp.edep.sum())
    assert len(s["tile_widths"]) >= 2


def test_composed_matches_jax_composed(tmp_path, profiles, scene, full):
    """The JAX package's ``cbet_solve_composed`` on the same config, run as
    its own tests run it on the CPU (interpreted Pallas kernels, whose
    trilinear weights are bf16: hence the bars of 2e-3, those of the JAX
    package's own kernel-against-scatter test; measured 6e-4)."""
    jcfg = JConfig(**COMP, cbet_segmented=True, cbet_plan_headroom=0.0)
    jres = jcomposed.cbet_solve_composed(
        jcfg, jrt.prepare(jcfg, profiles), backend="pallas_interpret",
        beam_groups=2, cache_dir=str(tmp_path), verbose=False)
    assert full.iterations == jres.iterations
    assert full.converged == jres.converged
    np.testing.assert_allclose(full.history, jres.history, rtol=2e-3)
    assert _rel_l2(full.intensity, jres.intensity) < 2e-3
    assert _rel_l2(full.edep, jres.edep) < 2e-3
    assert full.stats["rays_launched"] == jres.stats["rays_launched"]
    assert full.stats["rays_terminated"] == jres.stats["rays_terminated"]


@pytest.mark.parametrize("stop", [1, 2, 3])
def test_resume_bit_equal(tmp_path, scene, full, stop):
    """Stop after ``stop`` iterations (iteration 0 counts), resume: the
    uninterrupted solve bit for bit."""
    path = str(tmp_path / "cbet.npz")
    out = _solve(scene, checkpoint_path=path, stop_after_iterations=stop)
    assert out is None
    cfg, _ = scene
    fp = cbet_composed.cbet_fingerprint(cfg, 2, "cpu")
    it, inten, hist, edep, acct = ck.load_cbet_checkpoint(path, fp, "cpu")
    assert it == stop - 1 and len(hist) == stop - 1 and edep is None
    assert inten.shape == (4, 40 ** 3) and inten.dtype == torch.float32
    _same(_solve(scene, checkpoint_path=path, resume=True), full)


def test_resume_after_raising_max_iters(tmp_path, scene, full):
    """A solve that ran out of iterations leaves a checkpoint that a larger
    ``cbet_max_iters`` (or another ``cbet_tol``) continues from: they are
    not part of the fingerprint.  Without raising it the resume raises."""
    path = str(tmp_path / "cbet.npz")
    short = _solve(scene, cfg=dict(cbet_max_iters=2), checkpoint_path=path)
    assert short.iterations == 2 and not short.converged
    assert short.history == full.history[:2]
    with pytest.raises(RuntimeError, match="raise cbet_max_iters"):
        _solve(scene, cfg=dict(cbet_max_iters=2), checkpoint_path=path,
               resume=True)
    _same(_solve(scene, checkpoint_path=path, resume=True), full)
    cfg, _ = scene
    assert cbet_composed.cbet_fingerprint(cfg, 2, "cpu") == \
        cbet_composed.cbet_fingerprint(
            cfg.replace(cbet_max_iters=2, cbet_tol=0.5), 2, "cpu")


def test_resume_on_converged_checkpoint_runs_no_trace(tmp_path, scene, full,
                                                      monkeypatch):
    """The converged iteration's checkpoint carries the edep and the
    accounting scalars: a resume landing there returns the whole result
    without a deposit."""
    path = str(tmp_path / "cbet.npz")
    done = _solve(scene, checkpoint_path=path)
    _same(done, full)

    def no_trace(*a, **k):
        raise AssertionError("a resume on the converged checkpoint traced")

    for name in ("deposit", "deposit_grouped", "deposit_reference",
                 "deposit_grouped_reference"):
        monkeypatch.setattr(dep_ops, name, no_trace)
    again = _solve(scene, checkpoint_path=path, resume=True)
    _same(again, full)
    assert all(k in again.stats for k in ACCOUNTING)
    assert again.stats["iter_seconds"] == []
    assert again.stats["tile_widths"] == []


def test_checkpoints_refused(tmp_path, scene, full):
    """Another grouping's, another config's and a trace checkpoint are
    refused."""
    path = str(tmp_path / "cbet.npz")
    _solve(scene, checkpoint_path=path, stop_after_iterations=1)
    with pytest.raises(ValueError, match="fingerprint"):
        _solve(scene, checkpoint_path=path, resume=True, beam_groups=4)
    with pytest.raises(ValueError, match="fingerprint"):
        _solve(scene, cfg=dict(cbet_relax=0.5), checkpoint_path=path,
               resume=True)
    cfg, _ = scene
    tpath = str(tmp_path / "trace.npz")
    runner.run_composed(cfg, device="cpu", verbose=False,
                        checkpoint_path=tpath, stop_after_chunks=1)
    with pytest.raises(ValueError, match="not a cbet checkpoint"):
        _solve(scene, checkpoint_path=tpath, resume=True)
    with pytest.raises(ValueError, match="checkpoint_path"):
        _solve(scene, resume=True)


@pytest.mark.parametrize("groups", [1, 4])
def test_beam_groups_change_no_value(scene, full, groups):
    """Intensity rows of a group are exact row blocks of the whole, so the
    fixed point is the same bit for bit; edep is summed in another order."""
    res = _solve(scene, beam_groups=groups)
    assert res.iterations == full.iterations
    assert res.history == full.history
    assert np.array_equal(res.intensity, full.intensity)
    assert _rel_l2(res.edep, full.edep) < 1e-6
    assert res.stats["beam_groups"] == groups
    assert res.stats["chunks_per_iteration"] == \
        groups * rt.chunk_lengths(scene[0])[1]
    for key in ("rays_launched", "rays_terminated", "rays_alive_at_end"):
        assert res.stats[key] == full.stats[key]


@pytest.mark.parametrize("over,match", [
    (dict(cbet_gain_mode="kernel_cell"), "lookup model only"),
    (dict(cbet_accel="anderson"), "plain relaxed iteration only"),
    (dict(cbet_light_iterations=True), "cbet_light_iterations"),
    (dict(cbet_gain_stride=4), "samples gain at every step"),
])
def test_composed_refuses_other_models(scene, over, match):
    with pytest.raises(ValueError, match=match):
        _solve(scene, cfg=over)


def test_beam_groups_rules(scene):
    cfg, _ = scene
    with pytest.raises(ValueError, match="does not divide"):
        _solve(scene, beam_groups=3)
    assert cbet_composed.default_beam_groups(cfg) == 1
    big = Config(nx=200, ny=200, nz=200)
    assert cbet_composed.default_beam_groups(big) == \
        jcomposed.default_beam_groups(JConfig(nx=200, ny=200, nz=200),
                                      "pallas") == 2
    # a group's share of the memory estimate
    whole = runner.estimate_device_bytes(big, True)
    assert runner.estimate_device_bytes(big, True, 4) < whole
    assert runner.estimate_device_bytes(big, True, 1) == whole
    with pytest.raises(ValueError, match="does not divide"):
        runner.estimate_device_bytes(big, True, 7)


def test_group_trace_is_a_row_block_of_the_whole(scene):
    """``make_cbet_trace_fn(n_beams=...)``: a block of beams traced alone
    gives the whole trace's intensity rows bit for bit."""
    cfg, ctx = scene
    cfg = cfg.replace(cbet_segmented=True)
    state0, bid, tpg = cbet.solver_state(cfg, ctx, "cpu")
    rng = np.random.default_rng(0)
    P = cfg.nx * cfg.ny * cfg.nz
    gain = torch.from_numpy(
        (1e-3 * rng.standard_normal((cfg.nbeams, P))).astype(np.float32))
    whole = cbet.make_cbet_trace_fn(cfg, ctx, tiles_per_group=tpg)(
        ctx.field4, gain, bid, state0)
    half = cbet.make_cbet_trace_fn(cfg, ctx, tiles_per_group=tpg, n_beams=2)
    n = state0.n // 2
    edep = 0
    for g in range(2):
        sl = slice(g * n, (g + 1) * n)
        e, inodes, st, of, steps = half(
            ctx.field4, gain[2 * g:2 * g + 2], (bid[sl] - 2 * g).clamp(min=0),
            state0.map(lambda a: a[sl]))
        assert torch.equal(inodes, whole[1][2 * g:2 * g + 2])
        assert torch.equal(st.uray, whole[2].uray[sl]) and int(of) == 0
        edep = edep + e
    assert _rel_l2(edep.numpy(), whole[0].numpy()) < 1e-6
    with pytest.raises(ValueError, match="n_beams"):
        cbet.make_cbet_trace_fn(cfg, ctx, n_beams=5)


TINY_FLAGS = ["--nbeams", "2", "--rays-per-zone", "1", "--nx", "24",
              "--ny", "24", "--nz", "24", "--dtype", "float64",
              "--chunk-steps", "8", "--deposit-batch-steps", "4",
              "--cbet-max-iters", "6", "--cbet-tol", "1e-3",
              "--device", "cpu", "--quiet", "--formats", "json,npz"]


@pytest.mark.parametrize("argv,msg", [
    (["--cbet-only"], "--cbet-only requires --cbet"),
    (["--cbet-checkpoint", "c.npz"], "--cbet-checkpoint requires --cbet"),
    (["--resume"], "--resume requires --checkpoint"),
    (["--cbet", "--cbet-only", "--resume"], "--resume requires --checkpoint"),
])
def test_cli_composed_rules(tmp_path, capsys, argv, msg):
    """The JAX CLI's rules: exit code 2 with its message, nothing run."""
    rc = cli.main(["run", *TINY_FLAGS, "--out-dir", str(tmp_path), *argv])
    assert rc == 2 and msg in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


def test_cli_composed_cbet_flow_and_resume(tmp_path):
    """``run --composed --cbet`` end to end on a fresh run (the CBET stage
    reuses the trace stage's scene), then the same with checkpoints and
    ``--resume``, and ``--cbet-only``: the same outputs."""
    def go(out, *more):
        assert cli.main(["run", *TINY_FLAGS, "--out-dir", str(tmp_path / out),
                         "--cbet", *more]) == 0
        with open(tmp_path / out / "edep.json") as f:
            payload = json.load(f)
        return payload, np.load(tmp_path / out / "edep.npz")

    fresh, fresh_npz = go("a", "--composed", "--min-tiles", "4")
    assert fresh["stats"]["segments"] >= 1 and fresh["stats"]["chunks"] >= 1
    assert fresh["cbet"]["stats"]["intensity_mode"] == "grouped_composed"
    assert fresh["cbet"]["iterations"] >= 2
    t, c = str(tmp_path / "t.npz"), str(tmp_path / "c.npz")
    go("b", "--checkpoint", t, "--cbet-checkpoint", c, "--beam-groups", "1")
    again, again_npz = go("c", "--checkpoint", t, "--cbet-checkpoint", c,
                          "--beam-groups", "1", "--resume")
    assert np.array_equal(again_npz["edep"], fresh_npz["edep"])
    assert np.array_equal(again_npz["cbet_edep"], fresh_npz["cbet_edep"])
    assert again["cbet"]["history"] == fresh["cbet"]["history"]
    assert again["cbet"]["stats"]["iter_seconds"] == []     # no trace
    only, only_npz = go("d", "--cbet-only", "--beam-groups", "2")
    assert np.array_equal(only_npz["cbet_intensity"],
                          fresh_npz["cbet_intensity"])
    assert only["stats"]["intensity_mode"] == "grouped_composed"
    assert np.array_equal(only_npz["edep"], only_npz["cbet_edep"])
