"""Checkpoints and resumable traces of the port on the CPU
(``utils/checkpoint.py``, ``TileCompactor.state_dict``,
``raytracer.ChunkedTrace``, ``runner.run_resumable`` / ``run_composed``):
round trips, the atomic write, the refusals (another run's file, the JAX
package's file), and resumed runs against uninterrupted ones bit for bit;
``run_composed`` against the port's ``run`` and against the JAX package's
``run_composed`` on the same config."""

import os

import numpy as np
import pytest
import torch

from cbet_raytracing_3d_tpu.config import Config as JConfig
from cbet_raytracing_3d_tpu import runner as jrunner
from cbet_raytracing_3d_tpu.utils import checkpoint as jck
from cbet_raytracing_3d_tpu_torch import convert
from cbet_raytracing_3d_tpu_torch.config import Config
from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
from cbet_raytracing_3d_tpu_torch.models import tileplan as tp
from cbet_raytracing_3d_tpu_torch.runner import (run, run_composed,
                                                 run_resumable)
from cbet_raytracing_3d_tpu_torch.utils import checkpoint as ck

torch.set_num_threads(1)

# tests/test_runner.py's scene
SMALL = dict(nbeams=2, rays_per_zone=1, nx=32, ny=32, nz=32,
             dtype="float64")
# tests/test_tileplan.py's scene: it loses tiles mid-trace
SCENE = dict(nbeams=2, rays_per_zone=1, nx=40, ny=40, nz=40,
             tiles_per_block=2)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _states_equal(a, b) -> bool:
    pa, pb = convert.state_to_numpy(a), convert.state_to_numpy(b)
    return all(np.array_equal(np.asarray(pa[k]), np.asarray(pb[k]))
               for k in pa)


def _state(rng, n, dtype=torch.float32):
    def f():
        return torch.from_numpy(rng.standard_normal(n)).to(dtype)

    def i():
        return torch.from_numpy(rng.integers(0, 30, n).astype(np.int32))

    return rt.RayState(frac=(f(), f(), f()), vel=(f(), f(), f()),
                       kick=(f(), f(), f()), uray=f(), uray_init=f(),
                       cell=(i(), i(), i()),
                       alive=torch.from_numpy(rng.random(n) < 0.5))


def _same_result(a, b):
    assert np.array_equal(a.edep, b.edep)
    assert a.stats == b.stats


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_trace_checkpoint_round_trip(tmp_path, dtype):
    rng = np.random.default_rng(0)
    state = _state(rng, 96, dtype)
    master = torch.from_numpy(rng.standard_normal((5, 6, 7)))
    path = str(tmp_path / "t.npz")
    ck.save_checkpoint(path, "fp", 3, 24, master, state, 2)
    ci, steps, m2, s2, of = ck.load_checkpoint(path, "fp", "cpu")
    assert (ci, steps, of) == (3, 24, 2)
    assert torch.equal(m2, master) and m2.dtype == torch.float64
    assert _states_equal(s2, state) and s2.uray.dtype == dtype
    assert s2.alive.dtype == torch.bool and s2.cell[0].dtype == torch.int32


@pytest.mark.parametrize("with_full", [False, True])
def test_composed_checkpoint_round_trip(tmp_path, with_full):
    rng = np.random.default_rng(1)
    state, full = _state(rng, 64), _state(rng, 128)
    comp = {"tiles": torch.tensor([0, 2, 5, 7]), "widths": [8, 4],
            "full": full if with_full else None}
    master = torch.from_numpy(rng.standard_normal((4, 4, 4)))
    path = str(tmp_path / "c.npz")
    ck.save_composed_checkpoint(path, "fp", 2, 16, master, state, 0, comp)
    ci, steps, m2, s2, of, c2 = ck.load_composed_checkpoint(path, "fp", "cpu")
    assert (ci, steps, of) == (2, 16, 0) and torch.equal(m2, master)
    assert _states_equal(s2, state)
    assert torch.equal(c2["tiles"], comp["tiles"])
    assert c2["tiles"].dtype == torch.int64 and c2["widths"] == [8, 4]
    if with_full:
        assert _states_equal(c2["full"], full)
    else:
        assert c2["full"] is None


@pytest.mark.parametrize("converged", [False, True])
def test_cbet_checkpoint_round_trip(tmp_path, converged):
    rng = np.random.default_rng(2)
    inten = torch.from_numpy(rng.random((3, 50)).astype(np.float32))
    edep = rng.random((4, 4, 4)) if converged else None
    acct = {"rays_launched": 12, "energy_absorbed": 0.25} if converged \
        else None
    path = str(tmp_path / "b.npz")
    ck.save_cbet_checkpoint(path, "fp", 4, inten, [0.5, 0.25], edep, acct)
    it, i2, hist, e2, a2 = ck.load_cbet_checkpoint(path, "fp", "cpu")
    assert it == 4 and torch.equal(i2, inten) and hist == [0.5, 0.25]
    if converged:
        assert np.array_equal(e2, edep) and a2 == acct
    else:
        assert e2 is None and a2 is None


def test_write_is_atomic(tmp_path, monkeypatch):
    """A failed write leaves the last good checkpoint as it was, and a
    finished one leaves no temp file."""
    rng = np.random.default_rng(3)
    state = _state(rng, 32)
    master = torch.zeros((2, 2, 2), dtype=torch.float64)
    path = str(tmp_path / "t.npz")
    ck.save_checkpoint(path, "fp", 1, 8, master, state, 0)
    assert os.listdir(tmp_path) == ["t.npz"]
    before = open(path, "rb").read()

    def broken(file, **payload):
        with open(file, "wb") as f:
            f.write(b"half a file")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    with pytest.raises(OSError):
        ck.save_checkpoint(path, "fp", 2, 16, master + 1, state, 0)
    assert open(path, "rb").read() == before
    assert ck.load_checkpoint(path, "fp", "cpu")[0] == 1


def test_files_are_stored_uncompressed(tmp_path):
    """Ray states are float noise to a compressor: every member of a
    checkpoint is stored as it is."""
    import zipfile
    rng = np.random.default_rng(4)
    state = _state(rng, 32)
    master = torch.zeros((2, 2, 2), dtype=torch.float64)
    path = str(tmp_path / "z.npz")
    ck.save_checkpoint(path, "fp", 1, 8, master, state, 0)
    with zipfile.ZipFile(path) as z:
        assert all(i.compress_type == zipfile.ZIP_STORED
                   for i in z.infolist())
    assert _states_equal(ck.load_checkpoint(path, "fp", "cpu")[3], state)


def test_wrong_run_and_wrong_kind_refused(tmp_path):
    rng = np.random.default_rng(5)
    state = _state(rng, 32)
    master = torch.zeros((2, 2, 2), dtype=torch.float64)
    path = str(tmp_path / "t.npz")
    cfg = Config(**SMALL)
    fp = ck.run_fingerprint(cfg, "cpu", "resumable")
    ck.save_checkpoint(path, fp, 1, 8, master, state, 0)
    for other in (ck.run_fingerprint(cfg.replace(intensity=2e14), "cpu",
                                     "resumable"),
                  ck.run_fingerprint(cfg, "cuda", "resumable"),
                  ck.run_fingerprint(cfg, "cpu", "composed")):
        assert other != fp
        with pytest.raises(ValueError, match="fingerprint"):
            ck.load_checkpoint(path, other, "cpu")
    with pytest.raises(ValueError, match="not a composed checkpoint"):
        ck.load_composed_checkpoint(path, fp, "cpu")
    with pytest.raises(ValueError, match="not a cbet checkpoint"):
        ck.load_cbet_checkpoint(path, fp, "cpu")
    assert ck.config_fingerprint(cfg) == jck.config_fingerprint(
        JConfig(**SMALL))


@pytest.mark.parametrize("kind", ["trace", "composed", "cbet"])
def test_jax_package_file_refused(tmp_path, kind):
    """Each loader refuses the JAX package's file of its kind and says that
    the formats are not interchangeable; the JAX loader refuses the
    port's."""
    import jax.numpy as jnp
    from cbet_raytracing_3d_tpu.models.raytracer import RayState as JState
    z3 = tuple(jnp.zeros(8) for _ in range(3))
    jstate = JState(frac=z3, vel=z3, kick=z3, uray=jnp.zeros(8),
                    uray_init=jnp.ones(8),
                    cell=tuple(jnp.zeros(8, jnp.int32) for _ in range(3)),
                    alive=jnp.zeros(8, bool))
    path = str(tmp_path / "j.npz")
    jcfg = JConfig(**SMALL)
    if kind == "trace":
        jck.save_checkpoint(path, jcfg, 1, np.zeros((2, 2, 2)), jstate, 0)
        load = ck.load_checkpoint
    elif kind == "composed":
        jck.save_composed_checkpoint(path, "fp", 1, jstate, np.zeros(8),
                                     np.zeros(8, bool),
                                     {0: np.zeros((2, 2, 2))}, 0)
        load = ck.load_composed_checkpoint
    else:
        jck.save_cbet_checkpoint(path, "fp", 1, np.zeros((2, 5)), [0.5])
        load = ck.load_cbet_checkpoint
    with pytest.raises(ValueError, match="not interchangeable"):
        load(path, "fp", "cpu")
    # and the other way round
    mine = str(tmp_path / "p.npz")
    ck.save_cbet_checkpoint(mine, "fp", 1, torch.zeros((2, 5)), [0.5])
    with pytest.raises(KeyError):
        jck.load_cbet_checkpoint(mine, "fp")


def test_compactor_state_dict_round_trip():
    """A compactor rebuilt from its state goes on as the original: the same
    tiles, the same write-back, the same final state."""
    cfg = Config(**SCENE)
    ctx = rt.prepare(cfg)
    state0 = rt.traced_state(ctx, "cpu")
    rpt = ctx.layout.rays_per_tile
    chunks = rt.ChunkedTrace(cfg, compact=True)
    carry = chunks.start(state0)
    while carry.comp.full is None:            # until the first compaction
        assert chunks.advance(ctx.field4, carry)
    comp, state = carry.comp, carry.state
    assert comp.width < state0.n // rpt
    sd = comp.state_dict()
    again = tp.TileCompactor.from_state_dict(state0, rpt, sd)
    assert torch.equal(again.tiles, comp.tiles)
    assert again.widths == comp.widths and again.widths is not comp.widths
    moved = state.map(lambda a: a.clone())
    moved.uray.mul_(0.5)
    assert _states_equal(again.final(moved), comp.final(moved))
    bad = dict(sd, tiles=sd["tiles"] + state0.n)
    with pytest.raises(ValueError, match="tile index"):
        tp.TileCompactor.from_state_dict(state0, rpt, bad)


@pytest.mark.parametrize("compact", [False, True])
def test_chunked_trace_equals_trace_fn_and_resumes(compact):
    """The chunk loop driven by hand equals ``make_trace_fn`` bit for bit,
    and a carry rebuilt mid-trace from copies of its parts goes on to the
    same result."""
    cfg = Config(**SCENE, chunk_steps=8)
    ctx = rt.prepare(cfg)
    state0 = rt.traced_state(ctx, "cpu")
    widths = []
    e_ref, s_ref, _, n_ref = rt.make_trace_fn(cfg, compact=compact)(
        ctx.field4, state0, widths)
    chunks = rt.ChunkedTrace(cfg, compact=compact)
    carry = chunks.start(state0)
    for _ in range(5):
        assert chunks.advance(ctx.field4, carry)
    sd = carry.comp.state_dict() if compact else None
    if compact:
        sd = {"tiles": sd["tiles"].clone(), "widths": sd["widths"],
              "full": sd["full"] and sd["full"].map(torch.clone)}
    again = chunks.resume(state0, carry.state.map(torch.clone),
                          carry.master.clone(), int(carry.oflow),
                          carry.steps, carry.chunk, sd)
    for c in (carry, again):
        while chunks.advance(ctx.field4, c):
            pass
        w = []
        e, s, of, n = chunks.finish(c, w)
        assert torch.equal(e, e_ref) and _states_equal(s, s_ref)
        assert n == n_ref and int(of) == 0 and w == widths
        assert not chunks.advance(ctx.field4, c)       # over stays over
    with pytest.raises(ValueError, match="compact"):
        chunks.resume(state0, state0, e_ref, 0, 0, 0,
                      None if compact else {"tiles": None})


@pytest.mark.parametrize("chunk_steps", [8, 19])
def test_run_resumable_resume_bit_equal(tmp_path, chunk_steps):
    """``run_resumable`` = ``run`` bit for bit, and a run resumed from a
    mid-trace checkpoint = the uninterrupted one (edep and stats)."""
    cfg = Config(**SMALL, chunk_steps=chunk_steps)
    path = str(tmp_path / "r.npz")
    full = run_resumable(cfg, checkpoint_path=path, checkpoint_every=2,
                         device="cpu", verbose=False)
    ref = run(cfg, device="cpu", verbose=False)
    assert np.array_equal(full.edep, ref.edep)
    assert full.stats["steps_executed"] == ref.stats["steps_executed"]
    fp = ck.run_fingerprint(cfg, "cpu", "resumable")
    # the last checkpoint is the finished trace: a resume does no chunk
    ci = ck.load_checkpoint(path, fp, "cpu")[0]
    assert ci == full.stats["chunks"]
    _same_result(run_resumable(cfg, checkpoint_path=path, resume=True,
                               device="cpu", verbose=False), full)
    # rewind: a checkpoint of chunk 2, written by the chunk loop itself
    ctx = rt.prepare(cfg)
    chunks = rt.ChunkedTrace(cfg.replace(deposit_batch_steps=1))
    carry = chunks.start(rt.traced_state(ctx, "cpu"))
    for _ in range(2):
        chunks.advance(ctx.field4, carry)
    ck.save_checkpoint(path, fp, carry.chunk, carry.steps, carry.master,
                       carry.state, 0)
    _same_result(run_resumable(cfg, checkpoint_path=path, resume=True,
                               checkpoint_every=3, device="cpu",
                               verbose=False), full)
    with pytest.raises(ValueError, match="fingerprint"):
        run_resumable(cfg.replace(intensity=2e14), checkpoint_path=path,
                      resume=True, device="cpu", verbose=False)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_run_composed_equals_run(dtype):
    """``run_composed`` = the port's compacted ``run`` bit for bit on the
    CPU, with the JAX run's stats keys."""
    cfg = Config(**SCENE, dtype=dtype, chunk_steps=8)
    res = run_composed(cfg, device="cpu", verbose=False)
    ref = run(cfg, device="cpu", verbose=False, cache_dir="x")
    assert np.array_equal(res.edep, ref.edep)
    for key in ("rays_total", "rays_launched", "rays_alive_at_end",
                "rays_terminated", "energy_launched", "energy_absorbed",
                "edep_total", "steps_executed", "tile_widths"):
        assert res.stats[key] == ref.stats[key], key
    assert res.stats["segments"] == len(res.stats["tile_widths"]) >= 3
    assert res.stats["chunks"] * 8 >= res.stats["steps_executed"]
    assert res.ctx is not None and res.ctx.cfg == cfg
    assert set(res.timings) >= {"Init", "Tracing", "Combining", "Total"}


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12),
                                       ("float32", 1e-6)])
def test_run_composed_matches_jax_run_composed(tmp_path, dtype, tol):
    """The same config through the JAX package's ``run_composed`` (as its
    own tests run it on the CPU): the ray counts equal, edep within 1e-6
    rel-L2, the bar of the JAX package's own composed-vs-plain test (its
    chunk grids and pairwise master are float32 whatever the ray dtype,
    the port's master is float64).  Against the JAX package's plain ``run``,
    whose master has the ray dtype, edep holds ``tol``."""
    kw = dict(SMALL, dtype=dtype, chunk_steps=8)
    res = run_composed(Config(**kw), device="cpu", verbose=False)
    jres = jrunner.run_composed(JConfig(**kw), cache_dir=str(tmp_path),
                                verbose=False)
    assert _rel_l2(res.edep, jres.edep) <= 1e-6
    assert _rel_l2(res.edep, jrunner.run(JConfig(**kw), verbose=False).edep
                   ) <= tol
    for key in ("rays_total", "rays_launched", "rays_alive_at_end",
                "rays_terminated"):
        assert res.stats[key] == jres.stats[key], key
    for key in ("energy_launched", "energy_absorbed", "edep_total"):
        assert res.stats[key] == pytest.approx(jres.stats[key], rel=1e-5)


def _composed_boundaries(cfg):
    """(chunks executed, the chunks after which a compaction follows) of
    the uninterrupted compacted trace."""
    ctx = rt.prepare(cfg)
    chunks = rt.ChunkedTrace(cfg, compact=True)
    carry = chunks.start(rt.traced_state(ctx, "cpu"))
    bounds = []
    while chunks.advance(ctx.field4, carry):
        if carry.comp.keep(carry.state.alive, False) is not None \
                and bool(carry.state.alive.any()):
            bounds.append(carry.chunk)
    return carry.chunk, bounds


@pytest.mark.parametrize("where", ["mid_width", "boundary", "after_last"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_run_composed_resume_bit_equal(tmp_path, where, dtype):
    """Stop after a chunk, resume, and get the uninterrupted run bit for
    bit: mid-width (no compaction at the boundary), exactly on a compaction
    boundary, and after the last live chunk."""
    cfg = Config(**SCENE, dtype=dtype, chunk_steps=8)
    full = run_composed(cfg, device="cpu", verbose=False)
    n_chunks, bounds = _composed_boundaries(cfg)
    assert len(bounds) >= 2 and n_chunks == full.stats["chunks"]
    if where == "boundary":
        stop = bounds[1]
    elif where == "mid_width":
        stop = next(c for c in range(2, n_chunks) if c not in bounds)
    else:
        stop = n_chunks
    path = str(tmp_path / "c.npz")
    out = run_composed(cfg, device="cpu", verbose=False,
                       checkpoint_path=path, stop_after_chunks=stop)
    assert out is None
    fp = ck.run_fingerprint(cfg, "cpu", "composed")
    assert ck.load_composed_checkpoint(path, fp, "cpu")[0] == stop
    res = run_composed(cfg, device="cpu", verbose=False,
                       checkpoint_path=path, resume=True)
    _same_result(res, full)
    with pytest.raises(ValueError, match="fingerprint"):
        run_composed(cfg.replace(intensity=2e14), device="cpu",
                     verbose=False, checkpoint_path=path, resume=True)


def test_run_composed_checkpoint_schedule(tmp_path, monkeypatch):
    """Checkpoints are written after every chunk whose boundary compacts
    and every ``checkpoint_every_chunks`` chunks, and none without a
    path."""
    cfg = Config(**SCENE, chunk_steps=8)
    n_chunks, bounds = _composed_boundaries(cfg)
    saved = []
    real = ck.save_composed_checkpoint
    monkeypatch.setattr(ck, "save_composed_checkpoint",
                        lambda path, fp, ci, *a: (saved.append(ci),
                                                  real(path, fp, ci, *a)))
    run_composed(cfg, device="cpu", verbose=False)
    assert saved == []
    run_composed(cfg, device="cpu", verbose=False,
                 checkpoint_path=str(tmp_path / "a.npz"))
    assert [c for c in saved if c < n_chunks] == [c for c in bounds
                                                  if c < n_chunks]
    saved.clear()
    run_composed(cfg, device="cpu", verbose=False,
                 checkpoint_path=str(tmp_path / "b.npz"),
                 checkpoint_every_chunks=3)
    assert set(range(3, n_chunks + 1, 3)) <= set(saved)
    with pytest.raises(ValueError, match="checkpoint_path"):
        run_composed(cfg, device="cpu", verbose=False, resume=True)
