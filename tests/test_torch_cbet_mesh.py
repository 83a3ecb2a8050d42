"""The port's beam-sharded CBET solve (``models/cbet.py`` on a process group)
against the JAX package's solves, in float64 on the two-beam scene of
``tests/test_cbet.py:16-19``: two ranks against the JAX single-device solve
in lookup (gain table sharded and replicated) and kernel_cell, with the JAX
gain reduction injected (1e-10) and with the port's own float32 gain
(1e-8); two beams on four ranks against the JAX four-device mesh solve,
which falls back to its scatter layout there (rtol 1e-10, as
``tests/test_cbet.py:217-231``); seven beams on two ranks (an uneven split)
against the port's single-rank solve; K3's ``b_out`` rows against the full
gain's; and the JAX mesh solve's refusals.

The JAX single-device solves run lookup with the scatter backend: the
port's kernel_cell equals its lookup to 1e-12 on the CPU
(``test_torch_cbet.py::test_kernel_cell_solve_equals_lookup_solve``), so
both modes are held to it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbet_raytracing_3d_tpu.config import Config as JConfig
from cbet_raytracing_3d_tpu.models import cbet as jcbet
from cbet_raytracing_3d_tpu.models import raytracer as jrt
from cbet_raytracing_3d_tpu.parallel.sharding import make_mesh as jmesh
from cbet_raytracing_3d_tpu_torch.config import Config
from cbet_raytracing_3d_tpu_torch.models import cbet
from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
from cbet_raytracing_3d_tpu_torch.models.cbet_composed import \
    cbet_solve_composed
from cbet_raytracing_3d_tpu_torch.ops import gain as gain_ops
from cbet_raytracing_3d_tpu_torch.parallel import multihost as mh
from cbet_raytracing_3d_tpu_torch.parallel import sharding as sh
from cbet_raytracing_3d_tpu_torch.runner import run_composed

torch.set_num_threads(1)

# tests/test_cbet.py::two_beam_cfg in float64, in windows that kernel_cell
# can take (as test_torch_cbet.py::test_kernel_cell_solve_equals_lookup_solve)
TWO_BEAM = dict(nbeams=2, rays_per_zone=1, nx=40, ny=40, nz=40,
                cbet_max_iters=12, cbet_tol=1e-3, dtype="float64",
                chunk_steps=10, deposit_batch_steps=5)
# tests/test_cbet.py:217-231
FOUR = dict(nbeams=2, rays_per_zone=1, nx=40, ny=40, nz=40,
            cbet_max_iters=3, cbet_tol=1e-3, dtype="float64")
UNEVEN = dict(nbeams=7, rays_per_zone=1, nx=24, ny=24, nz=24,
              cbet_max_iters=3, dtype="float64", chunk_steps=8,
              deposit_batch_steps=4, cbet_gain_mode="kernel_cell")
# (tag, gain mode, cbet_gain_sharded)
CASES = (("lookup", "lookup", True), ("lookup_replicated", "lookup", False),
         ("kernel_cell", "kernel_cell", None))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _jax_gain_ops(kw, b0):
    """The port's plain ops with the JAX XLA gain reduction in place of
    K3's plain version: the full (B, P) gain, of which a ``b_out`` call
    (``pair_u`` of fewer rows) takes the rank's rows from ``b0``."""
    jax.config.update("jax_enable_x64", True)
    jcfg = JConfig(**kw)
    jgain = jcbet.make_gain_fn(jcfg, jrt.prepare(jcfg), backend="xla")

    def gain_op(pu, rp, inten):
        full = torch.from_numpy(np.array(jgain(jnp.asarray(inten.numpy()))))
        return full if pu.shape[0] == full.shape[0] else \
            full[b0:b0 + pu.shape[0]]

    return dataclasses.replace(cbet.plain_ops(), gain=gain_op)


def _summary(res):
    return {"edep": res.edep, "intensity": res.intensity,
            "history": res.history, "iterations": res.iterations,
            "stats": res.stats}


def _refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _rank2(rank, world):
    """Every two-rank check's solves and refusals."""
    torch.set_num_threads(1)
    b0, nl = sh.rank_beams(2, world)[rank]
    cfg = Config(**TWO_BEAM)
    ctx = rt.prepare(cfg)
    jops = _jax_gain_ops(TWO_BEAM, b0)
    out = {}
    for tag, mode, shard in CASES:
        c = cfg.replace(cbet_gain_mode=mode, cbet_gain_sharded=shard)
        out[tag + "_jax_gain"] = _summary(cbet.cbet_solve(c, ctx, "cpu",
                                                          ops=jops))
        out[tag] = _summary(cbet.cbet_solve(c, ctx, "cpu"))
    uneven = Config(**UNEVEN)
    out["uneven"] = _summary(cbet.cbet_solve(uneven, rt.prepare(uneven),
                                             "cpu"))
    # the gain rows of a sharded and a replicated table on one input
    mesh = sh.make_mesh()
    rng = np.random.default_rng(5)
    inten = torch.from_numpy(rng.uniform(0, 1e14, (2, cfg.nx * cfg.ny
                                                   * cfg.nz)
                                         ).astype(np.float32))
    for shard in (True, False):
        fn = cbet.make_gain_fn(cfg, ctx, "cpu", None, mesh, shard)
        out[f"gain_rows_{shard}"] = fn(inten[b0:b0 + nl]).numpy()
    refuse = {
        "kernel": cfg.replace(cbet_gain_mode="kernel"),
        "light": cfg.replace(cbet_light_iterations=True),
        "sharded_unsliced": cfg.replace(cbet_gain_sharded=True,
                                        cbet_gain_sliced=False),
        "kernel_cell_replicated": cfg.replace(cbet_gain_mode="kernel_cell",
                                              cbet_gain_sharded=False)}
    out["refused"] = {k: _refusal(lambda c=c: cbet.cbet_solve(c, ctx, "cpu"))
                      for k, c in refuse.items()}
    out["refused"]["composed"] = _refusal(lambda: cbet_solve_composed(
        cfg, ctx, device="cpu"))
    out["refused"]["run_composed"] = _refusal(lambda: run_composed(
        cfg, device="cpu"))
    return out


def _rank4(rank, world):
    """Two beams on four ranks: ranks 2 and 3 own none."""
    torch.set_num_threads(1)
    b0, _ = sh.rank_beams(2, world)[rank]
    cfg = Config(**FOUR)
    return _summary(cbet.cbet_solve(cfg, rt.prepare(cfg), "cpu",
                                    ops=_jax_gain_ops(FOUR, b0)))


@pytest.fixture(scope="module")
def two():
    return mh.spawn_ranks(_rank2, 2, timeout=600)


@pytest.fixture(scope="module")
def jax_two_beam():
    jcfg = JConfig(**TWO_BEAM)
    return jcbet.cbet_solve(jcfg, jrt.prepare(jcfg), backend="scatter")


@pytest.mark.parametrize("tag,mode,shard", CASES)
def test_two_ranks_match_jax_with_its_gain(two, jax_two_beam, tag, mode,
                                           shard):
    """Two ranks, one beam each, with the JAX gain injected: the JAX
    single-device solve's iterations, history, edep and intensity within
    1e-10; every rank returns the same result."""
    want = jax_two_beam
    for r in two:
        got = r[tag + "_jax_gain"]
        assert got["iterations"] == want.iterations
        np.testing.assert_allclose(got["history"], want.history, rtol=1e-10)
        assert _rel_l2(got["edep"], want.edep) < 1e-10
        assert _rel_l2(got["intensity"], want.intensity) < 1e-10
        st = got["stats"]
        assert st["intensity_mode"] == "beam_sharded" and st["devices"] == 2
        assert st["gain_sharded"] == (shard is not False)
        assert st["rank_beams"] == [1, 1] and st["dist_backend"] == "gloo"
        for key in ("rays_launched", "rays_terminated", "rays_alive_at_end"):
            assert st[key] == want.stats[key], key
        assert np.array_equal(got["edep"], two[0][tag + "_jax_gain"]["edep"])


@pytest.mark.parametrize("tag,mode,shard", CASES)
def test_two_ranks_match_jax_with_own_gain(two, jax_two_beam, tag, mode,
                                           shard):
    """The port's own float32 gain: the JAX solve's iterations, the fields
    within 1e-8 (the two f32 gains' fixed points sit ~1e-9 apart, as in
    ``test_torch_cbet.py::test_solve_matches_jax_with_own_gain``)."""
    want = jax_two_beam
    for r in two:
        got = r[tag]
        assert got["iterations"] == want.iterations
        np.testing.assert_allclose(got["history"], want.history, rtol=1e-6)
        assert _rel_l2(got["edep"], want.edep) < 1e-8
        assert _rel_l2(got["intensity"], want.intensity) < 1e-8
    # the sharded and the replicated gain table give the same rows
    assert np.array_equal(two[0]["lookup"]["intensity"],
                          two[0]["lookup_replicated"]["intensity"])


def test_uneven_beams_match_single_rank(two):
    """Seven beams on two ranks (4 + 3), kernel_cell: the single-rank
    solve's iterations and intensity bit for bit (each beam's rows and gain
    are the same arithmetic), edep to the rounding of the rank sum."""
    cfg = Config(**UNEVEN)
    want = cbet.cbet_solve(cfg, rt.prepare(cfg), "cpu")
    for r in two:
        got = r["uneven"]
        assert got["stats"]["rank_beams"] == [4, 3]
        assert got["iterations"] == want.iterations
        assert got["history"] == want.history
        assert np.array_equal(got["intensity"], want.intensity)
        assert _rel_l2(got["edep"], want.edep) < 1e-13
        for key in ("rays_launched", "rays_terminated", "rays_alive_at_end"):
            assert got["stats"][key] == want.stats[key], key


def test_gain_rows_equal_full_gain(two):
    """K3's ``b_out`` form (the rank's rows of ``pair_u``, the partner sum
    over every beam) and the replicated table's rows equal the full gain's
    rows bit for bit, on the plain versions; so does the wrapper's
    ``b_out`` call on the CPU."""
    cfg = Config(**TWO_BEAM)
    ctx = rt.prepare(cfg)
    rng = np.random.default_rng(5)
    inten = torch.from_numpy(rng.uniform(0, 1e14, (2, cfg.nx * cfg.ny
                                                   * cfg.nz)
                                         ).astype(np.float32))
    full = cbet.make_gain_fn(cfg, ctx)(inten).numpy()
    assert np.abs(full).max() > 0
    for rank, r in enumerate(two):
        for shard in (True, False):
            assert np.array_equal(r[f"gain_rows_{shard}"],
                                  full[rank:rank + 1])
    pu, rp = cbet._gain_tables(Config(**UNEVEN), rt.prepare(Config(**UNEVEN)),
                               "cpu")
    big = torch.from_numpy(rng.uniform(0, 1e14, (7, rp.shape[1])
                                       ).astype(np.float32))
    whole = gain_ops.gain(pu, rp, big)
    before = gain_ops.B_OUT_LAUNCHES
    for b0, n in sh.rank_beams(7, 2):
        rows = gain_ops.gain(pu[b0:b0 + n].contiguous(), rp, big)
        assert torch.equal(rows, whole[b0:b0 + n])
    assert gain_ops.B_OUT_LAUNCHES == before       # CPU: the plain version


def test_mesh_refusals(two):
    """The JAX mesh solve's rules, with its messages, on the ranks; the
    resumable forms take one device."""
    for r in two:
        got = r["refused"]
        assert "single-device only" in got["kernel"]
        assert "single-device only" in got["light"]
        assert "cbet_gain_sharded=True requires" in got["sharded_unsliced"]
        assert "requires the beam-sharded gain table" in \
            got["kernel_cell_replicated"]
        assert "runs on one device" in got["composed"]
        assert "runs on one device" in got["run_composed"]


def test_mesh_rules_by_world():
    """``check_cbet_config``'s mesh rules depend on the rank count alone;
    one rank keeps every single-device switch; ``cbet_gain_sharded=None``
    shards where it can."""
    cfg = Config(**TWO_BEAM)
    for c in (cfg.replace(cbet_gain_mode="kernel"),
              cfg.replace(cbet_light_iterations=True),
              cfg.replace(cbet_gain_sharded=True, cbet_gain_sliced=False),
              cfg.replace(cbet_gain_mode="kernel_cell",
                          cbet_gain_sharded=False)):
        cbet.check_cbet_config(c, 1)
        with pytest.raises(ValueError):
            cbet.check_cbet_config(c, 2)
    assert cbet.gain_sharded(cfg, 2) and not cbet.gain_sharded(cfg, 1)
    assert not cbet.gain_sharded(cfg.replace(cbet_gain_sliced=False), 2)
    assert not cbet.gain_sharded(cfg.replace(cbet_gain_sharded=False), 2)


def test_two_beams_on_four_ranks_match_jax_mesh():
    """tests/test_cbet.py:217-231 for the port: two beams on four ranks
    (two own none) against the JAX four-device mesh solve, whose layout is
    the beam-straddling scatter there, at rtol 1e-10."""
    jcfg = JConfig(**FOUR)
    jctx = jrt.prepare(jcfg)
    want = jcbet.cbet_solve(jcfg, jctx, mesh=jmesh(jax.devices()[:4]),
                            backend="scatter")
    got4 = mh.spawn_ranks(_rank4, 4, timeout=600)
    for got in got4:
        assert got["stats"]["rank_beams"] == [1, 1, 0, 0]
        assert got["iterations"] == want.iterations
        np.testing.assert_allclose(got["edep"], want.edep, rtol=1e-10,
                                   atol=1e-10 * want.edep.max())
        np.testing.assert_allclose(got["intensity"], want.intensity,
                                   rtol=1e-10,
                                   atol=1e-10 * max(want.intensity.max(), 1))
        assert np.array_equal(got["edep"], got4[0]["edep"])
