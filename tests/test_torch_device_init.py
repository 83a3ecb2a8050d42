"""The port's on-card ray init (``raytracer.prepare_device``, run here on
the CPU) against the JAX package's ``prepare_device`` and against the port's
host ``prepare``: the live-tile layout, the launch state, the pad slots and
the traced deposition."""

import numpy as np
import pytest
import torch

from cbet_raytracing_3d_tpu.config import Config as JConfig
from cbet_raytracing_3d_tpu.models import raytracer as jrt
from cbet_raytracing_3d_tpu_torch import convert
from cbet_raytracing_3d_tpu_torch.config import Config
from cbet_raytracing_3d_tpu_torch.models import raytracer as rt

torch.set_num_threads(1)

# tests/test_init.py::test_device_init_matches_host_prepare's scene
SCENE = dict(nbeams=3, rays_per_zone=2, nx=40, ny=40, nz=40,
             tiles_per_block=2)
FIELDS = ("frac", "vel", "kick")


def _host_in_device_layout(cfg, ctx_h):
    """The host state's slots in the on-card layout (the live tiles of
    ``live_tile_ids``, pads dropped), and the mask of those slots in the
    on-card state."""
    rpt = ctx_h.layout.rays_per_tile
    ids, valid = rt.live_tile_ids(cfg, ctx_h.layout)
    state_h = rt.select_rays(ctx_h.state0, rt.tile_slots(ids[valid], rpt))
    return state_h, np.repeat(valid, rpt)


@pytest.mark.parametrize("parity", ["clean", "reference"])
def test_device_init_matches_jax_device_init(parity):
    """float64, both packages' ``prepare_device`` on the CPU, with the JAX
    test's tolerances (tests/test_init.py:89-138): the same live tiles and
    beam ids, launched masks and cells exact, floats at rtol 1e-10."""
    kw = dict(SCENE, dtype="float64", parity=parity)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    jctx = jrt.prepare_device(jcfg)
    ctx = rt.prepare_device(cfg, device="cpu")
    assert ctx.compact and jctx.compact
    j_ids, j_valid = jrt.live_tile_ids(jcfg, jrt.build_tile_layout(
        jcfg, with_slots=False))
    ids, valid = rt.live_tile_ids(cfg, ctx.layout)
    assert np.array_equal(ids, j_ids) and np.array_equal(valid, j_valid)
    assert np.array_equal(ctx.beam_id, np.asarray(jctx.beam_id))
    assert np.array_equal(ctx.live_slots, np.asarray(jctx.live_slots))
    got, want = convert.state_to_numpy(ctx.state0), convert.state_to_numpy(
        jctx.state0)
    m = want["alive"]
    assert m.sum() > 0 and np.array_equal(got["alive"], m)
    for ax in range(3):
        assert np.array_equal(got["cell"][ax][m], want["cell"][ax][m])
        for name in FIELDS:
            np.testing.assert_allclose(got[name][ax][m], want[name][ax][m],
                                       rtol=1e-10, atol=1e-13,
                                       err_msg=f"{name}[{ax}]")
    for key in ("uray", "uray_init"):
        np.testing.assert_allclose(got[key][m], want[key][m], rtol=1e-12)
    # slots that launch no ray: no energy, a unit initial energy
    assert (got["uray"][~m] == 0).all() and (want["uray"][~m] == 0).all()
    assert (got["uray_init"][~m] == 1).all()
    assert (want["uray_init"][~m] == 1).all()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_device_init_equals_host_prepare(dtype):
    """The on-card init computes in float64 with the host prepare's
    operations in its order, then casts: every launched ray's state equals
    the host's bit for bit, in both dtypes; ``beam_id`` is -1 exactly on
    the pad slots; the field tables are equal."""
    cfg = Config(**SCENE, dtype=dtype)
    ctx_h = rt.prepare(cfg)
    ctx_d = rt.prepare_device(cfg, device="cpu")
    state_h, sel = _host_in_device_layout(cfg, ctx_h)
    state_d = rt.select_rays(ctx_d.state0, np.nonzero(sel)[0])
    assert torch.equal(ctx_d.field4, ctx_h.field4)
    m = state_h.alive
    assert torch.equal(state_d.alive, m) and int(m.sum()) > 0
    assert not ctx_d.state0.alive[torch.from_numpy(~sel)].any()
    for name in FIELDS + ("cell",):
        for a, b in zip(getattr(state_d, name), getattr(state_h, name)):
            assert a.dtype == b.dtype
            assert torch.equal(a[m], b[m]), name
    assert torch.equal(state_d.uray[m], state_h.uray[m])
    assert torch.equal(state_d.uray_init[m], state_h.uray_init[m])
    ids, valid = rt.live_tile_ids(cfg, ctx_h.layout)
    rpt = ctx_h.layout.rays_per_tile
    assert np.array_equal(ctx_d.beam_id == -1, np.repeat(~valid, rpt))
    # the host marks lattice-less slots inside a live tile -1 as well
    bid_h = ctx_h.beam_id[rt.tile_slots(ids[valid], rpt)]
    assert np.array_equal(ctx_d.beam_id[sel][bid_h >= 0], bid_h[bid_h >= 0])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_device_init_trace_equals_host_trace(dtype):
    """The traced deposition of both states: the on-card layout adds the
    pads of each beam where the host selection pads once at the end, but
    the live rays come in the same order and dead rows add nothing, so the
    plain (``index_add_``) deposit gives the same grid bit for bit."""
    cfg = Config(**SCENE, dtype=dtype)
    e_h, s_h = rt.trace(rt.prepare(cfg), "cpu")
    ctx_d = rt.prepare_device(cfg, device="cpu")
    e_d, s_d = rt.trace(ctx_d, "cpu")
    assert np.abs(e_h).max() > 0
    assert np.array_equal(e_d, e_h)
    assert int(s_d.alive.sum()) == int(s_h.alive.sum())
    # the JAX package's float64 device-init trace (its scatter backend)
    if dtype == "float64":
        jcfg = JConfig(**SCENE, dtype="float64")
        e_j, _ = jrt.trace(jrt.prepare_device(jcfg), backend="scatter")
        rel = np.linalg.norm(e_d - np.asarray(e_j)) / np.linalg.norm(e_j)
        assert rel < 1e-12


def test_trace_stats_of_a_compact_context():
    """``trace_stats`` takes a compact context's own state0 (the on-card
    layout) by default, with the host run's accounting."""
    cfg = Config(**SCENE, dtype="float64")
    ctx_d = rt.prepare_device(cfg, device="cpu")
    ctx_h = rt.prepare(cfg)
    _, s_d = rt.trace(ctx_d, "cpu")
    _, s_h = rt.trace(ctx_h, "cpu")
    st_d = rt.trace_stats(ctx_d, s_d)
    st_h = rt.trace_stats(ctx_h, s_h, rt.traced_state(ctx_h, "cpu"))
    for key in ("rays_total", "rays_launched", "rays_alive_at_end",
                "rays_terminated"):
        assert st_d[key] == st_h[key], key
    np.testing.assert_allclose(st_d["energy_absorbed"],
                               st_h["energy_absorbed"], rtol=1e-12)
