"""Scene setup of the port against the JAX package, at config-1 scale:
profiles, node fields, power table, ray launch, the (P, 4) field table and
the tile-ordered initial state are bit-identical (both are float64 NumPy);
``convert`` carries a JAX state into the port and back unchanged."""

import dataclasses

import numpy as np
import pytest
import torch

from cbet_raytracing_3d_tpu import beams as jbeams
from cbet_raytracing_3d_tpu import fields as jfields
from cbet_raytracing_3d_tpu.config import Config as JConfig
from cbet_raytracing_3d_tpu.models import raytracer as jrt
from cbet_raytracing_3d_tpu.ops import interp as jinterp
from cbet_raytracing_3d_tpu.parallel import sharding as jsh
from cbet_raytracing_3d_tpu_torch import beams, convert, fields
from cbet_raytracing_3d_tpu_torch.config import Config
from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
from cbet_raytracing_3d_tpu_torch.ops import interp
from cbet_raytracing_3d_tpu_torch.parallel.sharding import pad_rays
from cbet_raytracing_3d_tpu_torch.profiles import load_profiles

torch.set_num_threads(1)

SCENES = {
    "config1": dict(nbeams=1, rays_per_zone=1, nx=40, ny=40, nz=40,
                    dtype="float64"),
    "two_beams_f32": dict(nbeams=2, rays_per_zone=1, nx=32, ny=36, nz=30),
    # rays_per_zone=2 -> 784 rays per beam, 768 traced under the truncation
    "reference_parity": dict(nbeams=2, rays_per_zone=2, nx=40, ny=40, nz=40,
                             dtype="float64", parity="reference"),
}


def _pair(name):
    kw = SCENES[name]
    return JConfig(**kw), Config(**kw)


def _jax_state_dict(s):
    return convert.state_to_numpy(s)


def test_profiles_identical(profiles):
    p = load_profiles()
    for f in ("r", "ne", "te"):
        assert np.array_equal(getattr(p, f), getattr(profiles, f))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_fields_and_beams_identical(scene, profiles):
    jc, tc = _pair(scene)
    jf = jfields.build_fields(jc, profiles)
    tf = fields.build_fields(tc, load_profiles())
    for f in dataclasses.fields(jf):
        assert np.array_equal(getattr(tf, f.name), getattr(jf, f.name)), f.name
    assert np.array_equal(beams.power_table(tc), jbeams.power_table(jc))
    bn = beams.load_beam_norms(nbeams=tc.nbeams)
    assert np.array_equal(bn, jbeams.load_beam_norms(nbeams=jc.nbeams))
    jr = jbeams.init_rays(jc, bn, jbeams.power_table(jc))
    tr = beams.init_rays(tc, bn, beams.power_table(tc))
    for f in ("pos", "uray", "mask"):
        assert np.array_equal(getattr(tr, f), getattr(jr, f)), f


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_prepare_state0_identical(scene, profiles):
    jc, tc = _pair(scene)
    jctx = jrt.prepare(jc, profiles, host_state=True)
    tctx = rt.prepare(tc)
    assert tctx.field4.dtype == getattr(torch, tc.dtype)
    assert np.array_equal(tctx.field4.numpy(), jctx.field4)
    want = _jax_state_dict(jctx.state0)
    got = convert.state_to_numpy(tctx.state0)
    for name, w in want.items():
        for g_a, w_a in zip(np.atleast_2d(got[name]), np.atleast_2d(w)):
            assert g_a.dtype == w_a.dtype and np.array_equal(g_a, w_a), name
    assert np.array_equal(tctx.live_slots, jctx.live_slots)
    assert np.array_equal(tctx.beam_id, jctx.beam_id)
    assert np.array_equal(tctx.layout.slot_of, jctx.layout.slot_of)
    assert (tctx.layout.rays_per_tile, tctx.layout.tiles_per_beam,
            tctx.layout.n_slots) == (jctx.layout.rays_per_tile,
                                     jctx.layout.tiles_per_beam,
                                     jctx.layout.n_slots)
    if scene == "reference_parity":
        # the launch-grid truncation: thread ids >= 768 never launch
        assert tc.traced_rays_per_beam == 768
        assert not tctx.rays.mask[:, 768:].any()
        assert tctx.rays.mask[:, :768].any()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_select_and_pad_match_jax(scene, profiles):
    jc, tc = _pair(scene)
    jctx = jrt.prepare(jc, profiles, host_state=True)
    tctx = rt.prepare(tc)
    mult = tctx.layout.rays_per_tile * 3
    want = jsh.pad_rays(jrt.select_rays(jctx.state0, jctx.live_slots), mult)
    got = pad_rays(rt.select_rays(tctx.state0, tctx.live_slots), mult)
    assert got.n % mult == 0
    w, g = _jax_state_dict(want), convert.state_to_numpy(got)
    for name in w:
        assert np.array_equal(np.asarray(g[name]), np.asarray(w[name])), name


def test_initial_cell_matches(rng):
    cfg = JConfig(nx=24, ny=20, nz=22)
    t = rng.uniform(-2.0, 25.0, size=(4000, 3))
    # exact half-integers +- tol exercise the first-match rule
    t[:500] = np.round(t[:500]) + rng.choice([-0.5001, 0.5001, 0.5, -0.5],
                                             size=(500, 3))
    assert np.array_equal(rt.initial_cell(Config(nx=24, ny=20, nz=22), t),
                          jrt.initial_cell(cfg, t))


def test_interp_matches(rng):
    x = np.sort(rng.uniform(0, 1, 50))
    y = rng.normal(size=50)
    xp = rng.uniform(-0.2, 1.2, 300)
    assert np.array_equal(interp.interp(y, x, xp), jinterp.interp(y, x, xp))
    assert np.array_equal(interp.interp(y, x[::-1], xp),
                          jinterp.interp(y, x[::-1], xp))
    assert np.array_equal(interp.uniform_interp(y, 0.0, 0.02, xp),
                          jinterp.uniform_interp(y, 0.0, 0.02, xp))


def test_convert_round_trip(profiles):
    jc, tc = _pair("config1")
    jctx = jrt.prepare(jc, profiles, host_state=True)
    src = _jax_state_dict(jctx.state0)
    field4, state, live = convert.from_jax_context(
        jctx.field4, src, jctx.live_slots, device="cpu")
    back = convert.state_to_numpy(state)
    for name in src:
        assert np.array_equal(np.asarray(back[name]), np.asarray(src[name]))
    assert np.array_equal(field4.numpy(), jctx.field4)
    assert live.dtype == torch.int64
    assert np.array_equal(live.numpy(), jctx.live_slots)
    # the converted state is the port's own prepare, bit for bit
    own = convert.state_to_numpy(rt.prepare(tc).state0)
    for name in src:
        assert np.array_equal(np.asarray(own[name]), np.asarray(back[name]))
    # copies: mutating the port's tensor leaves the source untouched
    state.uray.zero_()
    assert np.asarray(src["uray"]).any()
