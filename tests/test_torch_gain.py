"""The port's CBET gain side against the JAX package's: the host functions
of ``models/cbet.py`` (bit-identical), the plain version of the gain
reduction (K3) against the JAX XLA form and the Pallas kernel in interpret
mode, the b_out form, the sign and shape guards of ``pair_u``, and the
upsampler of a coarse gain grid.  The CUDA kernel itself is held against
the plain version on the card in ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbet_raytracing_3d_tpu import constants as jk
from cbet_raytracing_3d_tpu.config import Config as JConfig
from cbet_raytracing_3d_tpu.models import cbet as jcbet
from cbet_raytracing_3d_tpu.models import raytracer as jrt
from cbet_raytracing_3d_tpu.ops.pallas_gain import make_gain_kernel
from cbet_raytracing_3d_tpu_torch.beams import load_beam_norms
from cbet_raytracing_3d_tpu_torch.config import Config
from cbet_raytracing_3d_tpu_torch.models import cbet
from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
from cbet_raytracing_3d_tpu_torch.ops import gain as gop

torch.set_num_threads(1)

SMALL = dict(nbeams=4, rays_per_zone=1, nx=24, ny=24, nz=24, dtype="float64")


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope="module")
def jctx(profiles):
    return jrt.prepare(JConfig(**SMALL), profiles)


@pytest.fixture(scope="module")
def ctx():
    return rt.prepare(Config(**SMALL))


@pytest.fixture(scope="module")
def inputs(ctx):
    """``pair_u``, ``rhat_pre`` and a random float32 intensity (the scale of
    tests/test_cbet.py::test_gain_pallas_kernel_matches_xla)."""
    cfg = Config(**SMALL)
    rp = np.concatenate([cbet._node_rhat(cfg),
                         cbet.gain_prefactor_field(cfg, ctx.fields)
                         .reshape(1, -1)]).astype(np.float32)
    pu = cbet.pair_couplings(ctx.beam_norm, cfg.machnum).astype(np.float32)
    rng = np.random.default_rng(3)
    inten = rng.random((cfg.nbeams, rp.shape[1]), np.float32) * 1e14
    return pu, rp, inten


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_pair_couplings_identical():
    for nb in (2, 60):
        bn = load_beam_norms(nbeams=nb)
        assert np.array_equal(cbet.pair_couplings(bn, jk.MACH),
                              jcbet.pair_couplings(bn, jk.MACH))


def test_gain_prefactor_identical(ctx, jctx):
    got = cbet.gain_prefactor_field(Config(**SMALL), ctx.fields)
    want = jcbet.gain_prefactor_field(JConfig(**SMALL), jctx.fields)
    assert np.array_equal(got, want) and got.max() > 0
    assert cbet.I_TO_FIELD_SQ == jcbet.I_TO_FIELD_SQ
    assert cbet.GAIN_CLIP == jcbet.GAIN_CLIP


@pytest.mark.parametrize("s", [1, 2, 3])
def test_node_rhat_identical(s):
    assert np.array_equal(cbet._node_rhat(Config(**SMALL), s),
                          jcbet._node_rhat(JConfig(**SMALL), s))


@pytest.mark.parametrize("n_full,s", [(24, 2), (25, 2), (100, 3), (7, 1)])
def test_interp_matrix_identical(n_full, s):
    nh = -(-n_full // s)
    assert np.array_equal(cbet._interp_matrix(n_full, nh, s),
                          jcbet._interp_matrix(n_full, nh, s))


def test_resonance_matches_jax():
    eta = np.linspace(-2.5, 2.5, 1001)
    got = gop.resonance(torch.from_numpy(eta)).numpy()
    np.testing.assert_allclose(got, np.asarray(jcbet.resonance(eta)),
                               rtol=1e-14, atol=1e-300)
    assert got[500] == 0.0


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_gain_reference_matches_jax(backend, inputs, ctx, jctx):
    """f32 gain: the plain version against the JAX XLA form and the Pallas
    kernel (interpret), through each package's ``make_gain_fn``."""
    _, _, inten = inputs
    want = np.asarray(jcbet.make_gain_fn(JConfig(**SMALL), jctx,
                                         backend=backend)(jnp.asarray(inten)))
    before = gop.LAUNCHES
    got = cbet.make_gain_fn(Config(**SMALL), ctx)(torch.from_numpy(inten))
    assert gop.LAUNCHES == before          # the CPU path launches nothing
    assert got.dtype == torch.float32 and np.abs(want).max() > 0
    assert _rel_l2(got.numpy(), want) < 1e-6


@pytest.mark.parametrize("bo", [1, 2])
def test_gain_b_out_matches_pallas_kernel(bo, inputs):
    """The row-restricted (b_out) form: the first ``bo`` output beams from
    all partner beams, against the Pallas kernel's b_out build."""
    pu, rp, inten = inputs
    B, P = inten.shape
    kfn = make_gain_kernel(B, P, jk.IAW, interpret=True, b_out=bo)
    want = np.asarray(kfn(jnp.asarray(pu[:bo]), jnp.asarray(rp),
                          jnp.asarray(inten)))
    got = gop.gain_reference(*_t(pu[:bo], rp, inten))
    assert got.shape == (bo, P)
    assert _rel_l2(got.numpy(), want) < 1e-6
    full = gop.gain_reference(*_t(pu, rp, inten))
    assert torch.equal(got, full[:bo])     # same per-row arithmetic


def _omega_inputs(P=512, seed=5):
    """The OMEGA 60-beam couplings with random unit vectors and a positive
    prefactor on ``P`` nodes."""
    rng = np.random.default_rng(seed)
    pu = cbet.pair_couplings(load_beam_norms(nbeams=60),
                             jk.MACH).astype(np.float32)
    rhat = rng.standard_normal((3, P))
    rhat /= np.linalg.norm(rhat, axis=0)
    rp = np.concatenate([rhat, rng.uniform(0.5, 2.0, (1, P))]
                        ).astype(np.float32)
    inten = rng.random((60, P), np.float32) * 1e14
    return pu, rp, inten


@pytest.mark.parametrize("nb", [2, 4, 60])
def test_solver_couplings_are_antisymmetric(nb):
    """The pair kernel's condition holds exactly for the solver's couplings
    in float32: ``pair_u[b, a] == -pair_u[a, b]``, zero diagonal."""
    pu = torch.from_numpy(cbet.pair_couplings(
        load_beam_norms(nbeams=nb), jk.MACH).astype(np.float32))
    assert gop.pairs_antisymmetric(pu)
    assert float(pu.abs().max()) > 0
    assert float(pu[torch.arange(nb), torch.arange(nb)].abs().max()) == 0.0


def test_pair_form_refused_for_other_couplings(inputs):
    """The b_out slice, perturbed couplings, a non-zero diagonal, a NaN and
    another rank are not the pair form; the check runs once per tensor and
    again after an in-place change."""
    pu = _t(inputs[0])[0]
    assert gop.pairs_antisymmetric(pu)
    assert not gop.pairs_antisymmetric(pu[:2].contiguous())
    bad = pu.clone()
    bad[1, 2, 0] = torch.nextafter(bad[1, 2, 0], torch.tensor(9.0))
    assert not gop.pairs_antisymmetric(bad)
    diag = pu.clone()
    diag[3, 3, 1] = 1e-30
    assert not gop.pairs_antisymmetric(diag)
    nan = pu.clone()
    nan[0, 1, 2], nan[1, 0, 2] = float("nan"), float("nan")
    assert not gop.pairs_antisymmetric(nan)
    assert not gop.pairs_antisymmetric(pu[0])
    with pytest.raises(ValueError, match="antisymmetric"):
        gop.gain_pairs_reference(bad, *_t(*inputs[1:]))
    cached = pu.clone()
    assert gop._takes_pairs(cached) and gop._takes_pairs(cached)
    cached[1, 2, 0] += 1.0                       # in place: checked again
    assert not gop._takes_pairs(cached)
    assert gop._takes_pairs(pu)


@pytest.mark.parametrize("case", ["scene", "omega", "two-beam"])
def test_gain_pairs_reference_equals_reference_bitwise(case, inputs):
    """Each pair evaluated once, added in ascending partner order, is the
    all-pairs plain version bit for bit (R is odd, the couplings exactly
    antisymmetric)."""
    if case == "scene":
        pu, rp, inten = inputs
    else:
        pu, rp, inten = _omega_inputs()
        if case == "two-beam":
            pu = np.ascontiguousarray(pu[:2, :2])
            inten = inten[:2]
    args = _t(pu, rp, inten)
    want = gop.gain_reference(*args)
    got = gop.gain_pairs_reference(*args)
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want)


def test_gain_pairs_reference_matches_jax(inputs, jctx):
    """Both plain versions against the JAX XLA gain at 1e-6."""
    pu, rp, inten = inputs
    want = np.asarray(jcbet.make_gain_fn(JConfig(**SMALL), jctx,
                                         backend="xla")(jnp.asarray(inten)))
    for fn in (gop.gain_pairs_reference, gop.gain_reference):
        assert _rel_l2(fn(*_t(pu, rp, inten)).numpy(), want) < 1e-6


def test_zero_intensity_gives_zero_gain(inputs):
    pu, rp, inten = inputs
    g = gop.gain(*_t(pu, rp, np.zeros_like(inten)))
    assert float(g.abs().max()) == 0.0


def test_pair_u_guards(inputs):
    """A wrong axis order is refused; a (b, b')-transposed pair_u passes
    every shape check and reverses the transfer: exactly the negated gain,
    since pair_u is antisymmetric and R is odd."""
    pu, rp, inten = inputs
    pu_t, rp_t, i_t = _t(pu, rp, inten)
    with pytest.raises(ValueError, match="pair_u"):
        gop.gain(pu_t.transpose(1, 2).contiguous(), rp_t, i_t)
    with pytest.raises(ValueError, match="pair_u"):
        gop.gain(pu_t[:, :2].contiguous(), rp_t, i_t)
    with pytest.raises(ValueError, match="rhat_pre"):
        gop.gain(pu_t, rp_t[:3].contiguous(), i_t)
    with pytest.raises(TypeError):
        gop.gain(pu_t, rp_t, i_t.double())
    g = gop.gain(pu_t, rp_t, i_t)
    g_rev = gop.gain(pu_t.transpose(0, 1).contiguous(), rp_t, i_t)
    assert float(g.abs().max()) > 0
    assert torch.equal(g_rev, -g)


def test_gain_wrapper_devices(inputs):
    pu, rp, inten = inputs
    args = _t(pu, rp, inten)
    assert torch.equal(gop.gain(*args), gop.gain_reference(*args))
    with pytest.raises(ValueError):
        gop.gain(*(a.to("meta") for a in args))


def test_upsampler_matches_jax():
    kw = dict(SMALL, cbet_grid_downsample=2)
    cfg, jcfg = Config(**kw), JConfig(**kw)
    hx, hy, hz = cfg.cbet_grid_shape
    g = np.random.default_rng(7).standard_normal(
        (cfg.nbeams, hx * hy * hz)).astype(np.float32)
    want = np.asarray(jcbet.make_gain_upsampler(jcfg)(jnp.asarray(g)))
    got = cbet.make_gain_upsampler(cfg)(torch.from_numpy(g))
    assert got.shape == (cfg.nbeams, cfg.nx * cfg.ny * cfg.nz)
    assert _rel_l2(got.numpy(), want) < 1e-6
