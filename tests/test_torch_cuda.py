"""The port on the card: the CUDA kernels (the deposit K1, the grouped
deposit K2, the gain reduction K3 in its all-pairs and pair forms, the
window-gain deposit K4 in its "cell", "tri" and gain-only forms, the
tensor-core probe K6) against their plain PyTorch versions (K1's window, K2
and K4 also through each path of their tile box),
traces on the card against the CPU trace and the config-1 golden, the
on-card init against the host prepare, a compacted trace
against the uncompacted one, CBET solves (with the opt-ins) through the
kernels against solves through the plain versions, and a resumed
``run_composed`` and ``cbet_solve_composed``.  Marked ``cuda``; each
test skips without a CUDA device.

This file imports no JAX, so it also runs on a machine that has only the
port's dependencies (the repository's conftest imports jax, hence
``--noconftest``)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import deposit_rows, rel_l2, to_device
from cbet_raytracing_3d_tpu_torch.config import Config
from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
from cbet_raytracing_3d_tpu_torch.ops import deposit as dep
from cbet_raytracing_3d_tpu_torch.ops import gain as gop
from cbet_raytracing_3d_tpu_torch.ops import gain_deposit as gdep

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "config1_oracle.npz")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("grid,dtype,tol", [
    ((100, 100, 100), torch.float32, 1e-5),
    ((100, 100, 100), torch.float64, 1e-12),
    ((100, 100, 130), torch.float32, 1e-5),     # beyond the TPU VMEM limit
    ((7, 5, 3), torch.float64, 1e-12),
])
def test_kernel_matches_plain(cuda, grid, dtype, tol):
    rows = deposit_rows(np.random.default_rng(1), grid, 50_000, boundary=0.2)
    args = to_device(*rows, dtype, cuda)
    shape = tuple(g + 2 for g in grid)
    before = dep.LAUNCHES
    got, of = dep.deposit(torch.zeros(shape, dtype=dtype, device=cuda), *args)
    assert dep.LAUNCHES == before + 1
    want, of_p = dep.deposit_reference(
        torch.zeros(shape, dtype=dtype, device=cuda), *args)
    assert int(of) == int(of_p) == 0
    assert dep.LAUNCHES == before + 1
    assert rel_l2(got.cpu(), want.cpu()) < tol
    if min(grid) > 10:
        # boundary exit weights outweigh the ghost layer's positive ones
        assert want.min() < 0


def test_kernel_overflow_and_dead_rows(cuda):
    grid = (10, 10, 10)
    cell, frac, inc = deposit_rows(np.random.default_rng(2), grid, 1000)
    cell[0][:10] = 50                     # live rows off the grid
    inc[:10] = 1.0
    cell[1][10:20] = -40                  # dead rows off the grid
    inc[10:20] = 0.0
    args = to_device(cell, frac, inc, torch.float64, cuda)
    got, of = dep.deposit(torch.zeros((12, 12, 12), dtype=torch.float64,
                                      device=cuda), *args)
    want, of_p = dep.deposit_reference(
        torch.zeros((12, 12, 12), dtype=torch.float64, device=cuda), *args)
    assert int(of) == int(of_p) == 10
    assert rel_l2(got.cpu(), want.cpu()) < 1e-12


def test_kernel_rejects_bad_arguments(cuda):
    cell, frac, inc = deposit_rows(np.random.default_rng(3), (8, 8, 8), 64)
    args = to_device(cell, frac, inc, torch.float32, cuda)
    grid = torch.zeros((10, 10, 10), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        dep.deposit(grid.double(), *args)
    with pytest.raises(TypeError):
        dep.deposit(grid, *[a.long() for a in args[:3]], *args[3:])
    with pytest.raises(ValueError):
        dep.deposit(grid, *args[:6], args[6][::2])
    with pytest.raises(ValueError):
        dep.deposit(grid, *args[:6], args[6].cpu())


K1_WINDOW_CASES = {
    # case: (coherent, batch, dead rays, blocks in the default box)
    "coherent window": (True, 5, 0, "all"),
    "scattered window": (False, 5, 0, "some"),
    "a block of dead rays": (True, 5, 256, "all"),
    "10-step window": (True, 10, 0, "all"),
}


@pytest.mark.parametrize("case", sorted(K1_WINDOW_CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_kernel_window_paths(cuda, case, dtype, tol):
    """K1 on a step-major window against the plain version, against one
    direct launch per step and against the direct kernel over all its rows
    (capacity 0); the default sends a float32 window through the tile box
    and a float64 one down the window kernel's direct path; an explicit
    capacity boxes either."""
    coherent, batch, dead, expect = K1_WINDOW_CASES[case]
    grid, n_rays = (20, 18, 16), 4 * 2560
    cell, frac, inc = _k2_window(11, grid, n_rays, batch, coherent)
    for j in range(batch):
        inc[j * n_rays + 256:j * n_rays + 256 + dead] = 0.0
    args = to_device(cell, frac, inc, dtype, cuda)
    shape = tuple(g + 2 for g in grid)

    def zeros():
        return torch.zeros(shape, dtype=dtype, device=cuda)
    before = dep.LAUNCHES
    got, of = dep.deposit(zeros(), *args, n_rays)
    assert dep.LAUNCHES == before + 1
    want, of_p = dep.deposit_reference(zeros(), *args, n_rays)
    per_step = zeros()
    for j in range(batch):
        dep._launch(per_step, *(a[j * n_rays:(j + 1) * n_rays] for a in args))
    direct, boxed, default = zeros(), zeros(), zeros()
    of_d = dep._launch(direct, *args, n_rays, box_nodes=0)
    tally = torch.zeros(2, dtype=torch.int32, device=cuda)
    dep._launch(boxed, *args, n_rays, box_nodes=3072, tally=tally)
    tally_default = torch.zeros(2, dtype=torch.int32, device=cuda)
    dep._launch(default, *args, n_rays, tally=tally_default)
    assert dep.LAUNCHES == before + 1            # only the wrapper counts
    assert int(of) == int(of_p) == int(of_d) == 0
    for grid_k in (got, per_step, direct, boxed, default):
        assert rel_l2(grid_k.cpu(), want.cpu()) < tol
    blocks, in_box = (int(x) for x in tally.cpu())
    assert blocks == n_rays // 256 - dead // 256
    assert in_box == blocks if expect == "all" else 0 <= in_box < blocks
    blocks_d, in_box_d = (int(x) for x in tally_default.cpu())
    assert blocks_d == blocks
    assert in_box_d == (in_box if dtype == torch.float32 else 0)
    with pytest.raises(ValueError, match="whole steps"):
        dep.deposit(zeros(), *args, n_rays - 1)


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12),
                                       ("float32", 1e-5)])
def test_windowed_trace_on_card(cuda, dtype, tol):
    """The plain trace on the card deposits windows: K1 launches are a
    fifth of the steps, and the grid is the per-step trace's and the CPU
    trace's."""
    cfg = Config(nbeams=2, rays_per_zone=1, nx=40, ny=40, nz=40, dtype=dtype,
                 tiles_per_block=2)
    assert rt.batched(cfg)
    ctx = rt.prepare(cfg)
    state0 = rt.traced_state(ctx, cuda)
    field4 = ctx.field4.to(cuda)
    grids = {}
    for tag, c in (("window", cfg),
                   ("per-step", cfg.replace(deposit_batch_steps=1))):
        before = dep.LAUNCHES
        e, _, of, steps = rt.make_trace_fn(c)(field4, state0)
        launches = dep.LAUNCHES - before
        assert int(of) == 0 and steps > 0
        assert launches == (steps // 5 if tag == "window" else steps)
        grids[tag] = e.cpu()
    want, _ = rt.trace(ctx, "cpu")
    assert rel_l2(grids["window"], grids["per-step"]) < tol
    assert rel_l2(grids["window"], want) < tol


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12),
                                       ("float32", 1e-5)])
def test_trace_on_card_matches_cpu(cuda, dtype, tol):
    cfg = Config(nbeams=3, rays_per_zone=1, nx=32, ny=32, nz=32, dtype=dtype)
    ctx = rt.prepare(cfg)
    want, _ = rt.trace(ctx, "cpu")
    before = dep.LAUNCHES
    got, state = rt.trace(ctx, cuda)
    assert dep.LAUNCHES > before
    assert state.uray.is_cuda
    assert rel_l2(got, want) < tol


def test_config1_golden_on_card(cuda):
    data = np.load(GOLDEN)
    cfg = Config(nbeams=1, rays_per_zone=1, nx=40, ny=40, nz=40,
                 dtype="float64", deposit_backend="cuda")
    ctx = rt.prepare(cfg)
    s0 = rt.select_rays(ctx.state0, ctx.layout.slot_of[0, data["rays"]])
    edep, _, oflow, _ = rt.make_trace_fn(cfg)(ctx.field4.to(cuda),
                                              s0.to(cuda))
    assert int(oflow) == 0
    assert rel_l2(edep.cpu(), data["edep"]) < 1e-9


# ---- the CBET kernels (K2, K3, K4) against their plain versions ----------

CBET_SMALL = dict(nbeams=4, rays_per_zone=1, nx=32, ny=32, nz=32,
                  chunk_steps=8, deposit_batch_steps=4)


@pytest.fixture(scope="module")
def cbet_ctx():
    return rt.prepare(Config(**CBET_SMALL))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_grouped_kernel_matches_plain(cuda, dtype, tol):
    groups, rpg, batch = 4, 3000, 5
    grid = (20, 18, 16)
    rows = deposit_rows(np.random.default_rng(4), grid, batch * groups * rpg,
                        boundary=0.2)
    args = to_device(*rows, dtype, cuda)
    shape = (groups,) + tuple(g + 2 for g in grid)
    before = dep.GROUPED_LAUNCHES
    got, of = dep.deposit_grouped(torch.zeros(shape, dtype=dtype,
                                              device=cuda), *args, rpg,
                                  groups * rpg)
    want, of_p = dep.deposit_grouped_reference(
        torch.zeros(shape, dtype=dtype, device=cuda), *args, rpg,
        groups * rpg)
    assert dep.GROUPED_LAUNCHES == before + 1
    assert int(of) == int(of_p) == 0
    assert rel_l2(got.cpu(), want.cpu()) < tol
    with pytest.raises(ValueError):
        dep.deposit_grouped(got, *args, rpg - 1, groups * rpg)


def _k2_window(seed, grid, n_rays, batch, coherent):
    """K2 rows of a step-major window (``batch`` steps of ``n_rays`` rays):
    ``coherent`` keeps each ray within one cell of where it starts (tiles
    of 256 rays in 10-cell boxes, so each block's box stays small), else
    every step's tiles scatter over the grid; fracs beyond +-0.5 (negative
    weights) and dead rows in both."""
    rng = np.random.default_rng(seed)
    if not coherent:
        return deposit_rows(rng, grid, batch * n_rays, boundary=0.2)
    cell0, _, _ = deposit_rows(rng, grid, n_rays, boundary=0.0)
    steps = [deposit_rows(rng, grid, n_rays, boundary=0.2)
             for _ in range(batch)]
    cell = [np.concatenate([np.clip(c + rng.integers(-1, 2, n_rays), 0,
                                    g - 1) for _ in range(batch)])
            .astype(np.int32) for c, g in zip(cell0, grid)]
    frac = [np.concatenate([st[1][a] for st in steps]) for a in range(3)]
    inc = np.concatenate([st[2] for st in steps])
    return cell, frac, inc


K2_BOX_CASES = {
    # case: (coherent, batch, rays_per_group, dead rays, what the blocks do)
    "coherent window": (True, 5, 2560, 0, "box"),
    "scattered window": (False, 5, 2560, 0, "some direct"),
    "groups of 300 rays": (True, 5, 300, 0, "some direct"),
    "a block of dead rays": (True, 5, 2560, 256, "box"),
    "one step": (True, 1, 2560, 0, "box"),
    "10-step window": (True, 10, 2560, 0, "box"),
}


@pytest.mark.parametrize("case", sorted(K2_BOX_CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_grouped_kernel_box_paths(cuda, case, dtype, tol):
    """K2 through its shared-memory tile box against the plain version and
    against the direct path (capacity 0), in the cases that send blocks to
    the box, to the direct path within the box kernel (a box beyond the
    capacity, a block spanning two groups), on one step and on a long
    window; the tally counts the blocks that took the box."""
    coherent, batch, rpg, dead, expect = K2_BOX_CASES[case]
    groups, grid = 4, (20, 18, 16)
    n_rays = groups * 2560
    cell, frac, inc = _k2_window(7, grid, n_rays, batch, coherent)
    for j in range(batch):
        inc[j * n_rays + 256:j * n_rays + 256 + dead] = 0.0
    args = to_device(cell, frac, inc, dtype, cuda)
    shape = (-(-n_rays // rpg),) + tuple(g + 2 for g in grid)
    before = dep.GROUPED_LAUNCHES
    got, of = dep.deposit_grouped(torch.zeros(shape, dtype=dtype,
                                              device=cuda), *args, rpg,
                                  n_rays)
    assert dep.GROUPED_LAUNCHES == before + 1
    want, of_p = dep.deposit_grouped_reference(
        torch.zeros(shape, dtype=dtype, device=cuda), *args, rpg, n_rays)
    tally = torch.zeros(2, dtype=torch.int32, device=cuda)
    boxed = torch.zeros(shape, dtype=dtype, device=cuda)
    dep._launch_grouped(boxed, *args, rpg, n_rays, tally=tally)
    direct = torch.zeros(shape, dtype=dtype, device=cuda)
    of_d = dep._launch_grouped(direct, *args, rpg, n_rays, box_nodes=0)
    assert dep.GROUPED_LAUNCHES == before + 1
    assert int(of) == int(of_p) == int(of_d) == 0
    assert rel_l2(got.cpu(), want.cpu()) < tol
    assert rel_l2(boxed.cpu(), direct.cpu()) < tol
    blocks, in_box = (int(x) for x in tally.cpu())
    assert blocks == -(-n_rays // 256) - dead // 256
    if expect == "box":
        assert in_box == blocks
    else:
        assert 0 <= in_box < blocks


@pytest.mark.parametrize("bo", [3, 1])
def test_gain_kernel_matches_plain(cuda, cbet_ctx, bo):
    from chip_smoke import gain_case
    cfg = Config(**CBET_SMALL)
    pu, rp, inten = gain_case(np.random.default_rng(5), cfg, cbet_ctx, cuda)
    pu = pu[:bo].contiguous()
    before = gop.LAUNCHES
    got = gop.gain(pu, rp, inten)
    assert gop.LAUNCHES == before + 1
    want = gop.gain_reference(pu, rp, inten)
    assert float(want.abs().max()) > 0
    assert rel_l2(got.cpu(), want.cpu()) < 1e-5
    with pytest.raises(ValueError):
        gop.gain(pu.transpose(1, 2).contiguous(), rp, inten)
    with pytest.raises(TypeError):
        gop.gain(pu.double(), rp, inten)


@pytest.mark.parametrize("nbeams,nodes", [(4, 32 ** 3), (60, 20_000),
                                          (2, 1000), (13, 777)])
def test_gain_pair_kernel_equals_all_pairs_kernel(cuda, nbeams, nodes):
    """The pair kernel (each beam pair once) against the all-pairs kernel
    bit for bit, against both plain versions, and through the wrapper: the
    solver's couplings take it, the b_out form and perturbed couplings take
    the all-pairs kernel."""
    from cbet_raytracing_3d_tpu_torch.beams import load_beam_norms
    from cbet_raytracing_3d_tpu_torch.models import cbet
    from cbet_raytracing_3d_tpu_torch.utils import cuda_build
    rng = np.random.default_rng(8)
    pu = cbet.pair_couplings(load_beam_norms(nbeams=60)[:nbeams],
                             Config().machnum).astype(np.float32)
    rhat = rng.standard_normal((3, nodes))
    rhat /= np.linalg.norm(rhat, axis=0)
    rp = np.concatenate([rhat, rng.uniform(0.5, 2.0, (1, nodes))])
    pu, rp, inten = (torch.as_tensor(a, dtype=torch.float32, device=cuda)
                     for a in (pu, rp, rng.uniform(0, 1e14, (nbeams, nodes))))
    assert gop.pairs_antisymmetric(pu)
    lib = cuda_build.load()
    assert nbeams <= lib.cbet_gain_pairs_max_beams()
    pairs = gop._launch(lib, pu, rp, inten, True)
    every = gop._launch(lib, pu, rp, inten, False)
    assert float(every.abs().max()) > 0
    assert torch.equal(pairs, every)
    want = gop.gain_reference(pu, rp, inten)
    assert rel_l2(pairs.cpu(), want.cpu()) < 1e-5
    assert rel_l2(gop.gain_pairs_reference(pu, rp, inten).cpu(),
                  want.cpu()) < 1e-6
    counts = (gop.LAUNCHES, gop.PAIR_LAUNCHES)
    assert torch.equal(gop.gain(pu, rp, inten), pairs)
    assert (gop.LAUNCHES, gop.PAIR_LAUNCHES) == (counts[0] + 1, counts[1] + 1)
    if nbeams > 2:
        bo = pu[:2].contiguous()
        assert torch.equal(gop.gain(bo, rp, inten), every[:2])
    bad = pu.clone()
    bad[0, 1, 0] += 1e-3
    got = gop.gain(bad, rp, inten)
    assert gop.PAIR_LAUNCHES == counts[1] + 1    # neither took the pair kernel
    assert rel_l2(got.cpu(), gop.gain_reference(bad, rp, inten).cpu()) < 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_gain_window_kernel_matches_plain(cuda, cbet_ctx, dtype, tol):
    from chip_smoke import smooth_gain, window_case
    cfg = Config(**CBET_SMALL)
    gain = smooth_gain(np.random.default_rng(6), cfg, 40.0, dtype, cuda)
    st, args = window_case(cfg, cbet_ctx, cuda, dtype, 3 * cfg.nt // 8,
                           gain)
    before = gdep.LAUNCHES
    e_k, of_k, g_k, u_k = gdep.deposit_gain_window(
        torch.zeros(cfg.edep_shape, dtype=dtype, device=cuda), *args)
    assert gdep.LAUNCHES == before + 1
    e_p, of_p, g_p, u_p = gdep.deposit_gain_window_reference(
        torch.zeros(cfg.edep_shape, dtype=dtype, device=cuda), *args)
    assert int(of_k) == int(of_p) == 0
    for got, want in ((e_k, e_p), (g_k, g_p), (u_k, u_p)):
        assert rel_l2(got.cpu(), want.cpu()) < tol
    thr = cfg.stop_fraction * st.uray_init
    assert torch.equal(st.alive & (u_k > thr), st.alive & (u_p > thr))


@pytest.mark.parametrize("mode", ["lookup", "kernel_cell"])
def test_cbet_solve_on_card_matches_plain(cuda, cbet_ctx, mode):
    """The whole solve through the kernels against the same solve through
    the plain versions on the card (f64; the f32 gain kernel contracts into
    FMAs, so the fixed points differ at the f32 gain's rounding)."""
    from cbet_raytracing_3d_tpu_torch.models import cbet
    cfg = Config(**CBET_SMALL, dtype="float64", cbet_max_iters=3,
                 cbet_gain_mode=mode)
    ctx = rt.prepare(cfg)
    counts = (gop.LAUNCHES, dep.GROUPED_LAUNCHES, gdep.LAUNCHES)
    got = cbet.cbet_solve(cfg, ctx, cuda)
    assert gop.LAUNCHES - counts[0] == got.iterations
    assert dep.GROUPED_LAUNCHES > counts[1]
    assert (gdep.LAUNCHES > counts[2]) == (mode == "kernel_cell")
    want = cbet.cbet_solve(cfg, ctx, cuda, ops=cbet.plain_ops())
    assert got.iterations == want.iterations
    assert rel_l2(got.edep, want.edep) < 1e-6
    assert rel_l2(got.intensity, want.intensity) < 1e-6


def _window(cuda, cbet_ctx, dtype, tri, off_grid=0):
    """Phase 8's window case at CBET_SMALL, as K4 "cell" (with the entry
    cells) or "tri" (without) arguments; ``off_grid`` rows that deposit at
    step 0 get a deposit cell outside the grid."""
    from chip_smoke import smooth_gain, window_case
    cfg = Config(**CBET_SMALL)
    gain = smooth_gain(np.random.default_rng(6), cfg, 40.0, dtype, cuda)
    st, args = window_case(cfg, cbet_ctx, cuda, dtype, 3 * cfg.nt // 8,
                           gain)
    rows = torch.nonzero(args[6][0] != 0).reshape(-1)[:off_grid]
    args[0][0, rows] = cfg.nx + 5
    return cfg, st, (args[:10] + args[13:] if tri else args)


@pytest.mark.parametrize("tri,gain_only", [(True, False), (True, True),
                                           (False, True)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_gain_window_optin_kernels_match_plain(cuda, cbet_ctx, tri,
                                               gain_only, dtype, tol):
    """K4 "tri" and K4 gain-only against their plain versions: gamma, uout,
    edep (gain-only: bit-untouched) and the overflow of three rows whose
    deposit corners leave the grid."""
    cfg, st, args = _window(cuda, cbet_ctx, dtype, tri, off_grid=3)
    fn, ref = ((gdep.deposit_gain_window_tri,
                gdep.deposit_gain_window_tri_reference) if tri else
               (gdep.deposit_gain_window, gdep.deposit_gain_window_reference))
    e0 = torch.full(cfg.edep_shape, 0.5 if gain_only else 0.0, dtype=dtype,
                    device=cuda)
    counts = (gdep.LAUNCHES, gdep.TRI_LAUNCHES, gdep.GAIN_ONLY_LAUNCHES)
    e_k, of_k, g_k, u_k = fn(e0.clone(), *args, gain_only=gain_only)
    assert (gdep.LAUNCHES, gdep.TRI_LAUNCHES, gdep.GAIN_ONLY_LAUNCHES) == (
        counts[0], counts[1] + (tri and not gain_only),
        counts[2] + gain_only)
    e_p, of_p, g_p, u_p = ref(e0.clone(), *args, gain_only=gain_only)
    assert int(of_k) == int(of_p) == 3
    for got, want in ((g_k, g_p), (u_k, u_p)):
        assert rel_l2(got.cpu(), want.cpu()) < tol
    if gain_only:
        assert torch.equal(e_k, e0) and torch.equal(e_p, e0)
    else:
        assert rel_l2(e_k.cpu(), e_p.cpu()) < tol
    thr = cfg.stop_fraction * st.uray_init
    assert torch.equal(st.alive & (u_k > thr), st.alive & (u_p > thr))


def _k4_window(seed, n_beams, rpg, batch, coherent, dtype, device):
    """Synthetic window-gain arguments after ``edep`` ("cell" order, grid
    20 x 18 x 16): ``_k2_window``'s rows, path lengths, gain-free energies
    falling so that many rays die mid-window, entry cells one cell from
    the deposit cells, and a normal gain table of both signs."""
    grid = (20, 18, 16)
    n_rays = n_beams * rpg
    cell, frac, inc = _k2_window(seed, grid, n_rays, batch, coherent)
    rng = np.random.default_rng(seed + 1)
    uinit = rng.uniform(0.5, 2.0, n_rays) * 1e12
    decay = rng.uniform(0.0, 1.0, n_rays)
    u_nogain = np.concatenate([uinit * np.exp(-decay * (j + 1))
                               for j in range(batch)])
    ds = rng.uniform(0.5, 1.5, batch * n_rays) * (inc != 0)
    lag = [np.clip(c + rng.integers(-1, 2, c.size), 0, g - 1).astype(np.int32)
           for c, g in zip(cell, grid)]
    gain = rng.standard_normal((n_beams, int(np.prod(grid)))) * 0.05

    def t(a, dt=dtype, shape=(batch, n_rays)):
        return torch.as_tensor(a, dtype=dt, device=device).reshape(shape)
    ints = [t(a, torch.int32) for a in cell]
    flts = [t(a) for a in (*frac, inc, ds, u_nogain)]
    return grid, (*ints, *flts, t(uinit, shape=(n_rays,)),
                  *(t(a, torch.int32) for a in lag),
                  t(gain, shape=gain.shape), rpg, 0.1, 0.05)


K4_BOX_CASES = {
    # case: (coherent, batch, rays per beam, dead rays, capacity, expect)
    "coherent window": (True, 5, 2560, 0, -1, "box"),
    "capacity 1": (True, 5, 2560, 0, 1, "direct"),
    "scattered window": (False, 5, 2560, 0, -1, "some direct"),
    "beams of 300 rays": (True, 5, 300, 0, -1, "box"),
    "a block of dead rays": (True, 5, 2560, 256, -1, "box"),
    "one step": (True, 1, 2560, 0, -1, "box"),
    "10-step window": (True, 10, 2560, 0, -1, "box"),
    "the CBET window": (None, None, None, 0, -1, None),
}


@pytest.mark.parametrize("case", sorted(K4_BOX_CASES))
@pytest.mark.parametrize("tri", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_gain_window_box_paths(cuda, cbet_ctx, case, tri, dtype, tol):
    """K4 "cell" and "tri" with the edep deposit through the tile box,
    against the plain version (edep, gamma, uout, overflow) and against the
    direct path (capacity 0): a coherent window (every block in the box),
    a capacity of one node (every block falls back), scattered tiles (some
    fall back), beams that are not whole blocks (a block spans two beams
    and keeps the box: one edep grid), a block whose rays are all dead, one
    step (the per-step form), a 10-step window, and the CBET window of the
    small scene; the tally counts the blocks that took the box."""
    coherent, batch, rpg, dead, cap, expect = K4_BOX_CASES[case]
    if case == "the CBET window":
        cfg, _, args = _window(cuda, cbet_ctx, dtype, False)
        shape = cfg.edep_shape
    else:
        grid, args = _k4_window(8, 4, rpg, batch, coherent, dtype, cuda)
        shape = tuple(g + 2 for g in grid)
        if dead:
            args = list(args)
            for k in (6, 7):                  # inc and ds of rays 256..511
                args[k] = args[k].clone()
                args[k][:, 256:256 + dead] = 0.0
            args = tuple(args)
    streams, uinit, lags = args[:9], args[9], args[10:13]
    gain, rpg, clip, stop = args[13:]
    if tri:
        fn, ref = (gdep.deposit_gain_window_tri,
                   gdep.deposit_gain_window_tri_reference)
        call, lags, counter = args[:10] + args[13:], (), "TRI_LAUNCHES"
    else:
        fn, ref = (gdep.deposit_gain_window,
                   gdep.deposit_gain_window_reference)
        call, counter = args, "LAUNCHES"
    before = getattr(gdep, counter)
    e_k, of_k, g_k, u_k = fn(torch.zeros(shape, dtype=dtype, device=cuda),
                             *call)
    assert getattr(gdep, counter) == before + 1
    e_p, of_p, g_p, u_p = ref(torch.zeros(shape, dtype=dtype, device=cuda),
                              *call)
    tally = torch.zeros(2, dtype=torch.int32, device=cuda)
    outs = {}
    for name, nodes in (("box", cap), ("direct", 0)):
        outs[name] = gdep._launch(
            torch.zeros(shape, dtype=dtype, device=cuda), streams, uinit,
            lags, gain, rpg, clip, stop, False, box_nodes=nodes,
            tally=tally if name == "box" else None)
    assert getattr(gdep, counter) == before + 1
    assert int(of_k) == int(of_p) == int(outs["direct"][1]) == 0
    for got, want in ((e_k, e_p), (g_k, g_p), (u_k, u_p),
                      (outs["box"][0], outs["direct"][0])):
        assert rel_l2(got.cpu(), want.cpu()) < tol
    assert torch.equal(outs["box"][2], outs["direct"][2])
    assert float(e_p.abs().max()) > 0
    blocks, in_box = (int(x) for x in tally.cpu())
    if expect is None:                        # the small scene: any share
        assert 0 <= in_box <= blocks
        return
    dying = (g_p[0] > 0) & (g_p[-1] == 0)
    assert batch == 1 or int(dying.sum()) > 0
    assert blocks == -(-uinit.shape[0] // 256) - dead // 256
    if expect == "box":
        assert in_box == blocks
    elif expect == "direct":
        assert in_box == 0
    else:
        assert 0 <= in_box < blocks


def test_gain_window_tri_rejects_bad_arguments(cuda, cbet_ctx):
    """The wrapper raises on a wrong dtype, shape, layout or device instead
    of falling back to the plain version."""
    cfg, _, args = _window(cuda, cbet_ctx, torch.float32, True)
    edep = torch.zeros(cfg.edep_shape, dtype=torch.float32, device=cuda)
    fn = gdep.deposit_gain_window_tri
    before = (gdep.TRI_LAUNCHES, gdep.GAIN_ONLY_LAUNCHES)
    with pytest.raises(TypeError):
        fn(edep.double(), *args)
    with pytest.raises(TypeError):
        fn(edep, args[0].long(), *args[1:])
    with pytest.raises(ValueError):                  # uinit of another length
        fn(edep, *args[:9], args[9][:-1], *args[10:])
    with pytest.raises(ValueError):                  # not contiguous
        fn(edep, *args[:6], args[6].t().contiguous().t(), *args[7:])
    with pytest.raises(ValueError):                  # an input on the CPU
        fn(edep, *args[:8], args[8].cpu(), *args[9:])
    with pytest.raises(ValueError):                  # the grid on the CPU
        fn(edep.cpu(), *args, gain_only=True)
    assert before == (gdep.TRI_LAUNCHES, gdep.GAIN_ONLY_LAUNCHES)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_device_init_on_card_equals_host_prepare(cuda, dtype):
    """``prepare_device`` on the card computes in float64 with the host
    prepare's operations, then casts: every launched ray's state is the
    host's bit for bit; beam ids are -1 exactly on pad tiles."""
    cfg = Config(nbeams=3, rays_per_zone=2, nx=40, ny=40, nz=40,
                 tiles_per_block=2, dtype=dtype)
    ctx_h = rt.prepare(cfg)
    ctx_d = rt.prepare_device(cfg, device=cuda)
    assert ctx_d.compact and ctx_d.state0.uray.is_cuda
    ids, valid = rt.live_tile_ids(cfg, ctx_h.layout)
    rpt = ctx_h.layout.rays_per_tile
    state_h = rt.select_rays(ctx_h.state0, rt.tile_slots(ids[valid], rpt))
    sel = np.nonzero(np.repeat(valid, rpt))[0]
    state_d = rt.select_rays(ctx_d.state0, sel).to("cpu")
    m = state_h.alive
    assert torch.equal(state_d.alive, m) and int(m.sum()) > 0
    for name in ("frac", "vel", "kick", "cell"):
        for a, b in zip(getattr(state_d, name), getattr(state_h, name)):
            assert torch.equal(a[m], b[m]), name
    assert torch.equal(state_d.uray[m], state_h.uray[m])
    assert np.array_equal(ctx_d.beam_id == -1, np.repeat(~valid, rpt))


def _probe_operands(m, k, n, tr, device):
    from cbet_raytracing_3d_tpu_torch.scripts.bench_mma_shapes import operands
    return operands(m, k, n, tr, device, seed=m + k + n)


@pytest.mark.parametrize("shape", range(6))
def test_mma_probe_kernel_matches_plain(cuda, shape):
    """K6 (wgmma + TMA) against its plain version and against the earlier
    mma.sync kernel at each of the six shapes, with its launch count."""
    from cbet_raytracing_3d_tpu_torch.ops import mma_probe as mp
    _, m, k, n, tr = mp.SHAPES[shape]
    a, b = _probe_operands(m, k, n, tr, cuda)
    before = (mp.LAUNCHES, mp.WMMA_LAUNCHES)
    got = mp.mma_probe(a, b, mp.REPS, tr, 4)
    # the public wrapper takes the wgmma kernel
    assert (mp.LAUNCHES, mp.WMMA_LAUNCHES) == (before[0] + 1, before[1])
    want = mp.mma_probe_reference(a, b, mp.REPS, tr)
    assert rel_l2(got.cpu(), want.cpu()) < 1e-5
    old = mp._launch(a, b, mp.REPS, tr, 4, variant="wmma")
    assert (mp.LAUNCHES, mp.WMMA_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert rel_l2(got.cpu(), old.cpu()) < 1e-5


@pytest.mark.parametrize("tr", [False, True])
@pytest.mark.parametrize("m,k,n", [(16, 64, 128), (80, 64, 128),
                                   (64, 16, 128), (64, 48, 128),
                                   (64, 128, 16), (16, 16, 16),
                                   (144, 208, 272)])
def test_mma_probe_kernel_ragged_shapes(cuda, m, k, n, tr):
    """Tiles, slices and columns that the tensor does not fill (TMA's zero
    fill, the skipped k steps, the unstored rows), in both forms, through
    every chain mode."""
    from cbet_raytracing_3d_tpu_torch.ops import mma_probe as mp
    a, b = _probe_operands(m, k, n, tr, cuda)
    want = mp.mma_probe_reference(a, b, 3, tr).cpu()
    got = mp.mma_probe(a, b, 3, tr, 2)
    assert got.shape == (m, n) and rel_l2(got.cpu(), want) < 1e-5
    old = mp._launch(a, b, 3, tr, 2, variant="wmma")
    assert rel_l2(got.cpu(), old.cpu()) < 1e-5
    for slices, resident in ((1, True), (2, False), (None, False)):
        out = mp._launch(a, b, 3, tr, 2, chain_slices=slices,
                         resident=resident)
        assert rel_l2(out.cpu(), want) < 1e-5, (slices, resident)


def test_mma_probe_kernel_rejects_bad_arguments(cuda):
    from cbet_raytracing_3d_tpu_torch.ops import mma_probe as mp
    a, b = _probe_operands(64, 64, 64, False, cuda)
    with pytest.raises(TypeError):
        mp.mma_probe(a.float(), b)
    with pytest.raises(ValueError, match="contiguous"):
        mp.mma_probe(a.t(), b)                      # (64, 64) but strided
    with pytest.raises(ValueError, match="multiples of 16"):
        mp.mma_probe(a[:, :-8].contiguous(), b[:-8].contiguous())
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(64 * 64 + 1, dtype=torch.bfloat16, device=cuda)
        mp.mma_probe(flat[1:].view(64, 64), b)
    with pytest.raises(ValueError, match="resident"):
        a2, b2 = _probe_operands(64, 1280, 64, False, cuda)
        mp._launch(a2, b2, chain_slices=None, resident=True)
    with pytest.raises(ValueError, match="grid"):
        mp.mma_probe(a, b, grid=0)


def test_compacted_trace_on_card_matches_plain(cuda):
    """One compacted trace against the uncompacted one on the card at
    config-1 scale (float64; the atomics add in another order)."""
    cfg = Config(nbeams=1, rays_per_zone=1, nx=40, ny=40, nz=40,
                 dtype="float64")
    ctx = rt.prepare_device(cfg, device=cuda)
    state0 = rt.traced_state(ctx, cuda)
    e_p, s_p, _, n_p = rt.make_trace_fn(cfg)(ctx.field4, state0)
    widths = []
    e_c, s_c, _, n_c = rt.make_trace_fn(cfg, compact=True)(
        ctx.field4, state0, widths)
    assert n_p == n_c > 0 and len(widths) >= 2
    assert rel_l2(e_c.cpu(), e_p.cpu()) < 1e-12
    assert torch.equal(s_c.alive, s_p.alive)
    assert rel_l2(s_c.uray.cpu(), s_p.uray.cpu()) < 1e-12


@pytest.mark.parametrize("over", [
    dict(cbet_gain_mode="kernel"),
    dict(cbet_gain_mode="kernel_cell", cbet_light_iterations=True),
    dict(cbet_light_iterations=True),
    dict(cbet_accel="anderson"),
    dict(cbet_gain_stride=4),
])
def test_cbet_optin_solve_on_card_matches_plain(cuda, cbet_ctx, over):
    """Each opt-in's whole solve through the kernels against the same solve
    through the plain versions on the card (f64), with its kernels'
    launches."""
    from cbet_raytracing_3d_tpu_torch.models import cbet
    cfg = Config(**CBET_SMALL, dtype="float64", cbet_max_iters=3, **over)
    ctx = rt.prepare(cfg)
    counts = (gdep.TRI_LAUNCHES, gdep.GAIN_ONLY_LAUNCHES, dep.LAUNCHES)
    got = cbet.cbet_solve(cfg, ctx, cuda)
    assert (gdep.TRI_LAUNCHES > counts[0]) == ("cbet_gain_mode" in over
                                               and over["cbet_gain_mode"]
                                               == "kernel")
    assert (gdep.GAIN_ONLY_LAUNCHES > counts[1]) == (
        "cbet_gain_mode" in over and "cbet_light_iterations" in over)
    assert dep.LAUNCHES > counts[2] or "cbet_gain_mode" in over
    assert got.stats["light_iterations"] == ("cbet_light_iterations" in over)
    want = cbet.cbet_solve(cfg, ctx, cuda, ops=cbet.plain_ops())
    assert got.iterations == want.iterations
    assert rel_l2(got.edep, want.edep) < 1e-6
    assert rel_l2(got.intensity, want.intensity) < 1e-6


def test_run_composed_resumes_on_card(cuda, tmp_path):
    """``run_composed`` on the card, stopped mid-trace and resumed: the
    state-derived stats, the widths and the steps equal the uninterrupted
    run's, edep within the float64 atomics' drift; another config's
    checkpoint is refused."""
    from cbet_raytracing_3d_tpu_torch.runner import run_composed
    cfg = Config(nbeams=2, rays_per_zone=1, nx=40, ny=40, nz=40,
                 tiles_per_block=2, dtype="float64", chunk_steps=10)
    full = run_composed(cfg, device=cuda, verbose=False)
    assert len(full.stats["tile_widths"]) >= 3
    before = dep.LAUNCHES
    path = str(tmp_path / "trace.npz")
    assert run_composed(cfg, device=cuda, verbose=False, checkpoint_path=path,
                        stop_after_chunks=7) is None
    res = run_composed(cfg, device=cuda, verbose=False, checkpoint_path=path,
                       resume=True)
    assert (dep.LAUNCHES - before) * cfg.deposit_batch_steps == \
        full.stats["steps_executed"]
    for key in full.stats:
        if key != "edep_total":
            assert res.stats[key] == full.stats[key], key
    assert rel_l2(res.edep, full.edep) < 1e-12
    with pytest.raises(ValueError, match="fingerprint"):
        run_composed(cfg.replace(intensity=2e14), device=cuda, verbose=False,
                     checkpoint_path=path, resume=True)
    with pytest.raises(ValueError, match="fingerprint"):      # a CPU run
        run_composed(cfg, device="cpu", verbose=False, checkpoint_path=path,
                     resume=True)


@pytest.mark.parametrize("groups", [1, 2])
def test_cbet_solve_composed_resumes_on_card(cuda, tmp_path, groups):
    """``cbet_solve_composed`` on the card (float64) against the segmented
    lookup ``cbet_solve``, stopped after an iteration and resumed, and
    resumed again on the converged checkpoint without a launch."""
    from cbet_raytracing_3d_tpu_torch.models import cbet
    from cbet_raytracing_3d_tpu_torch.models.cbet_composed import \
        cbet_solve_composed
    cfg = Config(nbeams=4, rays_per_zone=1, nx=40, ny=40, nz=40,
                 cbet_max_iters=8, cbet_tol=1e-3, dtype="float64",
                 tiles_per_block=1, chunk_steps=8, deposit_batch_steps=4)
    ctx = rt.prepare_device(cfg, device=cuda)
    mono = cbet.cbet_solve(cfg.replace(cbet_segmented=True), ctx, cuda)
    path = str(tmp_path / "cbet.npz")
    assert cbet_solve_composed(cfg, ctx, device=cuda, beam_groups=groups,
                               checkpoint_path=path, verbose=False,
                               stop_after_iterations=2) is None
    res = cbet_solve_composed(cfg, ctx, device=cuda, beam_groups=groups,
                              checkpoint_path=path, resume=True,
                              verbose=False)
    assert res.converged and res.iterations == mono.iterations
    np.testing.assert_allclose(res.history, mono.history, rtol=1e-6)
    assert rel_l2(res.edep, mono.edep) < 1e-10
    assert rel_l2(res.intensity, mono.intensity) < 1e-10
    counts = (dep.LAUNCHES, dep.GROUPED_LAUNCHES, gop.LAUNCHES)
    again = cbet_solve_composed(cfg, ctx, device=cuda, beam_groups=groups,
                                checkpoint_path=path, resume=True,
                                verbose=False)
    assert counts == (dep.LAUNCHES, dep.GROUPED_LAUNCHES, gop.LAUNCHES)
    assert np.array_equal(again.edep, res.edep)
    assert again.stats["rays_terminated"] == res.stats["rays_terminated"]
