"""The port's deposit against the JAX package's: the plain version
(``deposit_reference``) against the XLA scatter backend and against the
Pallas K1 kernel in interpret mode (precise, exact boundary); energy
conservation; the overflow contract; and the no-fallback rules of the
wrapper.  The CUDA kernel itself is held against the plain version on the
card in ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbet_raytracing_3d_tpu.config import Config as JConfig
from cbet_raytracing_3d_tpu.models.raytracer import _scatter_deposit
from cbet_raytracing_3d_tpu.ops.pallas_deposit import (
    edep_zpad_shape, finalize_edep, make_tile_deposit)
from cbet_raytracing_3d_tpu_torch.config import Config
from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
from cbet_raytracing_3d_tpu_torch.ops import deposit as dep
from cbet_raytracing_3d_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

JCFG = JConfig(nx=24, ny=20, nz=22)
GRID = (JCFG.nx, JCFG.ny, JCFG.nz)
SHAPE3 = JCFG.edep_shape


def _random_rays(rng, n, cell_lo=(0, 0, 0), cell_hi=GRID):
    cell = [rng.integers(cell_lo[a], cell_hi[a], size=n).astype(np.int32)
            for a in range(3)]
    frac = [rng.uniform(-0.4999, 0.4999, size=n) for _ in range(3)]
    inc = rng.uniform(0.5, 2.0, size=n)
    return cell, frac, inc


def _coherent_tiles(rng, n_tiles=5, rpt=64):
    """Tiles whose rays sit in a small box (tests/test_deposit.py)."""
    cells, fracs, incs = [], [], []
    for _ in range(n_tiles):
        ox = rng.integers(0, GRID[0] - 12, size=3)
        c, f, i = _random_rays(rng, rpt, cell_lo=ox, cell_hi=ox + 10)
        cells.append(c); fracs.append(f); incs.append(i)
    return ([np.concatenate([c[a] for c in cells]) for a in range(3)],
            [np.concatenate([f[a] for f in fracs]) for a in range(3)],
            np.concatenate(incs))


def _boundary_rays(rng, n):
    """Rays near the low faces with boundary exit rows (frac beyond -0.5,
    so one per-axis weight goes negative; tests/test_deposit.py)."""
    cell, frac, inc = _random_rays(rng, n, cell_lo=(0, 0, 0), cell_hi=(8, 8, 8))
    exit_rows = rng.permutation(n)[:n // 3]
    for a in range(3):
        rows = exit_rows[a::3]
        cell[a][rows] = 0
        frac[a][rows] = rng.uniform(-0.95, -0.55, size=rows.size)
    return cell, frac, inc


def _plain(cell, frac, inc, dtype=torch.float64, shape=SHAPE3):
    edep = torch.zeros(shape, dtype=dtype)
    out, of = dep.deposit_reference(
        edep, *(torch.from_numpy(np.asarray(c, np.int32)) for c in cell),
        *(torch.as_tensor(np.asarray(f), dtype=dtype) for f in frac),
        torch.as_tensor(np.asarray(inc), dtype=dtype))
    assert out is edep          # in place
    return out.numpy().astype(np.float64), int(of)


def _jax_scatter(cell, frac, inc):
    got = _scatter_deposit(JCFG, jnp.zeros(SHAPE3),
                           tuple(jnp.asarray(c) for c in cell),
                           tuple(jnp.asarray(f) for f in frac),
                           jnp.asarray(inc))
    return np.asarray(got)


def _jax_pallas_exact(cell, frac, inc, rpt):
    k = make_tile_deposit(*GRID, rays_per_tile=rpt, box=16, tiles_per_block=1,
                          interpret=True, precise=True, exact_boundary=True)
    edep, oflow = k(jnp.zeros(edep_zpad_shape(*GRID), jnp.float32),
                    *(jnp.asarray(c, jnp.int32) for c in cell),
                    *(jnp.asarray(f, jnp.float32) for f in frac),
                    jnp.asarray(inc, jnp.float32))
    return (np.asarray(finalize_edep(edep, GRID[1], GRID[2]), np.float64),
            int(oflow))


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("kind", ["random", "coherent", "boundary"])
def test_plain_matches_jax_scatter(kind, rng):
    if kind == "random":
        cell, frac, inc = _random_rays(rng, 300)
    elif kind == "coherent":
        cell, frac, inc = _coherent_tiles(rng)
    else:
        cell, frac, inc = _boundary_rays(rng, 96)
    got, of = _plain(cell, frac, inc)
    assert of == 0
    np.testing.assert_allclose(got, _jax_scatter(cell, frac, inc),
                               rtol=1e-12, atol=1e-12 * np.abs(inc).max())


@pytest.mark.parametrize("kind", ["coherent", "boundary"])
def test_plain_matches_pallas_kernel_interpret(kind, rng):
    """f32 plain version vs the Pallas K1 kernel itself (interpret mode,
    precise weights, exact boundary rows)."""
    if kind == "coherent":
        cell, frac, inc = _coherent_tiles(rng)
        rpt = 64
    else:
        cell, frac, inc = _boundary_rays(rng, 64)
        rpt = 64
    want, oflow = _jax_pallas_exact(cell, frac, inc, rpt)
    assert oflow == 0
    got, of = _plain(cell, frac, inc, dtype=torch.float32)
    assert of == 0
    if kind == "boundary":
        assert want.min() < 0   # the extrapolated negative weights are there
    assert _rel_l2(got, want) < 1e-5
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-5)


def test_plain_matches_literal_corner_scheme(rng):
    """The a1..a8 transcription of launch_ray_XZ.cu:319-348, row by row."""
    cell, frac, inc = _boundary_rays(rng, 60)
    want = np.zeros(SHAPE3)
    for i in range(len(inc)):
        c = [cell[a][i] for a in range(3)]
        p = [frac[a][i] - 0.5 for a in range(3)]
        d = [1 - abs(q) for q in p]
        s = [-1 if q < 0 else 1 for q in p]
        for ox, wx in ((0, 1 - d[0]), (s[0], d[0])):
            for oy, wy in ((0, 1 - d[1]), (s[1], d[1])):
                for oz, wz in ((0, 1 - d[2]), (s[2], d[2])):
                    want[c[0] + 1 + ox, c[1] + 1 + oy, c[2] + 1 + oz] += (
                        wx * wy * wz * inc[i])
    got, _ = _plain(cell, frac, inc)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * want.max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_energy_conservation(dtype, rng):
    cell, frac, inc = _boundary_rays(rng, 400)
    got, _ = _plain(cell, frac, inc, dtype=dtype)
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(got.sum(), inc.sum(), rtol=rtol)


def test_dead_rows_ignored_and_overflow_counted(rng):
    """inc == 0 rows never write, even with cells outside the grid; a live
    row with a corner outside the grid is counted and not written."""
    cell, frac, inc = _random_rays(rng, 64, cell_lo=(4, 4, 4),
                                   cell_hi=(10, 10, 10))
    poison = np.arange(64) % 4 == 0
    for a in range(3):
        cell[a] = np.where(poison, 10_000, cell[a]).astype(np.int32)
    inc = np.where(poison, 0.0, inc)
    cell[0][1] = GRID[0] + 5                  # one live row off the grid
    got, of = _plain(cell, frac, inc)
    assert of == 1
    keep = ~poison
    keep[1] = False
    want = _jax_scatter([c[keep] for c in cell], [f[keep] for f in frac],
                        inc[keep])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _window(rng, batch=5, n=192):
    """A step-major window of ``batch`` steps of ``n`` rays: coherent tiles
    with boundary exit rows (a negative weight) and dead rows, float64
    NumPy."""
    steps = []
    for _ in range(batch):
        cell, frac, inc = _coherent_tiles(rng, n_tiles=n // 64)
        bc, bf, bi = _boundary_rays(rng, n)
        edge = rng.uniform(size=n) < 0.2
        cell = [np.where(edge, b, c).astype(np.int32)
                for c, b in zip(cell, bc)]
        frac = [np.where(edge, b, f) for f, b in zip(frac, bf)]
        inc = np.where(rng.uniform(size=n) < 0.3, 0.0, inc)
        steps.append((cell, frac, inc))
    cat = [np.concatenate([st[0][a] for st in steps]) for a in range(3)] \
        + [np.concatenate([st[1][a] for st in steps]) for a in range(3)] \
        + [np.concatenate([st[2] for st in steps])]
    return cat


@pytest.mark.parametrize("wrapper", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_window_equals_per_step_calls_bitwise(dtype, wrapper, rng):
    """K1's plain version on a step-major window (``n_rays``) equals one
    call per step bit for bit, boundary exit rows and dead rows included;
    the wrapper on the CPU is that plain version."""
    n, batch = 192, 5
    rows = _window(rng, batch, n)
    args = [torch.from_numpy(a) for a in rows[:3]] \
        + [torch.as_tensor(a, dtype=dtype) for a in rows[3:]]
    fn = dep.deposit if wrapper else dep.deposit_reference
    win, of_w = fn(torch.zeros(SHAPE3, dtype=dtype), *args, n)
    per = torch.zeros(SHAPE3, dtype=dtype)
    for j in range(batch):
        per, of = fn(per, *(a[j * n:(j + 1) * n] for a in args))
        assert int(of) == 0
    assert int(of_w) == 0 and float(win.min()) < 0 < float(win.max())
    assert int((args[6] == 0).sum()) > 0
    assert torch.equal(win, per)
    # the default is one step of all the rows: the same sum order again
    one, _ = fn(torch.zeros(SHAPE3, dtype=dtype), *args)
    assert torch.equal(one, win)


@pytest.mark.parametrize("n_rays", [7, 0, -192, 193])
def test_window_of_ragged_steps_raises(n_rays, rng):
    rows = _window(rng, 5, 192)
    args = [torch.from_numpy(a) for a in rows]
    for fn in (dep.deposit, dep.deposit_reference):
        grid = torch.zeros(SHAPE3, dtype=torch.float64)
        with pytest.raises(ValueError, match="whole steps"):
            fn(grid, *args, n_rays)
        assert float(grid.abs().max()) == 0.0     # nothing was written


def test_wrapper_on_cpu_is_the_plain_version(rng):
    cell, frac, inc = _coherent_tiles(rng)
    args = ([torch.from_numpy(c) for c in cell]
            + [torch.from_numpy(f) for f in frac] + [torch.from_numpy(inc)])
    before = dep.LAUNCHES
    a, of_a = dep.deposit(torch.zeros(SHAPE3, dtype=torch.float64), *args)
    b, of_b = dep.deposit_reference(torch.zeros(SHAPE3, dtype=torch.float64),
                                    *args)
    assert torch.equal(a, b) and int(of_a) == int(of_b) == 0
    assert dep.LAUNCHES == before     # the CPU path launches no kernel
    with pytest.raises(ValueError):
        dep.deposit(torch.zeros(SHAPE3, dtype=torch.float64,
                                device="meta"), *args)


def test_cuda_backend_never_falls_back():
    """deposit_backend='cuda' without CUDA tensors raises; 'torch' refuses
    the card; the trace and the runner surface both."""
    cfg = Config(nbeams=1, rays_per_zone=1, nx=20, ny=20, nz=20,
                 deposit_backend="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        rt.resolve_deposit_fn(cfg, "cpu")
    with pytest.raises(RuntimeError, match="CPU only"):
        rt.resolve_deposit_fn(cfg.replace(deposit_backend="torch"), "cuda")
    assert rt.resolve_deposit_fn(cfg.replace(deposit_backend="torch"),
                                 "cpu") is dep.deposit_reference
    assert rt.resolve_deposit_fn(cfg.replace(deposit_backend="auto"),
                                 "cpu") is dep.deposit
    from cbet_raytracing_3d_tpu_torch.runner import run
    with pytest.raises(RuntimeError, match="cuda"):
        run(cfg, device="cpu", verbose=False)


def test_failed_build_raises(monkeypatch, tmp_path):
    """No nvcc: the build raises (there is no kernel fallback)."""
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build(force=True)
    assert cuda_build.sources() and cuda_build.library_path().endswith(".so")
