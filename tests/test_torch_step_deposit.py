"""The deposit of one step of launch tiles (K5's contract: BASELINE config
4 deposits a step at a time into a grid with nz + 2 > 128) and the helpers
that time the one-step kernel on config 4's steps
(``scripts/step_sweep.py``).

The plain version against the JAX package's K5 (``make_tile_deposit_hbm``,
interpreted, exact boundary rows) on a step of dense tiles; the box volumes,
the rows' corner energy and the capture of a trace's steps that
``step_sweep`` and ``chip_smoke.py`` phase 24 read.  The one-step kernel
itself is held against the plain version on the card in
``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbet_raytracing_3d_tpu.ops.pallas_deposit import (
    edep_zpad_shape, finalize_edep, make_tile_deposit_hbm)
from cbet_raytracing_3d_tpu_torch.config import Config
from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
from cbet_raytracing_3d_tpu_torch.ops import deposit as dep
from cbet_raytracing_3d_tpu_torch.scripts import step_sweep

torch.set_num_threads(1)

# a grid beyond the TPU's VMEM kernel (nz + 2 > 128): K5's regime
GRID = (20, 20, 130)
SHAPE = tuple(g + 2 for g in GRID)


def _dense_tiles(seed, n_tiles=8, rpt=64, span=3, face=True):
    """One step of ``n_tiles`` tiles of ``rpt`` rays, each tile's cells in
    a ``span``^3 region (many rays a node), neighbouring tiles side by side
    in rows of 4; the first column's tiles on the x = 0 face with a third
    of their rows exiting there (a negative weight)."""
    rng = np.random.default_rng(seed)
    n = n_tiles * rpt
    tile = np.arange(n) // rpt
    base = [(span + 1) * (tile % 4), (span + 1) * (tile // 4),
            np.full(n, 60)]
    cell = [(b + rng.integers(0, span, size=n)).astype(np.int32)
            for b in base]
    frac = [rng.uniform(-0.4999, 0.4999, size=n) for _ in range(3)]
    inc = rng.uniform(0.5, 2.0, size=n)
    if face:
        out = (tile % 4 == 0) & (rng.uniform(size=n) < 1 / 3)
        cell[0][out] = 0
        frac[0][out] = rng.uniform(-0.95, -0.55, size=int(out.sum()))
    inc[rng.uniform(size=n) < 0.2] = 0.0
    return cell, frac, inc


def _torch_rows(cell, frac, inc, dtype=torch.float32):
    return ([torch.from_numpy(c) for c in cell]
            + [torch.as_tensor(f, dtype=dtype) for f in frac]
            + [torch.as_tensor(inc, dtype=dtype)])


@pytest.mark.parametrize("face", [False, True])
def test_plain_matches_k5_interpret(face):
    """The f32 plain version against the JAX package's K5 itself
    (``make_tile_deposit_hbm``, interpret mode, exact boundary rows) on one
    step of dense tiles into a 22 x 22 x 132 grid.  K5 carries its weights
    as bf16 hi/lo parts, so the grids agree to its rounding: bar 2e-3 rel-L2
    as ``test_torch_config4``'s K5 trace (measured 6.8e-4), the totals 5e-4
    (measured 0.6-1.1e-4)."""
    cell, frac, inc = _dense_tiles(3, face=face)
    kern = make_tile_deposit_hbm(*GRID, 64, box=(8, 8, 8), tiles_per_block=1,
                                 interpret=True, exact_boundary=True)
    edep, oflow = kern(jnp.zeros(edep_zpad_shape(*GRID), jnp.float32),
                       *(jnp.asarray(c) for c in cell),
                       *(jnp.asarray(f, jnp.float32) for f in frac),
                       jnp.asarray(inc, jnp.float32))
    want = np.asarray(finalize_edep(edep, GRID[1], GRID[2]), np.float64)
    got, of = dep.deposit_reference(torch.zeros(SHAPE), *_torch_rows(
        cell, frac, inc))
    got = got.double().numpy()
    assert int(oflow) == int(of) == 0
    assert (want.min() < 0) == face
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-3
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=5e-4)


@pytest.mark.parametrize("case", ["dense tiles", "rows off the grid",
                                  "a run of dead rows"])
def test_box_volumes_match_the_blocks(case):
    """``step_sweep.box_volumes``: the node bounds of each 256-row block's
    live in-grid rows' corners, against a loop over the blocks; rows off
    the grid and dead rows do not widen a box, a block without such rows
    has none."""
    threads, dead = 256, 0
    cell, frac, inc = _dense_tiles(4, n_tiles=16, rpt=150)
    if case == "rows off the grid":
        cell[2][10:20] = 200
        inc[10:20] = 1.0
    elif case == "a run of dead rows":
        dead = 1024
        inc[1024:2048] = 0.0
    rows = _torch_rows(cell, frac, inc)
    want = []
    for b in range(-(-len(inc) // threads)):
        sl = slice(b * threads, (b + 1) * threads)
        lo, hi, live = [], [], inc[sl] != 0
        for c, f, size in zip(cell, frac, SHAPE):
            s = np.where(f[sl] < 0.5, -1, 1)
            lo.append(c[sl] + 1 + np.minimum(s, 0))
            hi.append(c[sl] + 1 + np.maximum(s, 0))
            live &= (lo[-1] >= 0) & (hi[-1] < size)
        if live.any():
            want.append(int(np.prod([h[live].max() - a[live].min() + 1
                                     for a, h in zip(lo, hi)])))
    assert step_sweep.box_volumes(rows, SHAPE) == want
    assert len(want) == -(-len(inc) // threads) - dead // threads


def test_corner_total_is_the_rows_energy():
    """``step_sweep.corner_total``, the float64 sum of the f32 corner
    values of the live in-grid rows: each row's weights sum to 1 along
    every axis (a boundary exit row's negative one too), so the total is
    the rows' ``inc`` to f32 rounding; rows off the grid are left out."""
    cell, frac, inc = _dense_tiles(5, n_tiles=20)
    cell[1][:7] = -5                          # off the grid
    inc[:7] = 1e3
    total = step_sweep.corner_total(_torch_rows(cell, frac, inc), SHAPE)
    np.testing.assert_allclose(total, inc[7:].sum(), rtol=1e-6)


def test_capture_keeps_two_steps_of_the_trace():
    """``step_sweep.capture_config4`` on a small scene in K5's regime (on
    the CPU): the rows of the trace's first step and of the first step
    after its width halved, copies of what the chunk loop deposits, and the
    trace stopped there."""
    cfg = Config(nbeams=2, rays_per_zone=1, tile_zones=2, nx=24, ny=24,
                 nz=130, tiles_per_block=1, deposit_batch_steps=1,
                 deposit_box_z=56)
    ctx = rt.prepare(cfg)
    (first, s0), (later, s1) = step_sweep.capture_config4(cfg, ctx, "cpu")
    n0, n1 = first[0].shape[0], later[0].shape[0]
    assert s0 == 0 < s1 < cfg.nt and 0 < n1 < n0 // 2
    assert n0 == rt.traced_state(ctx, "cpu").n
    assert len(first) == len(later) == 7 and all(
        a.shape == (n1,) for a in later)
    assert [a.dtype for a in first] == [torch.int32] * 3 + [torch.float32] * 4
    assert bool((first[6] != 0).any()) and bool((later[6] != 0).any())


def test_c_entries_match_their_declarations():
    """Every C entry of the kernels' sources (``extern "C"`` in
    ``csrc/*.cu``) is declared to ctypes with as many arguments as it takes
    (the deposit entries gained ``one_step``), and no declaration names an
    entry the sources lack.  Read from the sources on the CPU: nothing is
    built."""
    import ctypes
    import pathlib
    import re
    import types

    from cbet_raytracing_3d_tpu_torch.utils import cuda_build

    entries = {}
    for path in cuda_build.sources():
        text = pathlib.Path(path).read_text()
        body = text[text.index('extern "C" {'):]
        for name, params in re.findall(
                r"^(?:int|const char\*) (cbet_\w+)\(([^)]*)\)\s*\{", body,
                re.M):
            params = params.strip()
            entries[name] = (0 if params in ("", "void")
                             else params.count(",") + 1)

    class Lib:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, types.SimpleNamespace())

    lib = Lib()
    cuda_build._declare(lib)
    declared = {k: len(f.argtypes) for k, f in lib.fns.items()}
    assert "cbet_deposit_f32" in entries and "cbet_gain_f32" in entries
    assert declared == {k: entries[k] for k in declared}
    assert declared["cbet_deposit_f32"] == declared["cbet_deposit_f64"] == 18
    assert all(f.restype in (ctypes.c_int, ctypes.c_char_p)
               for f in lib.fns.values())
