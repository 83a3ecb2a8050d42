"""The port on the card: the CUDA deposit kernel against its plain PyTorch
version, and traces on the card against the CPU trace and the config-1
golden.  Marked ``cuda``; each test skips without a CUDA device.

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
