"""The tensor-core probe (K6) on the CPU: its plain version against NumPy in
both lhs orientations, the wrapper's CPU path, its checks, and its shapes
and bound against the JAX package's ``scripts/bench_mxu_shapes.py``."""

import os
import re

import numpy as np
import pytest
import torch

from cbet_raytracing_3d_tpu_torch.ops import mma_probe as mp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bf16_operands(rng, m, k, n, transpose_lhs, dyadic):
    """Operands whose float32 values are bf16 values: k/256 in [0, 1)
    (``dyadic``: 8 significant bits, so products and their sums are exact
    in float32 at these sizes), or uniform values rounded to bf16."""
    ashape = (k, m) if transpose_lhs else (m, k)
    if dyadic:
        a = rng.integers(0, 256, size=ashape) / 256.0
        b = rng.integers(0, 256, size=(k, n)) / 256.0
    else:
        a = rng.random(ashape)
        b = rng.random((k, n))
    ta = torch.tensor(a, dtype=torch.float32).to(torch.bfloat16)
    tb = torch.tensor(b, dtype=torch.float32).to(torch.bfloat16)
    return ta, tb


@pytest.mark.parametrize("transpose_lhs", [False, True])
@pytest.mark.parametrize("m,k,n", [(16, 32, 16), (48, 64, 32)])
def test_plain_version_matches_numpy(transpose_lhs, m, k, n):
    """Exact on 8-bit dyadic values (every float32 sum is exact), within
    float32 rounding on random bf16 values; reps products summed."""
    rng = np.random.default_rng(m + k + n)
    reps = 4
    for dyadic in (True, False):
        a, b = _bf16_operands(rng, m, k, n, transpose_lhs, dyadic)
        a64 = a.double().numpy()
        want = reps * ((a64.T if transpose_lhs else a64) @ b.double().numpy())
        got = mp.mma_probe_reference(a, b, reps, transpose_lhs)
        assert got.dtype == torch.float32 and got.shape == (m, n)
        if dyadic:
            assert np.array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    a, b = _bf16_operands(np.random.default_rng(1), 32, 48, 16, True, False)
    before = mp.LAUNCHES
    got = mp.mma_probe(a, b, reps=3, transpose_lhs=True, grid=7)
    assert mp.LAUNCHES == before
    assert torch.equal(got, mp.mma_probe_reference(a, b, 3, True))
    with pytest.raises(ValueError, match="contracted"):
        mp.mma_probe(a, b, transpose_lhs=False)
    with pytest.raises(ValueError, match="2-D"):
        mp.mma_probe(a[None], b)


def test_shapes_and_bound_follow_the_tpu_script():
    """The six shapes of ``scripts/bench_mxu_shapes.py:78-84`` with its
    grid and reps; the bound is the launch's operations at the bf16 peak."""
    src = open(os.path.join(REPO, "scripts", "bench_mxu_shapes.py")).read()
    calls = re.findall(r'bench\("([^"]+)",\s*(\d+),\s*(\d+),\s*(\d+)'
                       r'(,\s*transpose_lhs=True)?\)', src)
    want = [(label, int(m), int(k), int(n), bool(tr))
            for label, m, k, n, tr in calls]
    assert list(mp.SHAPES) == want and len(want) == 6
    assert f"GRID = {mp.GRID}" in src and f"reps={mp.REPS}" in src
    assert mp.flops(896, 1280, 128) == 2 * 896 * 1280 * 128 * 8 * 512
    assert mp.bound_seconds(896, 1280, 128) == pytest.approx(
        mp.flops(896, 1280, 128) / 989e12)


@pytest.mark.parametrize("transpose_lhs", [False, True])
@pytest.mark.parametrize("chain", [16, 64, 192, 1000])
def test_plain_version_chain_lengths(transpose_lhs, chain):
    """``chain`` cuts the product into runs of k (the kernel's chains, with
    a ragged last run): exact on dyadic values, within float32 rounding of
    the whole-k product on random ones."""
    rng = np.random.default_rng(chain)
    m, k, n, reps = 32, 208, 48, 3
    a, b = _bf16_operands(rng, m, k, n, transpose_lhs, True)
    whole = mp.mma_probe_reference(a, b, reps, transpose_lhs)
    assert torch.equal(mp.mma_probe_reference(a, b, reps, transpose_lhs,
                                              chain=chain), whole)
    a, b = _bf16_operands(rng, m, k, n, transpose_lhs, False)
    whole = mp.mma_probe_reference(a, b, reps, transpose_lhs)
    got = mp.mma_probe_reference(a, b, reps, transpose_lhs, chain=chain)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=2e-6)
    if chain >= k:
        assert torch.equal(got, whole)


def test_chain_and_variant_checks():
    a, b = _bf16_operands(np.random.default_rng(2), 16, 32, 16, False, False)
    with pytest.raises(ValueError, match="chain"):
        mp.mma_probe_reference(a, b, chain=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        mp._launch(a, b)            # the kernel never runs on CPU tensors
    assert mp.CHAIN_SLICES is None and mp.SLICE == 64
