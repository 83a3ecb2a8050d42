"""The port's Config against the JAX package's: every field, default and
derived property, field by field."""

import dataclasses

import pytest
import torch

from cbet_raytracing_3d_tpu import config as jcfg
from cbet_raytracing_3d_tpu_torch import config as tcfg

torch.set_num_threads(1)

FIELDS = [f.name for f in dataclasses.fields(jcfg.Config)]
DERIVED = [n for n, v in vars(jcfg.Config).items() if isinstance(v, property)]
# configs that move every derived quantity: the OMEGA default, config 1,
# the reference-parity truncation, a high-resolution anisotropic grid
VARIANTS = [
    {},
    dict(nbeams=1, rays_per_zone=1, nx=40, ny=40, nz=40, dtype="float64"),
    dict(parity="reference", courant_mult=0.25),
    dict(nx=200, ny=180, nz=130, xmax=0.2, rays_per_zone=2,
         cbet_grid_downsample=3),
]


def test_same_fields_in_same_order():
    assert [f.name for f in dataclasses.fields(tcfg.Config)] == FIELDS


@pytest.mark.parametrize("name", FIELDS)
def test_field_default(name):
    want = getattr(jcfg.Config(), name)
    got = getattr(tcfg.Config(), name)
    assert type(got) is type(want) and got == want


@pytest.mark.parametrize("variant", range(len(VARIANTS)))
@pytest.mark.parametrize("name", DERIVED)
def test_derived_property(name, variant):
    kw = VARIANTS[variant]
    assert getattr(tcfg.Config(**kw), name) == getattr(jcfg.Config(**kw), name)


def test_round_trip_and_small_config():
    j = jcfg.small_test_config(nbeams=3)
    t = tcfg.Config(**dataclasses.asdict(j))
    assert t == tcfg.small_test_config(nbeams=3)
    # the port's own backend names; the TPU names are not accepted values
    assert tcfg.Config().deposit_backend == "auto"
    assert t.replace(nx=50).nx == 50
