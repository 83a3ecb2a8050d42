"""BASELINE config 4 in the port on the CPU (``scripts/config4.py``):
``CONFIG4`` against the JAX package's config-4 scripts, the composed solve
of a config-4-shaped small scene and the composed trace of a scene in the
regime where the JAX trace takes K5 (``nz + 2 > 128``) against the JAX
package's, ``hold_config4`` against the JAX records, the script's record
and refusal, and the CBET stage's memory estimate against the peaks read on
the card."""

import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbet_raytracing_3d_tpu import runner as jrunner
from cbet_raytracing_3d_tpu.config import Config as JConfig
from cbet_raytracing_3d_tpu.models import cbet as jcbet
from cbet_raytracing_3d_tpu.models import cbet_composed as jcomposed
from cbet_raytracing_3d_tpu.models import raytracer as jrt
from cbet_raytracing_3d_tpu_torch import runner
from cbet_raytracing_3d_tpu_torch.config import Config
from cbet_raytracing_3d_tpu_torch.models import raytracer as rt
from cbet_raytracing_3d_tpu_torch.models.cbet_composed import \
    cbet_solve_composed
from cbet_raytracing_3d_tpu_torch.scripts import config4 as c4

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a config-4-shaped scene: 2 x 2 zones a tile, a deposit per step, the CBET
# fields on the 2x coarse grid, 4 beams in 2 serial groups
SHAPED = dict(nbeams=4, rays_per_zone=1, tile_zones=2, nx=32, ny=32, nz=32,
              tiles_per_block=1, chunk_steps=40, deposit_batch_steps=1,
              cbet_grid_downsample=2, cbet_max_iters=8, cbet_tol=1e-3)
# the regime in which the JAX trace deposits through K5 (nz + 2 > 128)
TALL = dict(nbeams=2, rays_per_zone=1, tile_zones=2, nx=24, ny=24, nz=130,
            tiles_per_block=1, deposit_batch_steps=1, deposit_box_z=56)
COUNTS = ("rays_total", "rays_launched", "rays_alive_at_end",
          "rays_terminated")


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _config_kwargs(script: str, target: str) -> dict:
    """The keywords of the ``Config(...)`` call assigned to ``target`` in a
    script of the JAX package, read with ``ast`` (the script is not run)."""
    with open(os.path.join(REPO, "scripts", script)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == target
                        for t in node.targets)
                and isinstance(node.value, ast.Call)
                and getattr(node.value.func, "id", None) == "Config"):
            return {k.arg: ast.literal_eval(k.value)
                    for k in node.value.keywords}
    raise AssertionError(f"no {target} = Config(...) in {script}")


def test_config4_is_the_jax_scripts_config():
    """``CONFIG4`` is the Config of ``scripts/run_config4_cbet_r05.py``
    field for field (its other fields the defaults), and its trace fields
    are those of ``scripts/run_config4_fast.py``."""
    cbet_kw = _config_kwargs("run_config4_cbet_r05.py", "CFG")
    fast_kw = _config_kwargs("run_config4_fast.py", "cfg")
    assert c4.CONFIG4 == Config(**cbet_kw)
    for k, v in cbet_kw.items():
        assert getattr(c4.CONFIG4, k) == v, k
    assert set(cbet_kw) - set(fast_kw) == {"cbet_grid_downsample"}
    for k, v in fast_kw.items():
        assert getattr(c4.CONFIG4, k) == v, k
    assert c4.GROUPS == 4
    assert c4.CONFIG4.total_rays == 64_273_500 and c4.CONFIG4.nt == 800
    assert runner.traced_slots(c4.CONFIG4) == 60480 * 900
    assert c4.CONFIG4.cbet_grid_shape == (100, 100, 100)
    assert c4.is_config4(c4.CONFIG4.replace(dtype="float64"))
    assert not c4.is_config4(c4.CONFIG4.replace(nz=100))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_composed_solve_of_a_config4_shaped_scene_matches_jax(
        tmp_path, profiles, dtype):
    """The port's ``cbet_solve_composed`` (2 groups) against the JAX
    package's on the same seeded scene.

    * Against the JAX composed solve, which runs Pallas backends only
      (``cbet_composed.py:78-81`` refuses "scatter"), interpreted here: its
      trilinear weights are bf16, hence the bars of 2e-3 of
      ``test_composed_matches_jax_composed`` (measured 5.4e-4 here).
    * Against the JAX monolithic solve of the same model on the exact
      "scatter" backend: edep and intensity within 1e-8 in f64 (measured
      1e-9: both gains are float32 on any ray dtype, and single ulps of the
      gain move the intensity ~1e-9) and 1e-6 in f32 (measured 1.2e-7);
      the history within 1e-4 relative (measured 2.8e-6: the residual is a
      difference ~1e-4 of the intensity, which magnifies those ulps)."""
    cfg = Config(**SHAPED, dtype=dtype)
    ctx = rt.prepare(cfg)
    port = cbet_solve_composed(cfg, ctx, device="cpu", beam_groups=2,
                               verbose=False)
    jcfg = JConfig(**SHAPED, dtype=dtype, cbet_segmented=True,
                   cbet_plan_headroom=0.0)
    jctx = jrt.prepare(jcfg, profiles)
    comp = jcomposed.cbet_solve_composed(
        jcfg, jctx, backend="pallas_interpret", beam_groups=2,
        cache_dir=str(tmp_path), verbose=False)
    mono = jcbet.cbet_solve(jcfg.replace(cbet_segmented=False), jctx,
                            backend="scatter")
    assert port.converged and comp.converged and mono.converged
    assert port.iterations == comp.iterations == mono.iterations >= 3
    np.testing.assert_allclose(port.history, comp.history, rtol=2e-3)
    assert _rel_l2(port.intensity, comp.intensity) < 2e-3
    assert _rel_l2(port.edep, comp.edep) < 2e-3
    tight = 1e-8 if dtype == "float64" else 1e-6
    np.testing.assert_allclose(port.history, mono.history, rtol=1e-4)
    assert _rel_l2(port.intensity, mono.intensity) < tight
    assert _rel_l2(port.edep, mono.edep) < tight
    for key in ("rays_launched", "rays_terminated"):
        assert port.stats[key] == comp.stats[key] == mono.stats[key]
    assert port.stats["beam_groups"] == 2
    assert port.intensity.shape == (4, 16, 16, 16)


@pytest.mark.parametrize("dtype,backend", [
    ("float64", "scatter"), ("float32", "pallas_hbm_interpret")])
def test_composed_trace_in_the_k5_regime_matches_jax(tmp_path, profiles,
                                                      dtype, backend):
    """The composed trace of a scene with ``nz + 2 > 128`` (where the JAX
    trace deposits through K5, ``make_tile_deposit_hbm``): the port's
    ``run_composed`` against the JAX ``run_composed`` on ``backend`` (the
    exact scatter deposit, or K5 interpreted), counts equal.

    The JAX composed trace adds each chunk's deposits into a float32 grid
    whatever the ray dtype (``raytracer.make_chunk_delta_fn``), so in f64
    it sits at that grid's rounding (bar 1e-6; measured 3.3e-8), and the
    port's f64 trace is held to 1e-12 against the JAX package's exact f64
    trace (scatter, a float64 grid) of the same rays; K5 interpreted has
    bf16 weights (bar 2e-3; measured 5.6e-4)."""
    cfg = Config(**TALL, dtype=dtype)
    assert cfg.nz + 2 > 128
    port = runner.run_composed(cfg, device="cpu", verbose=False)
    jcfg = JConfig(**TALL, dtype=dtype)
    jres = jrunner.run_composed(jcfg, backend=backend,
                                cache_dir=str(tmp_path), verbose=False)
    for key in COUNTS:
        assert port.stats[key] == jres.stats[key], key
    assert port.stats["segments"] >= 3
    if dtype == "float64":
        assert _rel_l2(port.edep, jres.edep) < 1e-6
        np.testing.assert_allclose(port.stats["energy_absorbed"],
                                   jres.stats["energy_absorbed"], rtol=1e-12)
        jctx = jrt.prepare(jcfg, profiles, host_state=True)
        state0 = jrt.select_rays(jctx.state0, jctx.live_slots)
        fn = jax.jit(jrt.make_trace_fn(jcfg, jctx.layout.rays_per_tile,
                                       backend="scatter"))
        exact, _, _ = fn(jnp.asarray(jctx.field4),
                         jax.tree_util.tree_map(jnp.asarray, state0))
        assert _rel_l2(port.edep, np.asarray(exact, np.float64)) < 1e-12
    else:
        assert _rel_l2(port.edep, jres.edep) < 2e-3
        np.testing.assert_allclose(port.stats["energy_absorbed"],
                                   jres.stats["energy_absorbed"], rtol=1e-5)


def _jax_record() -> dict:
    """The JAX package's records as the port's record carries them: the
    converged solve's artifact and the trace's numbers (its balance at the
    port's f64 master's 0: the JAX pairwise f32 master read 2.4e-6)."""
    rec = c4.load_cbet_record()
    rec.update(trace_edep_total=c4.TRACE_EDEP_TOTAL,
               trace_energy_balance=0.0,
               trace_rays_launched=c4.RAYS_LAUNCHED,
               trace_rays_terminated=c4.RAYS_LAUNCHED)
    return rec


def test_hold_config4_passes_the_jax_record():
    held = c4.hold_config4(_jax_record())
    assert all(h["ok"] for h in held), [h for h in held if not h["ok"]]
    assert {h["stage"] for h in held} == {"trace", "cbet"}
    assert len(held) == 3 + 1 + 5 + 3 + 1 + 1
    assert c4.hold_config4({}) == []


def _moved(rec, key, factor=None, value=None, index=None):
    rec = json.loads(json.dumps(rec))
    if index is not None:
        rec[key][index] *= factor
    elif value is not None:
        rec[key] = value
    else:
        rec[key] *= factor
    return rec


MOVES = {
    # quantity: (key, factor | value | index), each just past its bar
    "trace edep_total": dict(key="trace_edep_total", factor=1 + 1.5e-4),
    "trace balance": dict(key="trace_energy_balance", value=-1.5e-6),
    "trace rays launched": dict(key="trace_rays_launched",
                                value=c4.RAYS_LAUNCHED - 1),
    "trace rays terminated": dict(key="trace_rays_terminated",
                                  value=c4.RAYS_LAUNCHED - 900),
    "not converged": dict(key="converged", value=False),
    "6 iterations": dict(key="iterations", value=6),
    "history entry 1": dict(key="history", index=0, factor=1 + 1.5e-2),
    "history entry 4": dict(key="history", index=3, factor=1 - 1.5e-2),
    "history entry 5": dict(key="history", index=4, factor=1 + 6e-2),
    "history too short": dict(key="history", value=[0.337521, 0.139848,
                                                     0.063395, 0.009322]),
    "edep_total": dict(key="edep_total", factor=1 + 1.5e-3),
    "energy_absorbed": dict(key="energy_absorbed", factor=1 - 1.5e-3),
    "intensity_total": dict(key="intensity_total", factor=1 + 1.5e-3),
    "rays launched": dict(key="rays_launched", value=50_289_001),
    "rays terminated": dict(key="rays_terminated", value=50_288_000),
}


@pytest.mark.parametrize("move", sorted(MOVES))
def test_hold_config4_fails_a_record_moved_past_a_bar(move):
    rec = _moved(_jax_record(), **MOVES[move])
    missed = [h["quantity"] for h in c4.hold_config4(rec) if not h["ok"]]
    assert missed, move


def test_hold_config4_balance_bar():
    """The solve's balance is held around the record's +3.80e-3: edep moved
    by 6e-4 relative moves it past its 5e-4 bar while staying within the
    totals' 1e-3."""
    rec = _moved(_jax_record(), key="edep_total", factor=1 + 6e-4)
    missed = [h["quantity"] for h in c4.hold_config4(rec) if not h["ok"]]
    assert missed == ["edep_total / energy_absorbed - 1 (absolute)"]
    ref = c4.load_cbet_record()
    assert ref["edep_total"] / ref["energy_absorbed"] - 1 == \
        pytest.approx(3.80e-3, abs=1e-5)


TINY = ["--device", "cpu", "--nbeams", "4", "--rays-per-zone", "1",
        "--nx", "24", "--ny", "24", "--nz", "24", "--tiles-per-block", "1",
        "--chunk-steps", "8", "--groups", "2", "--cbet-max-iters", "8",
        "--cbet-tol", "1e-3"]


def test_script_record_on_the_cpu(tmp_path, capsys):
    """``scripts/config4.py --device cpu`` on a tiny scene: one JSON record
    with every key of ``artifacts/config4_cbet_r05.json``, the trace's keys
    and the launches, written to ``--out`` too; no bars off config 4; the
    checkpoints written and a resume landing on the converged one."""
    out = tmp_path / "rec.json"
    ck = tmp_path / "ck"
    assert c4.main(TINY + ["--out", str(out), "--checkpoint", str(ck)]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == rec
    assert set(c4.load_cbet_record()) <= set(rec)
    assert set(c4.RECORD_KEYS) == set(c4.load_cbet_record())
    assert rec["converged"] and rec["iterations"] >= 2
    assert rec["beam_groups"] == 2 and rec["device"] == "cpu"
    assert rec["trace_rays_terminated"] == rec["trace_rays_launched"] > 0
    assert rec["rays_launched"] == rec["trace_rays_launched"]
    assert abs(rec["trace_energy_balance"]) < 1e-6
    assert rec["edep_finite"] and rec["intensity_finite"]
    assert len(rec["iter_seconds"]) == rec["iterations"] + 1
    assert rec["launch_checks"] == {} and rec["hbm_peak_gib"] is None
    assert "held" not in rec and rec["device_name"] is None
    assert sorted(os.listdir(ck)) == ["cbet.ckpt.npz", "trace.ckpt.npz"]
    assert c4.main(TINY + ["--stage", "cbet", "--checkpoint", str(ck),
                           "--resume"]) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["resumed"] and again["history"] == rec["history"]
    assert "trace_edep_total" not in again


def test_script_refuses_without_a_card(capsys):
    """Without a card and without ``--device cpu`` the script exits 2 and
    prints no record (as ``cli run`` does)."""
    assert not torch.cuda.is_available()
    assert c4.main(["--stage", "trace"]) == 2
    cap = capsys.readouterr()
    assert cap.out == "" and "--device cpu" in cap.err
    with pytest.raises(SystemExit):
        c4.main(["--device", "cpu", "--resume"])


def test_launch_checks_of_the_path():
    """What the path implies on the card: the trace's K1 once per step, the
    solve's K1 and K2 once per group step, K3 once per gain iteration on
    the pair kernel, no K4; nothing is checked off the card."""
    none = dict.fromkeys(("K1", "K2", "K3", "K3_pairs", "K4", "K4_tri",
                          "K4_gain_only"), 0)
    rec = {"device": "cuda:0", "window_steps": 1,
           "trace_launches": dict(none, K1=475), "trace_steps_executed": 475,
           "cbet_launches": dict(none, K1=9000, K2=9000, K3=5,
                                 K3_pairs=5),
           "trace_steps": [1500] * 6, "iter_seconds": [1.0] * 6,
           "resumed": False}
    assert all(c4.launch_checks(rec).values())
    assert len(c4.launch_checks(rec)) == 5
    bad = dict(rec, cbet_launches=dict(rec["cbet_launches"], K3_pairs=4))
    assert not all(c4.launch_checks(bad).values())
    bad = dict(rec, trace_launches=dict(rec["trace_launches"], K1=95))
    assert not all(c4.launch_checks(bad).values())
    assert c4.launch_checks(dict(rec, device="cpu")) == {}
    # a resume that lands on the converged checkpoint launches nothing
    landed = dict(rec, resumed=True, trace_steps=[], iter_seconds=[],
                  cbet_launches=none)
    assert all(c4.launch_checks(landed).values())


# peaks of cbet_solve_composed above its prepared scene (5 iterations, f32),
# read by scripts/peak_memory.py --config4 --cbet on an NVIDIA H100 80GB
# HBM3, 700.00 W; config 4 in 4 groups the largest of three readings (the
# script read 5,987,215,360 twice, scripts/config4.py 6,021,041,664)
CBET_PEAKS = {("OMEGA", 1): 1857832448, ("OMEGA", 4): 1476468224,
              ("config 4", 1): 19006357504, ("config 4", 4): 6021041664}


@pytest.mark.parametrize("scene,groups", sorted(CBET_PEAKS))
def test_cbet_estimate_is_fitted_to_the_card_peaks(scene, groups):
    """The CBET stage's estimate (``trace=False``, what ``check_memory``
    holds a composed solve to) stays above each peak read on the card and
    within 15 % of it."""
    cfg = Config() if scene == "OMEGA" else c4.CONFIG4
    peak = CBET_PEAKS[scene, groups]
    est = runner.estimate_device_bytes(cfg, True, groups, trace=False)
    assert est == runner.estimate_cbet_bytes(cfg, groups)
    assert peak <= est <= 1.15 * peak


def test_cbet_estimate_arithmetic_at_config4():
    """At ``CONFIG4`` the group's trace is the largest moment: per slot of
    the group ``CBET_SLOT_FLOATS`` floats, ``CBET_SLOT_BYTES`` bytes and the
    lookup's rows of each window step, beside the group's full-resolution
    gain rows (the CBET grid is coarsened, so they are a copy) and what the
    earlier groups left; a run with the trace stage adds the scene."""
    cfg = c4.CONFIG4
    n = runner.traced_slots(cfg)
    P, Ph = 200 ** 3, 100 ** 3
    one, four = (runner.estimate_cbet_bytes(cfg, g) for g in (1, 4))
    margin = runner.CBET_MARGIN
    slot = runner.CBET_SLOT_FLOATS * 4 + runner.CBET_SLOT_BYTES + 2 * 32
    held = 60 * Ph * 12 + 16 * Ph + 4 * n + 202 ** 3 * 8
    grids = 202 ** 3 * 12
    assert one == int(margin * (held + 4 * n + 60 * P * 4 + n * slot
                                + 2 * 60 * 102 ** 3 * 4 + grids))
    assert four == int(margin * (held + 0.75 * (60 * Ph * 4 + n * 5)
                                 + n + 15 * P * 4 + n // 4 * slot
                                 + 2 * 15 * 102 ** 3 * 4 + grids))
    windowed = runner.estimate_cbet_bytes(cfg.replace(deposit_batch_steps=5),
                                          1)
    assert windowed - one == pytest.approx(margin * 4 * 64 * n, rel=1e-9)
    f64 = runner.estimate_cbet_bytes(cfg.replace(dtype="float64"), 1)
    assert f64 > one + margin * n * runner.CBET_SLOT_FLOATS * 4
    scene = n * (11 * 4 + 13) + P * 16
    for g, alone in ((1, one), (4, four)):
        assert runner.estimate_device_bytes(cfg, True, g) == max(
            alone + scene, runner.estimate_trace_bytes(cfg))


def test_trace_estimate_covers_config4_a_deposit_per_step():
    """The trace's estimate at ``CONFIG4`` (a deposit per step: the step's
    rows and those of the step before, 2 x 28 bytes a slot in f32) against
    the peaks read on the card: f32 21,617,626,624 bytes (the on-card
    init's term is the larger there) and f64 37,160,953,344
    (``scripts/peak_memory.py --config4``, ``scripts/config4.py --stage
    trace --dtype float64``)."""
    cfg = c4.CONFIG4
    for dtype, peak in (("float32", 21617626624), ("float64", 37160953344)):
        est = runner.estimate_device_bytes(cfg.replace(dtype=dtype))
        assert peak <= est <= 1.1 * peak, dtype
    n = runner.traced_slots(cfg)
    f64 = cfg.replace(dtype="float64")
    assert runner.estimate_trace_bytes(f64.replace(deposit_batch_steps=5)) \
        - runner.estimate_trace_bytes(f64) == 3 * 44 * n
