"""The port's bench (``python -m cbet_raytracing_3d_tpu_torch.bench``) on the
CPU at a two-beam 24^3 scene: its record (two JSON lines, every key, the
per-device value, the goldens skipped off the card, no kernel launched),
its numbers against the JAX package's ``runner.run`` on the same config
with the bench's CBET switches, the bench on two gloo ranks against one,
and its refusals (no card, NCCL ranks sharing a card, a solver the warm-up did
not seed, a config kernel_cell cannot run), and how ``utils/card`` finds
the card a record names."""

import contextlib
import io
import json
import types

import jax
import numpy as np
import pytest
import torch

from cbet_raytracing_3d_tpu import runner as jrunner
from cbet_raytracing_3d_tpu.config import Config as JConfig
from cbet_raytracing_3d_tpu.parallel import sharding as jsh
from cbet_raytracing_3d_tpu_torch import bench
from cbet_raytracing_3d_tpu_torch.config import Config
from cbet_raytracing_3d_tpu_torch.models import cbet
from cbet_raytracing_3d_tpu_torch.parallel import multihost as mh
from cbet_raytracing_3d_tpu_torch.runner import run
from cbet_raytracing_3d_tpu_torch.utils import card

torch.set_num_threads(1)

# test_torch_cbet.py:39-41: two beams at 24^3, float64, with windows that
# divide every chunk (nt = 96), as kernel_cell needs
SCENE = dict(nbeams=2, rays_per_zone=1, nx=24, ny=24, nz=24,
             dtype="float64", chunk_steps=8, deposit_batch_steps=4)
FLAGS = ["--nbeams", "2", "--rays-per-zone", "1", "--nx", "24", "--ny", "24",
         "--nz", "24", "--dtype", "float64", "--chunk-steps", "8",
         "--deposit-batch-steps", "4", "--device", "cpu"]
ARGV = FLAGS + ["--repeats", "2", "--cbet-repeats", "1"]

TRACE_KEYS = (
    "metric", "value", "unit", "vs_baseline", "vs_baseline_range",
    "value_window", "trace_seconds", "trace_seconds_median", "trace_seconds_samples",
    "compile_seconds", "edep_fetch_seconds", "kernel_build_seconds",
    "backend_init_seconds", "init_seconds", "init_steady_seconds",
    "devices", "devices_available", "backend", "device_name",
    "power_limit_w", "torch_version", "cuda_version", "rays", "nt", "dtype",
    "steps_executed", "tile_widths", "launches", "edep_total",
    "energy_absorbed", "energy_balance", "golden_skipped")
CBET_KEYS = (
    "cbet_warmup_seconds", "cbet_warmup_iter0_seconds",
    "cbet_wallclock_seconds", "cbet_wallclock_samples",
    "cbet_solve_seconds", "cbet_solve_samples", "cbet_result_fetch_seconds",
    "cbet_result_d2h_seconds", "cbet_iter_seconds",
    "cbet_iter_gain_seconds", "cbet_iter_trace_seconds",
    "cbet_iter_update_seconds", "cbet_iter0_seconds", "cbet_trace_steps",
    "cbet_seeded_zero_gain", "cbet_launches", "anchor_after_cbet_seconds",
    "cbet_degraded_window", "cbet_intensity_mode", "cbet_gain_mode",
    "cbet_segmented", "cbet_gain_sharded", "cbet_gain_rows2",
    "cbet_light_iterations", "cbet_relax", "cbet_plan_headroom",
    "cbet_accel", "cbet_iterations", "cbet_converged", "cbet_tol",
    "cbet_history", "cbet_edep_total", "cbet_energy_absorbed",
    "cbet_energy_balance", "cbet_golden_skipped")
RANK_KEYS = ("dist_backend", "rank_tile_widths", "rank_busy_seconds",
             "busy_slowest_over_mean", "rank_steps_executed",
             "collective_seconds", "cbet_collective_seconds")


def _bench(argv) -> list[str]:
    """``bench.main(argv)``'s stdout lines (it returns 0)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert bench.main(argv) == 0
    return buf.getvalue().splitlines()


def _rank(rank, world, argv):
    """The bench on one gloo rank of ``spawn_ranks``' group."""
    torch.set_num_threads(1)
    return _bench(argv)


@pytest.fixture(scope="module")
def lines():
    return _bench(ARGV)


@pytest.fixture(scope="module")
def record(lines):
    return json.loads(lines[-1])


@pytest.fixture(scope="module")
def two_ranks():
    """Each rank's stdout lines: rank 0 prints, rank 1 stays silent."""
    return mh.spawn_ranks(_rank, 2, ARGV, timeout=300)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's ``runner.run`` on one CPU device with the bench's
    CBET switches (its kernel_cell runs on the CPU, tests/test_cbet.py:910),
    compacted by its tile plan (``cache_dir``)."""
    jcfg = JConfig(**SCENE, **bench.CBET_SWITCHES)
    return jrunner.run(jcfg, with_cbet=True, verbose=False,
                       mesh=jsh.make_mesh(jax.devices()[:1]),
                       cache_dir=str(tmp_path_factory.mktemp("jax_cache")))


def test_record_has_two_lines_and_every_key(lines, record):
    """Two JSON lines: the trace record, then the same record with every
    CBET key; the switches the bench sets are the ones that ran."""
    assert len(lines) == 2
    first = json.loads(lines[0])
    missing = [k for k in TRACE_KEYS + CBET_KEYS if k not in record]
    assert not missing, missing
    assert set(first) == set(TRACE_KEYS) | {"nvidia_smi"}
    assert {k: record[k] for k in first} == first
    assert record["metric"] == "ray_steps_per_sec_per_chip"
    assert record["unit"] == "ray-steps/s"
    assert record["backend"] == "cpu" and record["devices"] == 1
    assert record["rays"] == Config(**SCENE).total_rays
    assert record["nt"] == Config(**SCENE).nt
    assert record["dtype"] == "float64"
    assert len(record["trace_seconds_samples"]) == 2
    assert record["trace_seconds"] == min(record["trace_seconds_samples"])
    assert len(record["cbet_wallclock_samples"]) == 1
    assert record["cbet_wallclock_seconds"] == \
        record["cbet_wallclock_samples"][0]
    # the solve wall keeps what the JAX bench's wall leaves out but the
    # copies to the host
    assert record["cbet_solve_seconds"] == record["cbet_solve_samples"][0]
    assert 0 <= record["cbet_result_d2h_seconds"] <= \
        record["cbet_result_fetch_seconds"]
    assert record["cbet_solve_seconds"] >= record["cbet_wallclock_seconds"]
    assert record["cbet_gain_mode"] == "kernel_cell"
    assert record["cbet_segmented"] is True
    assert record["cbet_plan_headroom"] == 0.5
    assert record["cbet_intensity_mode"] == "grouped"
    assert record["cbet_seeded_zero_gain"] is True
    assert record["cbet_converged"] is True
    assert len(record["cbet_history"]) == record["cbet_iterations"]
    assert len(record["cbet_iter_seconds"]) == record["cbet_iterations"]
    assert len(record["cbet_trace_steps"]) == record["cbet_iterations"]
    tw = record["tile_widths"]
    assert len(tw) >= 2 and all(b < a for a, b in zip(tw, tw[1:]))


@pytest.mark.parametrize("which", ["one rank", "two ranks"])
def test_value_is_ray_steps_per_device(record, two_ranks, which):
    """``value = rays x nt / trace_seconds / devices`` (per chip), its
    ratios to the reference's cost model, and the whole window's rate over
    every timed trace."""
    rec = record if which == "one rank" else json.loads(two_ranks[0][-1])
    want = rec["rays"] * rec["nt"] / rec["trace_seconds"] / rec["devices"]
    assert rec["value"] == pytest.approx(want, rel=1e-12)
    samples = rec["trace_seconds_samples"]
    assert rec["value_window"] == pytest.approx(
        rec["rays"] * rec["nt"] * len(samples) / sum(samples)
        / rec["devices"], rel=1e-12)
    assert rec["value_window"] <= rec["value"]
    assert rec["vs_baseline"] == pytest.approx(
        rec["value"] / bench.BASELINE_RAY_STEPS_PER_SEC, rel=1e-12)
    lo, hi = rec["vs_baseline_range"]
    assert lo == pytest.approx(rec["value"] / 5e8, rel=1e-12)
    assert hi == pytest.approx(rec["value"] / 1.2e8, rel=1e-12)


def test_cpu_record_skips_goldens_names_no_card_launches_nothing(record):
    """Off the card the goldens are skipped, no card is named, no kernel
    is built, and every launch counter reads 0: the plain versions ran."""
    assert record["golden_skipped"] == "not on the card"
    assert record["cbet_golden_skipped"] == "not on the card"
    for key in ("golden_rel_l2", "golden_drift", "cbet_golden_rel_l2",
                "cbet_golden_drift"):
        assert key not in record
    assert record["device_name"] is None and record["power_limit_w"] is None
    assert record["kernel_build_seconds"] is None
    assert record["torch_version"] == torch.__version__
    assert record["launches"] == 0
    assert set(record["cbet_launches"].values()) == {0}
    assert set(record["cbet_launches"]) == {"K1", "K2", "K3", "K3_pairs",
                                            "K3_b_out", "K4"}


def test_trace_matches_jax_runner_and_port_runner(record, jax_run,
                                                  tmp_path):
    """The bench's trace against the JAX ``runner.run`` (compacted by its
    tile plan) at rtol 1e-12, and bit for bit against the port's own
    ``runner.run`` with a cache dir, whose setup the bench times."""
    np.testing.assert_allclose(record["edep_total"],
                               jax_run.stats["edep_total"], rtol=1e-12)
    np.testing.assert_allclose(record["energy_absorbed"],
                               jax_run.stats["energy_absorbed"], rtol=1e-12)
    assert abs(record["energy_balance"]) < 1e-12
    port = run(Config(**SCENE), device="cpu", verbose=False,
               cache_dir=str(tmp_path))
    assert record["edep_total"] == port.stats["edep_total"]
    assert record["energy_absorbed"] == port.stats["energy_absorbed"]
    assert record["steps_executed"] == port.stats["steps_executed"]
    assert record["tile_widths"] == port.stats["tile_widths"]


def test_cbet_matches_jax_runner(record, jax_run):
    """The converged solve against the JAX solve with the same switches,
    at test_torch_cbet.py:336-337's tolerances (the port's own f32 gain
    against XLA's fused one): edep total rtol 1e-7, history rtol 1e-6,
    the same iterations; the energy balance from the solve's stats."""
    jc = jax_run.cbet
    assert jc.stats["gain_mode"] == "kernel_cell" and jc.stats["segmented"]
    assert record["cbet_iterations"] == jc.iterations
    np.testing.assert_allclose(record["cbet_edep_total"], float(
        jc.edep.sum()), rtol=1e-7)
    np.testing.assert_allclose(record["cbet_history"], jc.history,
                               rtol=1e-6)
    np.testing.assert_allclose(record["cbet_energy_absorbed"],
                               jc.stats["energy_absorbed"], rtol=1e-7)
    assert record["cbet_energy_balance"] == pytest.approx(
        record["cbet_edep_total"] / record["cbet_energy_absorbed"] - 1,
        rel=1e-12)


def test_two_ranks_match_one(record, two_ranks):
    """The bench on two gloo ranks: rank 0 prints the two lines, rank 1
    nothing; the grid's total equals the one-rank record at 1e-12, the
    solve its iterations and history; the per-rank stats are there, the
    gain table sharded and K3 off (the plain versions on the CPU)."""
    assert len(two_ranks[0]) == 2 and two_ranks[1] == []
    rec = json.loads(two_ranks[0][-1])
    assert rec["devices"] == 2
    missing = [k for k in TRACE_KEYS + CBET_KEYS + RANK_KEYS if k not in rec]
    assert not missing, missing
    assert rec["dist_backend"] == "gloo"
    assert len(rec["rank_tile_widths"]) == 2
    assert len(rec["rank_busy_seconds"]) == 2
    np.testing.assert_allclose(rec["edep_total"], record["edep_total"],
                               rtol=1e-12)
    np.testing.assert_allclose(rec["energy_absorbed"],
                               record["energy_absorbed"], rtol=1e-12)
    assert rec["cbet_intensity_mode"] == "beam_sharded"
    assert rec["cbet_gain_sharded"] is True
    assert rec["cbet_iterations"] == record["cbet_iterations"]
    np.testing.assert_allclose(rec["cbet_history"], record["cbet_history"],
                               rtol=1e-10)
    np.testing.assert_allclose(rec["cbet_edep_total"],
                               record["cbet_edep_total"], rtol=1e-10)


def test_no_card_exits_2_with_the_cli_message(capsys, monkeypatch):
    """Without a card and without ``--device cpu`` the bench stops with
    exit code 2 and ``cli run``'s message, printing no record."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench.main([])
    out = capsys.readouterr()
    assert e.value.code == 2
    assert '--device cpu' in out.err and 'device="cpu"' in out.err
    assert out.out == ""


def test_refuses_nccl_ranks_sharing_a_card_under_torchrun(capsys,
                                                         monkeypatch):
    """Under torchrun the bench joins the group as ``cli run`` does
    (``multihost.join_torchrun_group``, NCCL on a card): two ranks named
    onto one card are refused before the group forms."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(SystemExit) as e:
        bench.main(["--device", "cuda:0"])
    assert e.value.code == 2
    assert "NCCL cannot run 2 ranks" in capsys.readouterr().err


def test_unseeded_solve_is_a_fault(monkeypatch):
    """A measured solve that the warm-up's zero-gain memo did not seed ran
    on a rebuilt solver: the bench raises after the trace line is out."""
    solve = cbet.cbet_solve

    def rebuilt(cfg, ctx, **kw):
        cbet._SOLVER_CACHE.clear()
        return solve(cfg, ctx, **kw)

    monkeypatch.setattr(bench, "cbet_solve", rebuilt)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            pytest.raises(RuntimeError, match="not seeded"):
        bench.main(ARGV)
    out = buf.getvalue().splitlines()
    assert len(out) == 1 and "cbet_wallclock_seconds" not in json.loads(
        out[0])


def test_refuses_a_config_kernel_cell_cannot_run(capsys):
    """kernel_cell's windows must divide the chunks: refused before the
    trace runs, no record printed."""
    argv = list(FLAGS)
    argv[argv.index("--deposit-batch-steps") + 1] = "3"
    with pytest.raises(ValueError, match="kernel_cell"):
        bench.main(argv)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("line, watts", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", 700.0),
    ("NVIDIA H100 80GB HBM3, 450.50 W", 450.5)])
def test_power_limit_parse(line, watts):
    assert card.power_limit_watts(line) == watts


def test_power_limit_parse_refuses_a_line_without_one():
    with pytest.raises(ValueError, match="no power limit"):
        card.power_limit_watts("NVIDIA H100 80GB HBM3, [N/A]")


def test_card_info_on_the_cpu_calls_no_tool(monkeypatch):
    """Off the card nothing runs ``nvidia-smi``; the versions are torch's."""
    def no_smi(*a, **kw):
        raise AssertionError("nvidia-smi called for the CPU")

    monkeypatch.setattr(card.subprocess, "run", no_smi)
    info = card.card_info("cpu")
    assert info["device_name"] is None and info["nvidia_smi"] is None
    assert info["torch_version"] == torch.__version__
    assert info["cuda_version"] == torch.version.cuda
    assert info["devices_available"] == 1


def test_card_info_raises_when_nvidia_smi_fails(monkeypatch):
    """On a CUDA device a failing ``nvidia-smi`` is an error: a record
    without the card's name is not the card's number."""
    class Failed:
        returncode, stdout, stderr = 9, "", "NVIDIA-SMI has failed"

    monkeypatch.setattr(card.subprocess, "run", lambda *a, **kw: Failed())
    with pytest.raises(RuntimeError, match="nvidia-smi failed"):
        card.nvidia_smi_line(0)


# four cards in nvidia-smi's PCI order, with different limits
SMI_CARDS = (
    "00000000:18:00.0, GPU-00000000-0000-0000-0000-000000000018, "
    "NVIDIA H100 80GB HBM3, 700.00 W\n"
    "00000000:2A:00.0, GPU-00000000-0000-0000-0000-00000000002a, "
    "NVIDIA H100 80GB HBM3, 650.00 W\n"
    "00000000:3B:00.0, GPU-00000000-0000-0000-0000-00000000003b, "
    "NVIDIA H100 80GB HBM3, 500.00 W\n"
    "00000001:5D:00.0, GPU-00000000-0000-0000-0000-00000000005d, "
    "NVIDIA H100 80GB HBM3, 450.00 W\n")
# the same cards with their PCI addresses hidden, as some hosts show them
SMI_NO_PCI = SMI_CARDS.replace("00000000:18:00.0", "[N/A]").replace(
    "00000000:2A:00.0", "[N/A]").replace("00000000:3B:00.0", "[N/A]").replace(
    "00000001:5D:00.0", "[N/A]")
# one card whose host shows neither
SMI_HIDDEN = "[N/A], GPU-REDACTED, NVIDIA H100 80GB HBM3, 700.00 W\n"


def _fake_card(monkeypatch, smi_out, pci, uuid):
    """nvidia-smi prints ``smi_out``; torch's device sits at ``pci`` with
    ``uuid``.  Returns the commands run."""
    class Listed:
        returncode, stdout, stderr = 0, smi_out, ""

    calls = []

    def smi(cmd, **kw):
        calls.append(cmd)
        return Listed()

    domain, bus, dev = pci
    monkeypatch.setattr(card.subprocess, "run", smi)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(
                            pci_domain_id=domain, pci_bus_id=bus,
                            pci_device_id=dev, uuid=uuid))
    return calls


@pytest.mark.parametrize("smi_out, pci, uuid, line", [
    (SMI_CARDS, (0, 0x3B, 0), "ffffffff-0000-0000-0000-000000000000",
     "NVIDIA H100 80GB HBM3, 500.00 W"),
    (SMI_CARDS, (1, 0x5D, 0), "ffffffff-0000-0000-0000-000000000000",
     "NVIDIA H100 80GB HBM3, 450.00 W"),
    (SMI_NO_PCI, (0, 0x2A, 0), "00000000-0000-0000-0000-00000000002a",
     "NVIDIA H100 80GB HBM3, 650.00 W"),
    (SMI_HIDDEN, (0, 0xCB, 0), "e4d2b9c7-aa37-9353-319b-4c1b81d88fec",
     "NVIDIA H100 80GB HBM3, 700.00 W")],
    ids=["pci-3rd", "pci-other-domain", "uuid", "lone-hidden-card"])
def test_nvidia_smi_line_finds_the_card_by_pci_address_or_uuid(
        monkeypatch, smi_out, pci, uuid, line):
    """The line is the card's at the torch device's PCI address or with its
    UUID, whatever its place in nvidia-smi's order (a CUDA ordinal follows
    the visible set, nvidia-smi's does not); a lone card that hides both
    is the only one it can be."""
    calls = _fake_card(monkeypatch, smi_out, pci, uuid)
    assert card.nvidia_smi_line(0) == line
    assert "--query-gpu=pci.bus_id,uuid,name,power.limit" in calls[0]
    assert not any(a.startswith("--id") for a in calls[0])


@pytest.mark.parametrize("smi_out", [
    SMI_CARDS, SMI_NO_PCI, SMI_HIDDEN * 2,
    "[N/A], GPU-00000000-0000-0000-0000-000000000018, NVIDIA H100 80GB "
    "HBM3, 700.00 W\n"], ids=["pci", "uuid", "two-hidden", "lone-other"])
def test_nvidia_smi_line_raises_for_a_card_it_cannot_tell(monkeypatch,
                                                          smi_out):
    """No card at the device's address or with its UUID, and not one lone
    card that hides both: which card the record names cannot be told."""
    _fake_card(monkeypatch, smi_out, (0, 0x9A, 0),
               "99999999-0000-0000-0000-000000000000")
    with pytest.raises(RuntimeError, match="no card at PCI address "
                                           "00000000:9a:00"):
        card.nvidia_smi_line(2)
