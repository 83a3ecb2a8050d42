"""Multi-host smoke of the port: two OS processes, one CPU device each,
joined over ``tcp://127.0.0.1:<free port>`` with gloo; the counterpart of
``tests/test_multihost.py``.

Runs ``cbet_raytracing_3d_tpu_torch/scripts/smoke_multihost.py`` twice;
each process traces its share of a tiny scene through
``parallel.multihost.run_sharded_multihost`` and checks the summed grid
against its own single-process trace to float64 rounding."""

import os
import socket
import subprocess
import sys

import pytest
import torch

from cbet_raytracing_3d_tpu_torch.parallel import multihost as mh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_multihost_trace():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "cbet_raytracing_3d_tpu_torch.scripts.smoke_multihost", str(i), "2",
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=REPO) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"MULTIHOST OK proc={i}/2 devices=2" in out, out[-3000:]
    # both processes hold the same summed grid
    tot = [line.split("edep_total=")[1].split()[0]
           for out in outs for line in out.splitlines()
           if "MULTIHOST OK" in line]
    assert len(tot) == 2 and tot[0] == tot[1], tot


def test_initialize_refuses_bad_arguments():
    with pytest.raises(ValueError, match="backend"):
        mh.initialize_multihost("127.0.0.1:1", 2, 0, backend="mpi")
    with pytest.raises(ValueError, match="num_processes"):
        mh.initialize_multihost("127.0.0.1:1", backend="gloo")
