"""The port's multi-process path on real processes: two ranks of a gloo
``torch.distributed`` group on the CPU (tests/torch_multiprocess_worker.py)
run ``multihost.initialize``, the barrier, ``global_batch_from_local``, the
data-parallel match step (data=2, model=1), tensor parallelism across the
two processes (data=1, model=2), and a sharded ContinuousBatcher in
lockstep, each rank's rows against a single-process reference."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

NPROC = 2
WORKER = Path(__file__).parent / "torch_multiprocess_worker.py"
TIMEOUT_S = 180  # each rank's own wait


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_mesh():
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, str(WORKER), str(i), str(NPROC), str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for i in range(NPROC)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail("gloo workers timed out:\n" + "\n".join(outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"WORKER{i} OK barrier={NPROC}" in out, f"worker {i} output:\n{out}"
