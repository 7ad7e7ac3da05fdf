"""The ring across processes: ``ring_attention(..., group=)`` and
``forward_ring(..., group=)`` on real gloo ranks on the CPU
(tests/torch_ring_worker.py), one ring position per process, at 2 and 4
ranks, against the JAX ring on a slice of the 8-device CPU mesh and against
the port's one-process ring; and, in this process, the order in which
``ring_attention_local`` posts, steps and waits.

The module's fixture writes the inputs to an npz, starts both groups'
workers, computes the JAX references while they run (every case of
tests/test_ring.py on a P-device mesh; ``forward_ring`` at 2 layers on a
4-device mesh, FP32, BF16 and INT8), and reads each rank's outputs back;
each (world size, case) is a test of its own.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from lightglue_tpu import quant as jax_quant
from lightglue_tpu.config import LightGlueConfig as JLGC
from lightglue_tpu.models import lightglue as jax_lg
from lightglue_tpu.parallel import ring as jax_ring
from lightglue_tpu.precision import Precision as JPrecision
from lightglue_tpu.precision import policy_for as jax_policy_for
from lightglue_tpu.runtime import weights as jax_weights
from lightglue_tpu_torch.kernels import attention
from lightglue_tpu_torch.parallel import ring

WORLD_SIZES = (2, 4)
WORKER = Path(__file__).parent / "torch_ring_worker.py"
TIMEOUT_S = 150  # each group's own wait; the ranks' collectives time out at 60 s
N_LAYERS, N = 2, 256
BAD_Q, BAD_N = 101, 255  # a stripe split and a keypoint count no ring of 2 or 4 divides
MODEL_INPUTS = ("k0", "k1", "d0", "d1", "lens0", "lens1")

# every case of tests/test_ring.py: (B, H, N_q, N_kv, GLOBAL lengths or None,
# operand dtype); the ring size is the world size
RING_CASES = {
    "fp32": (2, 4, 256, 256, None, "fp32"),
    "cross shaped": (1, 4, 128, 512, None, "fp32"),
    "masked lengths": (2, 2, 256, 256, [[200, 173], [256, 41]], "fp32"),
    "fully masked shard": (1, 2, 256, 256, [[256, 32]], "fp32"),
    "bf16 inputs": (1, 4, 256, 256, None, "bf16"),
    "smaller ring": (1, 2, 128, 128, [[100, 77]], "fp32"),
    "zero-length kv": (2, 2, 64, 64, [[64, 0], [40, 32]], "fp32"),
}
# against JAX, tests/test_torch_ring.py's bars: fp32 to 1e-5; a bf16
# output of the same fp32-stat merge to an ulp (2e-2). Against the port's
# one-process ring: bit for bit (the same step on the same stripes in the
# same order; the transfers are exact copies)
RING_TOL = {"fp32": 1e-5, "bf16": 2e-2}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), (jax_ring.AXIS_SEQ,))


def _key(case):
    return "ring" + str(list(RING_CASES).index(case))


def _inputs():
    rng = np.random.default_rng(888)
    arrays = {"n_layers": np.asarray(N_LAYERS), "bad_n": np.asarray(BAD_N)}
    for case, (b, h, nq, nk, lens, dt) in RING_CASES.items():
        key = _key(case)
        for name, n in (("q", nq), ("k", nk), ("v", nk)):
            arrays[f"{key}_{name}"] = rng.standard_normal((b, h, n, 64), dtype=np.float32)
        arrays[key + "_dtype"] = np.asarray(dt)
        if lens is not None:
            arrays[key + "_lengths"] = np.asarray(lens, np.int32)
    arrays["k0"], arrays["k1"] = (rng.uniform(-1, 1, (2, N, 2)).astype(np.float32)
                                  for _ in range(2))
    arrays["d0"], arrays["d1"] = (rng.standard_normal((2, N, 256), dtype=np.float32)
                                  for _ in range(2))
    arrays["lens0"] = np.asarray([N, 200], np.int32)
    arrays["lens1"] = np.asarray([173, N], np.int32)
    arrays["bad_q"] = rng.standard_normal((1, 1, BAD_Q, 64), dtype=np.float32)
    arrays["bad_kv"] = rng.standard_normal((1, 1, 256, 64), dtype=np.float32)
    return arrays


def _jax_ring(arrays, size, case):
    *_, lens, dt = RING_CASES[case]
    key = _key(case)
    out = jax_ring.ring_attention(*(jnp.asarray(arrays[f"{key}_{x}"], JDT[dt]) for x in "qkv"),
                                  None if lens is None else jnp.asarray(lens, jnp.int32),
                                  mesh=_mesh(size))
    return np.asarray(out, np.float32)


def _jax_forward_ring(arrays, precision):
    tree = jax_weights.init_lightglue(0, JLGC(n_layers=N_LAYERS))
    policy = jax_policy_for(JPrecision(precision))
    if policy.int8_weights:
        jtree = jax_weights.to_jax(jax_quant.quantize_lightglue(tree))
    else:
        jtree = jax_weights.to_jax(tree, policy.param_dtype)
    out = jax_lg.forward_ring(jtree, *(jnp.asarray(arrays[x]) for x in MODEL_INPUTS),
                              config=JLGC(n_layers=N_LAYERS), policy=policy, mesh=_mesh(4))
    return {name: np.asarray(getattr(out, name), np.float32)
            for name in ("desc0", "desc1", "scores")}


def _jax_references(arrays):
    """{(world size, case): ring output, precision: forward_ring outputs},
    traced and run four at a time (each call compiles its own program)."""
    for size in WORLD_SIZES:
        with pytest.raises(ValueError, match="divide"):  # the JAX ring refuses it too
            jax_ring.ring_attention(jnp.asarray(arrays["bad_q"]),
                                    *(jnp.asarray(arrays["bad_kv"]),) * 2, mesh=_mesh(size))
    with ThreadPoolExecutor(4) as pool:
        jobs = {p: pool.submit(_jax_forward_ring, arrays, p) for p in ("fp32", "bf16", "int8")}
        jobs.update({(size, case): pool.submit(_jax_ring, arrays, size, case)
                     for size in WORLD_SIZES for case in RING_CASES})
        return {key: job.result() for key, job in jobs.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world size: [each rank's outputs]} and the JAX references."""
    root = tmp_path_factory.mktemp("ring_processes")
    np.savez(root / "inputs.npz", **_inputs())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    groups = {}
    for size in WORLD_SIZES:
        workdir = root / f"world{size}"
        workdir.mkdir()
        os.link(root / "inputs.npz", workdir / "inputs.npz")
        port = str(_free_port())
        groups[size] = [subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(size), port, str(workdir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(size)]
    try:
        refs = _jax_references(dict(np.load(root / "inputs.npz")))
        outs = {}
        for size, procs in groups.items():
            texts = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
            for r, (p, text) in enumerate(zip(procs, texts)):
                assert p.returncode == 0 and f"RING WORKER{r} OK" in text, (
                    f"world {size}, rank {r} failed:\n{text}")
            outs[size] = [dict(np.load(root / f"world{size}" / f"rank{r}.npz"))
                          for r in range(size)]
    except subprocess.TimeoutExpired:
        pytest.fail("ring workers did not finish: a rank is waiting for a block")
    finally:
        for procs in groups.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    return outs, refs


@pytest.mark.parametrize("case", list(RING_CASES))
@pytest.mark.parametrize("size", WORLD_SIZES)
def test_ring_attention_across_processes(runs, size, case):
    outs, refs = runs
    *_, lens, dt = RING_CASES[case]
    key = _key(case)
    for rank, out in enumerate(outs[size]):
        np.testing.assert_array_equal(out[key + "_got"], out[key + "_one"],
                                      err_msg=f"rank {rank}: not the one-process ring's rows")
    got = np.concatenate([out[key + "_got"] for out in outs[size]], axis=2)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, refs[size, case], atol=RING_TOL[dt], rtol=0)
    if lens is not None:  # padded Q rows, and every row of an empty kv side, are exactly 0
        for i, (ql, kl) in enumerate(lens):
            assert not got[i, :, ql:].any()
            if kl == 0:
                assert not got[i].any()


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("size", WORLD_SIZES)
def test_forward_ring_across_processes(runs, size, precision):
    outs, refs = runs
    want = refs[precision]
    first = outs[size][0]
    for rank, out in enumerate(outs[size]):
        # the whole output on every rank, as a JAX global array reads, and
        # the same bits everywhere (the assignment runs on gathered rows)
        for name in ("desc0", "desc1", "scores"):
            assert out[f"{precision}_{name}"].shape == want[name].shape
            np.testing.assert_array_equal(out[f"{precision}_{name}"], first[f"{precision}_{name}"],
                                          err_msg=f"rank {rank} {name}")
        # 2 layers x 4 attentions x (P - 1) transfers, each posted once
        assert int(out[f"{precision}_posts"]) == N_LAYERS * 4 * (size - 1)
    s_got, s_want = first[f"{precision}_scores"], want["scores"]
    valid = s_got > -1e29
    assert np.array_equal(valid, s_want > -1e29)
    if precision == "fp32":
        # the JAX package's own bars (tests/test_ring.py:136-145)
        assert str(first["fp32_desc_dtype"]) == "torch.float32"
        np.testing.assert_allclose(s_got, s_want, atol=5e-4, rtol=0)
        for name in ("desc0", "desc1"):
            np.testing.assert_allclose(first[f"fp32_{name}"], want[name], atol=5e-5, rtol=0)
    else:
        # tests/test_torch_ring.py's gates: the 2-layer bf16 envelope of
        # golden/bf16_layer_err_r05.txt (2 x 0.0563) on the descriptors, the
        # JAX package's 0.15 bf16 bar on the scores
        assert str(first[f"{precision}_desc_dtype"]) == "torch.bfloat16"
        for name in ("desc0", "desc1"):
            np.testing.assert_allclose(first[f"{precision}_{name}"], want[name],
                                       atol=2 * 0.0563, rtol=0)
        assert np.abs(s_got - s_want)[valid].max() < 0.15


@pytest.mark.parametrize("call", ["bad_ring", "bad_forward"])
@pytest.mark.parametrize("size", WORLD_SIZES)
def test_bad_length_raises_on_every_rank(runs, size, call):
    """Stripes of 101 tokens (``ring_attention``) or 255 keypoints
    (``forward_ring``) do not divide the ring: every rank raises JAX's
    message before any transfer is posted, and the group goes on."""
    outs, _ = runs
    n = BAD_Q if call == "bad_ring" else BAD_N
    for rank, out in enumerate(outs[size]):
        assert str(out[call]).startswith(f"sequence dims {n}/"), (rank, str(out[call]))
        assert f"must divide the ring size {size}" in str(out[call])


# ---------------------------------------------------------------------------
# the order of post, step and wait, in one process
# ---------------------------------------------------------------------------


class _RecordingTransport(ring._DoubleBuffered):
    """The process transports' slot rule over no process: the block of origin
    ``src - 1`` arrives in a fresh copy of its slot's tensors. It records
    every post and wait, and which slots are being received into."""

    def __init__(self, blocks, events, idx):
        super().__init__(ring=None)
        self.blocks, self.events, self.idx = blocks, events, idx
        self.slots = [tuple(torch.empty_like(t) for t in blocks[0]) for _ in range(2)]
        self.receiving = set()

    def _start(self, k, v, s, slot):
        assert slot not in self.receiving
        self.receiving.add(slot)
        self.events.append(("post", s, slot))
        return s

    def _finish(self, slot, s):
        self.events.append(("wait", s, slot))
        self.receiving.remove(slot)
        src = (self.idx - s - 1) % len(self.blocks)
        for dst, t in zip(self.slots[slot], self.blocks[src]):
            dst.copy_(t)
        return self.slots[slot]


@pytest.mark.parametrize("ring_size", [2, 4])
def test_transfer_posted_before_each_step_and_waited_after(rng, ring_size):
    """Position 1: the transfer for step s+1 is posted before step s runs and
    waited for only after it; no step reads a slot that is being received
    into; the steps see the blocks in ring order."""
    n = 16
    q, k, v = (torch.from_numpy(x) for x in (rng.standard_normal((1, 1, n * ring_size, 64),
                                                                  dtype=np.float32)
                                              for _ in range(3)))
    blocks = list(zip(k.chunk(ring_size, dim=2), v.chunk(ring_size, dim=2)))
    events = []
    transport = _RecordingTransport(blocks, events, idx=1)

    def step(q_, k_, v_, m, l, acc, lengths, row0, col0, *, scale):
        reading = [i for i, (sk, _) in enumerate(transport.slots) if sk.data_ptr() == k_.data_ptr()]
        assert not set(reading) & transport.receiving, (reading, transport.receiving)
        events.append(("step", col0 // n, tuple(reading)))
        assert torch.equal(k_, blocks[col0 // n][0]) and torch.equal(v_, blocks[col0 // n][1])
        return attention.flash_attention_step_plain(q_, k_, v_, m, l, acc, lengths, row0, col0,
                                                    scale=scale)

    got = ring.ring_attention_local(q.chunk(ring_size, dim=2)[1], *blocks[1], None, idx=1,
                                    ring=ring_size, transport=transport, step=step)
    want = []
    for s in range(ring_size):
        src = (1 - s) % ring_size
        if s + 1 < ring_size:
            want.append(("post", s, s % 2))
        want.append(("step", src, () if s == 0 else ((s - 1) % 2,)))
        if s + 1 < ring_size:
            want.append(("wait", s, s % 2))
    assert events == want
    one = ring.ring_attention(q, k, v, devices=["cpu"] * ring_size,
                              step=attention.flash_attention_step_plain)
    assert torch.equal(got, one.chunk(ring_size, dim=2)[1])
