"""Worker process for test_torch_ring_processes.py: one rank of a real gloo
``torch.distributed`` group on the CPU, one ring position per process.

Reads the inputs the test wrote (``<dir>/inputs.npz``) and writes this
rank's outputs to ``<dir>/rank<r>.npz``; imports only torch and the port.
For every ring case it runs ``ring_attention(..., group=)`` on its own
stripe of q and block of k / v and, beside it, the one-process ring
(``devices=["cpu"] * P``) over the whole tensors, whose rows of this stripe
the test holds it to bit for bit. Then ``forward_ring(..., group=)`` at 2
layers on FP32, BF16 and INT8 weights, with the transport's posts counted,
and the two bad calls (stripes of unequal length; a keypoint count that does
not divide the ring), each of which must raise here as on every rank.

Invoked as:  python torch_ring_worker.py <rank> <num_processes> <port> <dir>
Prints "RING WORKER<rank> OK" on success; any failure sets the exit code.
"""

import datetime
import os
import sys

rank, nproc, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch
import torch.distributed as dist

from lightglue_tpu_torch import quant
from lightglue_tpu_torch.config import LightGlueConfig
from lightglue_tpu_torch.kernels import attention
from lightglue_tpu_torch.models import lightglue
from lightglue_tpu_torch.parallel import multihost, ring
from lightglue_tpu_torch.precision import Precision, policy_for
from lightglue_tpu_torch.runtime import weights

torch.set_num_threads(1)
multihost.initialize(f"127.0.0.1:{port}", nproc, rank, backend="gloo",
                     timeout=datetime.timedelta(seconds=60))
group = dist.group.WORLD
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}

inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
out = {}


def stripe(t, i=rank):
    return t.chunk(nproc, dim=2)[i]


def raised(call) -> str:
    """The message of the ValueError ``call`` raises, or '' if it returns."""
    try:
        call()
    except ValueError as e:
        return str(e)
    return ""


for case in [k[:-2] for k in inputs if k.startswith("ring") and k.endswith("_q")]:
    dt = DTYPES[str(inputs[case + "_dtype"])]
    q, k, v = (torch.from_numpy(inputs[f"{case}_{x}"]).to(dt) for x in "qkv")
    lengths = torch.from_numpy(inputs[case + "_lengths"]) if case + "_lengths" in inputs else None
    got = ring.ring_attention(stripe(q), stripe(k), stripe(v), lengths, group=group)
    one = ring.ring_attention(q, k, v, lengths, devices=["cpu"] * nproc,
                              step=attention.flash_attention_step_plain)
    assert got.dtype == dt and got.shape == stripe(q).shape, (case, got.dtype, got.shape)
    out[case + "_got"] = got.float().numpy()
    out[case + "_one"] = stripe(one).float().numpy()

model_in = [torch.from_numpy(inputs[x]) for x in ("k0", "k1", "d0", "d1", "lens0", "lens1")]
config = LightGlueConfig(n_layers=int(inputs["n_layers"]))
tree = weights.init_lightglue(0, config)
for precision in ("fp32", "bf16", "int8"):
    policy = policy_for(Precision(precision))
    if policy.int8_weights:  # quantized and not cast, as the session does on the INT8 rung
        params = weights.params_from_numpy(quant.quantize_lightglue(tree))
    else:
        params = weights.params_from_numpy(tree, "cpu", policy.param_dtype)
    ring.transport_time["posts"] = 0
    res = lightglue.forward_ring(params, *model_in, config=config, policy=policy, group=group)
    out[f"{precision}_posts"] = np.asarray(ring.transport_time["posts"])
    out[f"{precision}_desc_dtype"] = np.asarray(str(res.desc0.dtype))
    for name in ("desc0", "desc1", "scores"):
        out[f"{precision}_{name}"] = getattr(res, name).float().numpy()

# the bad calls: every rank must raise, none may wait for a block
q = torch.from_numpy(inputs["bad_q"])
kv = torch.from_numpy(inputs["bad_kv"])
out["bad_ring"] = np.asarray(raised(
    lambda: ring.ring_attention(q.chunk(nproc, dim=2)[rank], stripe(kv), stripe(kv), group=group)))
cut = [t[:, :int(inputs["bad_n"])] for t in model_in[:4]]
out["bad_forward"] = np.asarray(raised(
    lambda: lightglue.forward_ring(params, *cut, config=config, policy=policy, group=group)))

np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
dist.barrier()
dist.destroy_process_group()
print(f"RING WORKER{rank} OK", flush=True)
