"""Worker process for test_torch_multiprocess.py: one rank of a real
two-process ``torch.distributed`` run (gloo) of the port on the CPU.

Each rank owns one CPU mesh entry. The worker:

1. initializes the process group (multihost.initialize, gloo),
2. runs the barrier and checks it counts both ranks' devices,
3. feeds its local row of a deterministic global batch through
   ``global_batch_from_local`` and the data-parallel match step
   (data=2, model=1), and checks its shard against a single-process
   forward of the whole batch,
4. runs the match step at data=1, model=2: tensor parallelism ACROSS the
   two processes (each holds two of the four heads; the partial sums and
   LayerNorm statistics are all-reduced between them),
5. drains a sharded ContinuousBatcher in lockstep and checks its rows
   against a single-device batcher on the same stream.

Invoked as:  python torch_multiprocess_worker.py <rank> <num_processes> <port>
Prints "WORKER<rank> OK" on success; any failure sets the exit code.
"""

import os
import sys

rank, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from lightglue_tpu_torch.config import LightGlueConfig, PipelineConfig
from lightglue_tpu_torch.models import lightglue
from lightglue_tpu_torch.parallel import mesh as mesh_lib
from lightglue_tpu_torch.parallel import multihost
from lightglue_tpu_torch.parallel.batcher import ContinuousBatcher, mesh_match_fn, session_match_fn
from lightglue_tpu_torch.precision import Precision, policy_for
from lightglue_tpu_torch.runtime.session import MatcherSession

torch.set_num_threads(1)
multihost.initialize(f"127.0.0.1:{port}", nproc, rank, backend="gloo")
assert multihost.is_multiprocess() and multihost.process_rank() == rank

cpu = torch.device("cpu")
mesh = mesh_lib.make_mesh(data=2, model=1, devices=[cpu])
assert mesh.ranks == [[0], [1]], mesh

# 1. fail-fast barrier: one per device, all-reduced over both processes
count = multihost.barrier(mesh)
assert count == nproc, f"barrier counted {count} devices"

# 2. deterministic global batch; this rank feeds its own row
N, B = 128, 2
config = PipelineConfig(lightglue=LightGlueConfig(n_layers=2), precision=Precision.FP32,
                        buckets=(N,), match_threshold=0.0, max_matches=N)
session = MatcherSession(config=config, seed=0, device="cpu")
params = session.lg_params
rng = np.random.default_rng(42)  # every rank regenerates the same batch
batch = [rng.uniform(-1, 1, (B, N, 2)).astype(np.float32),
         rng.uniform(-1, 1, (B, N, 2)).astype(np.float32),
         rng.standard_normal((B, N, 256)).astype(np.float32),
         rng.standard_normal((B, N, 256)).astype(np.float32),
         np.asarray([N - 5, N], np.int32), np.asarray([N - 9, N - 30], np.int32)]
ref = lightglue.forward(params, *map(torch.from_numpy, batch), config=config.lightglue,
                        policy=policy_for(config.precision))

local = multihost.global_batch_from_local([a[rank:rank + 1] for a in batch], mesh)
assert local[0].shape == (B, N, 2) and [s.start for s in local[0].shards] == [rank]
out, matches = mesh_lib.make_parallel_match_fn(mesh, config, N, N)(
    mesh_lib.shard_lightglue_params(params, mesh), *local)
assert [s.start for s in out.scores.shards] == [rank] and out.scores.shape == (B, N, N)
for shard in out.scores.shards:
    np.testing.assert_allclose(shard.data.numpy(), ref.scores[shard.start:shard.start + 1],
                               atol=1e-4, rtol=1e-4)

# 3. tensor parallelism across the two processes: each holds half the heads
tp_mesh = mesh_lib.make_mesh(data=1, model=2, devices=[cpu])
assert tp_mesh.model_group(0) is not None
tp_params = mesh_lib.shard_lightglue_params(params, tp_mesh)
assert mesh_lib.lightglue.local_heads(tp_params.shards[(0, rank)], 64) == 2
out_tp, _ = mesh_lib.make_parallel_match_fn(tp_mesh, config, N, N)(
    tp_params, *map(torch.from_numpy, batch))  # every rank holds the whole (one-row) batch
(shard,) = out_tp.scores.shards
assert shard.start == 0 and shard.data.shape == (B, N, N)
np.testing.assert_allclose(shard.data.numpy(), ref.scores.numpy(), atol=1e-4, rtol=1e-4)
np.testing.assert_allclose(out_tp.desc0.shards[0].data.numpy(), ref.desc0.numpy(), atol=1e-4)

# 4. lockstep batcher: both ranks submit the same stream, each keeps its rows
stream = []
for n0, n1 in ((100, 120), (128, 90), (70, 40), (128, 128), (10, 60)):
    stream.append((rng.uniform(-1, 1, (n0, 2)).astype(np.float32),
                   rng.uniform(-1, 1, (n1, 2)).astype(np.float32),
                   rng.standard_normal((n0, 256)).astype(np.float32),
                   rng.standard_normal((n1, 256)).astype(np.float32)))
sharded = ContinuousBatcher(mesh_match_fn(mesh, config),
                            mesh_lib.shard_lightglue_params(params, mesh), buckets=(N,),
                            batch_size=B, sharding=mesh)
single = ContinuousBatcher(session_match_fn(session), params, buckets=(N,), batch_size=B,
                           device="cpu")
for batcher in (sharded, single):
    for pid, pair in enumerate(stream):
        batcher.submit(pid, *pair)
mine = {r.pair_id: r for r in sharded.flush()}
want = {r.pair_id: r for r in single.flush()}
# pair k is row k % 2 of its dispatch: this rank's rows; the padded last
# batch's ballast row is dropped
assert sorted(mine) == [k for k in range(len(stream)) if k % 2 == rank], sorted(mine)
for pid, r in mine.items():
    assert np.array_equal(r.indices, want[pid].indices), pid
    np.testing.assert_allclose(r.scores, want[pid].scores, atol=1e-5, rtol=1e-5)

print(f"WORKER{rank} OK barrier={count} pairs={len(mine)}", flush=True)
