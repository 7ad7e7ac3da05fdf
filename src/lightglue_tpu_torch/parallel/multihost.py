"""Multi-process runtime on ``torch.distributed``: process init, batches held
in shards, the fail-fast barrier.

Counterpart of ``lightglue_tpu/parallel/multihost.py``. The pieces:

- ``initialize``: ``dist.init_process_group`` with the backend named by the
  caller (``nccl`` between cards, ``gloo`` on the CPU or for several ranks on
  one card, which NCCL refuses); a no-op at ``num_processes <= 1`` (JAX
  :41-42). Without a coordinator address the group reads its rendezvous from
  the environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
- ``ShardedArray``: a batch-major array of which this process holds some
  rows, each block of rows (``Shard``) on the device of the mesh entry that
  owns it, with the global shape: the port's analog of a ``jax.Array``'s
  addressable shards. ``global_batch_from_local`` builds one from each
  process's local rows; the mesh steps take them as inputs and, across
  processes, return their outputs so.
- ``barrier``: an all-reduce of one per mesh device over every process: it
  counts the fleet, and a dead process turns into a collective timeout on
  every other one, so the job fails as a whole instead of hanging in part.

In one process none of this is needed (``parallel/mesh.py`` alone runs a
mesh); these helpers then work on the one process's rows, so the same
program text serves both.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: str,
    timeout: Optional[datetime.timedelta] = None,
) -> None:
    """Bring up the default process group (no-op when single-process).

    Args:
      coordinator_address: ``host:port`` (or a ``tcp://`` URL) of rank 0's
        rendezvous; None reads it from the environment (``env://``).
      num_processes/process_id: world size and this process's rank.
      backend: ``"nccl"`` or ``"gloo"``; nothing is chosen for the caller.
      timeout: how long a collective or a ring transfer may wait for the
        other ranks before it raises (``init_process_group``'s own default,
        30 minutes on gloo, when None), so a rank that died fails the rest.
    """
    if num_processes is not None and num_processes <= 1:
        return
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {} if timeout is None else {"timeout": timeout}
    if num_processes is not None:
        kwargs.update(world_size=num_processes, rank=process_id)
    dist.init_process_group(backend, init_method=init_method, **kwargs)


def is_multiprocess() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def process_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Shard(NamedTuple):
    start: int          # global index of the first row
    data: torch.Tensor  # the rows, on the device of the mesh entry that owns them


@dataclass
class ShardedArray:
    """Rows of a global batch-major array held by this process."""

    shape: Tuple[int, ...]  # the global shape
    shards: List[Shard]     # this process's blocks of rows, by start

    def rows(self) -> dict:
        """{global row -> host row} of this process's shards (JAX
        ``batcher.py:_addressable_rows``)."""
        out = {}
        for shard in self.shards:
            data = shard.data.cpu().numpy()
            for k in range(data.shape[0]):
                out[shard.start + k] = data[k]
        return out


def global_batch_from_local(local_arrays: Sequence, mesh) -> List[ShardedArray]:
    """Per-process local rows -> ``ShardedArray``s of the global batch.

    Each process passes the rows of the batch its mesh entries own: the
    data-axis rows of ``mesh`` it holds an entry of, in order, each the same
    number of pairs. Each block of rows goes to the device of the first
    entry this process owns in its data row; the global shape counts every
    data row of the mesh. In one process that is the whole batch, split.
    """
    rows = [i for i, _ in mesh.local_rows()]
    out = []
    for arr in local_arrays:
        t = torch.from_numpy(np.ascontiguousarray(arr)) if isinstance(arr, np.ndarray) else arr
        if t.shape[0] % len(rows):
            raise ValueError(f"{t.shape[0]} local rows over {len(rows)} data rows of the mesh")
        per = t.shape[0] // len(rows)
        shards = [Shard(i * per, t[k * per:(k + 1) * per].to(mesh.row_device(i)))
                  for k, i in enumerate(rows)]
        out.append(ShardedArray((per * mesh.shape["data"],) + tuple(t.shape[1:]), shards))
    return out


def barrier(mesh) -> int:
    """All-device liveness check; returns the participating device count.

    One 1 per mesh entry this process owns, on that entry's device, summed
    here and all-reduced over every process: the result depends on every
    process's contribution, so a dead process stalls the collective (and
    its timeout fails the job) everywhere.
    """
    entries = mesh.local_entries()
    home = entries[0][2]
    count = sum(torch.ones((), device=dev).to(home) for _, _, dev in entries)
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(count)
    return int(count.item())
