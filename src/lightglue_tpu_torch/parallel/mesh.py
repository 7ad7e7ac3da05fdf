"""Device-mesh parallelism: data-parallel pairs x tensor-parallel heads.

Counterpart of ``lightglue_tpu/parallel/mesh.py``. Image pairs split over a
``data`` mesh axis; LightGlue's heads and FFN columns optionally split over
a ``model`` axis, whole heads per shard, with one all-reduce per row-sharded
projection and the LayerNorm statistics all-reduced in place
(``models/lightglue.py:TensorParallel``). No pipeline, expert or sequence
axis: the JAX module's reasons hold (``parallel/ring.py`` is the sequence
split).

JAX runs the mesh as one SPMD program under ``shard_map``. Here a ``Mesh``
is a data x model grid of ``torch.device``s, each owned by one process, and
a step runs, for every entry this process owns, that shard's body on that
entry's device:

- At ``model == 1`` the shards of a process run one after another from the
  calling thread; launches are asynchronous, so shards on different cards
  overlap. Each takes ``forward``'s route (the layer stack where its gate
  passes).
- At ``model > 1`` the shards of one data row run in threads of their own,
  and meet wherever the model sums a partial (``_ModelAxis``): the shards
  this process holds are summed there in shard order, in fp32 and rounded
  once to the partials' type, and where the row spans processes the sum is
  all-reduced over that row's process group. The per-block route runs, at
  H / model local heads.

In one process a step returns the whole batch on the mesh's first device;
across processes each process returns the rows its entries own, as
``multihost.ShardedArray``s. A single-process mesh may repeat one card
(``[cuda:0] * 4``, as ``parallel/ring.py`` does), the only way one card runs
a data or model axis. Its defaults take the cards; a CUDA mesh without a
card raises, and the CPU is used only when asked for
(``devices=[torch.device("cpu")] * n``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from lightglue_tpu_torch.config import PipelineConfig
from lightglue_tpu_torch.models import lightglue, superpoint
from lightglue_tpu_torch.parallel import multihost
from lightglue_tpu_torch.parallel.multihost import Shard, ShardedArray
from lightglue_tpu_torch.pipeline.extract import extract_keypoints
from lightglue_tpu_torch.pipeline.match import filter_matches
from lightglue_tpu_torch.precision import policy_for, precision_scope

AXIS_DATA = "data"
AXIS_MODEL = "model"


class Mesh:
    """A (data, model) grid of devices: ``devices[i][j]``, owned by the
    process of rank ``ranks[i][j]``; ``rank`` is this process's."""

    def __init__(self, devices: List[List[torch.device]], ranks: List[List[int]], rank: int):
        self.devices, self.ranks, self.rank = devices, ranks, rank
        self.shape = {AXIS_DATA: len(devices), AXIS_MODEL: len(devices[0])}
        self.size = self.shape[AXIS_DATA] * self.shape[AXIS_MODEL]
        # the model axis of every data row that spans processes gets a group;
        # every process creates every group, in row order (dist.new_group)
        self._groups: Dict[int, object] = {}
        made: Dict[Tuple[int, ...], object] = {}
        for i, row in enumerate(ranks):
            members = tuple(sorted(set(row)))
            if len(members) > 1:
                if members not in made:
                    made[members] = dist.new_group(list(members))
                self._groups[i] = made[members]

    def local_rows(self) -> List[Tuple[int, List[Tuple[int, torch.device]]]]:
        """[(data row, [(model index, device), ...])] of the entries this
        process owns, rows in order."""
        out = []
        for i, row in enumerate(self.devices):
            mine = [(j, dev) for j, dev in enumerate(row) if self.ranks[i][j] == self.rank]
            if mine:
                out.append((i, mine))
        return out

    def local_entries(self) -> List[Tuple[int, int, torch.device]]:
        return [(i, j, dev) for i, row in self.local_rows() for j, dev in row]

    def row_device(self, i: int) -> torch.device:
        """The device of the first entry this process owns in data row ``i``."""
        return next(dev for j, dev in enumerate(self.devices[i]) if self.ranks[i][j] == self.rank)

    def model_group(self, i: int):
        """The process group of data row ``i``'s model axis, or None where
        this process holds the whole row."""
        return self._groups.get(i)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices}, ranks={self.ranks})"


def _default_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass devices=[torch.device('cpu')] * n "
                           "to run a mesh on the CPU")
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, model) mesh.

    Args:
      data: data-axis size (default: every device over ``model``).
      model: model-axis size; it must divide the head count.
      devices: this process's devices, in order (default: every card it
        sees). One card may repeat. Across processes the grid is every
        process's devices in rank order (gathered from all of them), so
        every process calls ``make_mesh`` with the same sizes.
    """
    local = [torch.device(d) for d in (devices if devices is not None else _default_devices())]
    if any(d.type == "cuda" for d in local) and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: a CUDA mesh and no CUDA device")
    rank = multihost.process_rank()
    if multihost.is_multiprocess():
        gathered: List = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, [str(d) for d in local])
        flat = [(r, torch.device(d)) for r, devs in enumerate(gathered) for d in devs]
    else:
        flat = [(rank, d) for d in local]
    n = len(flat)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    rows = [flat[i * model:(i + 1) * model] for i in range(data)]
    return Mesh([[d for _, d in row] for row in rows], [[r for r, _ in row] for row in rows], rank)


# ---------------------------------------------------------------------------
# parameter sharding
# ---------------------------------------------------------------------------

# A spec holds one entry per leading dim of a leaf (missing trailing entries:
# whole): None (whole), AXIS_MODEL (split in ``model`` equal blocks), or
# (AXIS_MODEL, k): the dim is k equal components ([q | k | v]: 3, [qk | v]:
# 2), each split in ``model`` blocks, so a shard takes its heads' columns of
# every component. () is replicated. STACK_ONLY marks the W8A8 stack's
# K-major ``w_t``, which only the layer stack reads: replicated at
# ``model == 1`` and left out of a tensor-parallel shard's tree.
STACK_ONLY = "stack_only"
_COLUMN_SHARDED = {"qkv": 3, "qk_v": 2, "ffn1": 1}  # [in, out]: the out columns
_ROW_SHARDED = ("out", "ffn2")                      # [in, out]: the in rows


def _linear_specs(name: str, node: dict) -> dict:
    specs = {}
    for key in node:
        if key == "w_t":
            specs[key] = STACK_ONLY
        elif name in _ROW_SHARDED:
            specs[key] = (None, AXIS_MODEL, None) if key in ("w", "w_q") else ()
        else:  # out columns; a (L, N) bias or per-channel scale follows them
            parts = _COLUMN_SHARDED[name]
            col = AXIS_MODEL if parts == 1 else (AXIS_MODEL, parts)
            specs[key] = (None, None, col) if key in ("w", "w_q") else (None, col)
    return specs


def lightglue_param_specs(params) -> dict:
    """Specs of the port's LightGlue tree (``runtime/weights.py``'s layout,
    layers stacked on the leading axis), whole-head aligned:

      self_attn.qkv w (L, E, 3E), columns [q | k | v]  -> each component's heads
      cross_attn.qk_v w (L, E, 2E), columns [qk | v]   -> each component's heads
      qkv / qk_v b (L, 3E) / (L, 2E)                   -> as their columns
      out w (L, E, E), ffn2 w (L, 2E, E)               -> rows (the input features)
      ffn1 w (L, 2E, 2E), b, ln_g, ln_b (L, 2E)        -> columns
      everything else (out / ffn2 b, posenc, heads)    -> replicated

    An int8 linear ({w_q, scale, b, w_t}) shards ``w_q`` like ``w``; its
    (L, N) per-output-channel scale follows the output columns of a
    column-sharded linear and stays whole for a row-sharded one (JAX
    :71-106); ``w_t`` is ``STACK_ONLY``. RoPE's de-interleave permutation
    acts inside each head (``weights.rope_permutation``), so whole-head
    slices keep it.
    """

    def walk(node, path):
        out = {}
        for key, val in node.items():
            if isinstance(val, dict):
                if len(path) == 2 and path[0] == "layers" and key in (*_COLUMN_SHARDED,
                                                                       *_ROW_SHARDED):
                    out[key] = _linear_specs(key, val)
                else:
                    out[key] = walk(val, path + (key,))
            elif len(path) == 2 and path[0] == "layers" and key in ("ln_g", "ln_b"):
                out[key] = (None, AXIS_MODEL)
            else:
                out[key] = ()
        return out

    return walk(params, ())


def _shard_leaf(t: torch.Tensor, spec, index: int, size: int) -> torch.Tensor:
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        parts = 1 if entry == AXIS_MODEL else entry[1]
        n = t.shape[dim]
        if n % (parts * size):
            raise ValueError(f"dim {dim} of {tuple(t.shape)}: {parts} components over a model "
                             f"axis of {size}")
        t = t.unflatten(dim, (parts, n // parts)).chunk(size, dim + 1)[index].flatten(dim, dim + 1)
    return t.contiguous()


def _shard_tree(tree, specs, index: int, size: int, device: torch.device):
    out = {}
    for key, val in tree.items():
        spec = specs[key]
        if isinstance(val, dict):
            out[key] = _shard_tree(val, spec, index, size, device)
        elif spec == STACK_ONLY:
            if size == 1:
                out[key] = val.to(device)
        else:
            out[key] = _shard_leaf(val, spec, index, size).to(device)
    return out


class MeshParams(NamedTuple):
    """A LightGlue tree placed on a mesh: ``shards[(i, j)]`` is entry (i, j)'s
    slice, on its device, for every entry this process owns (entries of one
    model index on one device share their tensors)."""

    mesh: Mesh
    specs: dict
    shards: Dict[Tuple[int, int], dict]


def shard_lightglue_params(params, mesh: Mesh) -> MeshParams:
    """Place the port's LightGlue tree on the mesh, whole heads per model
    shard (``lightglue_param_specs``)."""
    specs = lightglue_param_specs(params)
    size = mesh.shape[AXIS_MODEL]
    placed: Dict[Tuple[torch.device, int], dict] = {}
    shards = {}
    for i, j, dev in mesh.local_entries():
        if (dev, j) not in placed:
            placed[(dev, j)] = _shard_tree(params, specs, j, size, dev)
        shards[(i, j)] = placed[(dev, j)]
    return MeshParams(mesh, specs, shards)


def _structure(tree):
    """The nested keys of a tree (JAX ``tree.structure``)."""
    return tuple((k, _structure(v) if isinstance(v, dict) else None)
                 for k, v in sorted(tree.items()))


def _place(tree, device: torch.device):
    return {k: _place(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# running a step over the mesh
# ---------------------------------------------------------------------------


class _ModelAxis:
    """The model axis of one data row for one call. The shards this process
    holds meet at a barrier whose action (run by one of them, once all have
    arrived) sums their partials in shard order in fp32 and, where the row
    spans processes, all-reduces the sum over the row's group; each shard
    then takes the sum, in its partial's type, onto its device.

    Each shard's Python runs while it holds ``turn``, which it gives up only
    while it waits at the barrier, so one shard thread at a time is
    runnable: every torch call releases and retakes the interpreter lock,
    and four runnable threads swapped it at every call (a 1 x 4 step took
    about twice as long without the turn on an H100's host, PERF.md §6)."""

    def __init__(self, order: List[int], size: int, group):
        self.order, self.size, self.group = order, size, group
        self.partials: Dict[int, torch.Tensor] = {}
        self.total: Optional[torch.Tensor] = None
        self.barrier = threading.Barrier(len(order), action=self._reduce)
        self.turn = threading.Lock()

    def _reduce(self) -> None:
        first = self.partials[self.order[0]]
        acc = first.to(torch.float32, copy=True)
        for j in self.order[1:]:
            acc += self.partials[j].to(first.device, torch.float32)
        if self.group is not None:
            dist.all_reduce(acc, group=self.group)
        self.total = acc.to(first.dtype)

    def shard(self, j: int) -> "lightglue.TensorParallel":
        def all_reduce(x: torch.Tensor) -> torch.Tensor:
            self.partials[j] = x
            self.turn.release()
            try:
                self.barrier.wait()
            finally:
                self.turn.acquire()
            return self.total.to(x.device)

        return lightglue.TensorParallel(self.size, all_reduce)


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _run_shards(mesh: Mesh, body: Callable, tensor_parallel: bool) -> Dict[int, object]:
    """``body(i, j, device, tp)`` for the entries this process owns; returns
    {data row: its first local entry's result}. Without ``tensor_parallel``
    one entry per row runs (the model axis would only repeat it), with
    ``tp`` None."""
    out = {}
    for i, entries in mesh.local_rows():
        if not tensor_parallel:
            j, dev = entries[0]
            with _on(dev), torch.inference_mode():
                out[i] = body(i, j, dev, None)
            continue
        axis = _ModelAxis([j for j, _ in entries], mesh.shape[AXIS_MODEL], mesh.model_group(i))
        results, errors = {}, []

        def work(j, dev, thread, i=i, axis=axis, results=results, errors=errors):
            try:
                # a new thread has no current device of its own
                place = contextlib.nullcontext() if thread else _on(dev)
                if thread and dev.type == "cuda":
                    torch.cuda.set_device(dev)
                with place, axis.turn, torch.inference_mode():
                    results[j] = body(i, j, dev, axis.shard(j))
            except Exception as exc:  # re-raised below; the other shards leave the barrier
                errors.append(exc)
                axis.barrier.abort()

        if len(entries) == 1:  # the rest of the row is in other processes
            work(*entries[0], False)
        else:
            threads = [threading.Thread(target=work, args=(j, dev, True)) for j, dev in entries]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errors:
            first = [e for e in errors if not isinstance(e, threading.BrokenBarrierError)]
            raise (first or errors)[0]
        out[i] = results[entries[0][0]]
    return out


def _batch(args) -> int:
    for a in args:
        if a is not None:
            return a.shape[0]
    raise ValueError("no batch-major input")


def _rows(x, i: int, per: int, device: torch.device):
    """Data row ``i``'s ``per`` rows of a global batch input, on ``device``."""
    if x is None:
        return None
    if isinstance(x, ShardedArray):
        for shard in x.shards:
            if shard.start == i * per:
                return shard.data.to(device)
        raise ValueError(f"this process holds no shard of rows {i * per}..")
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x[i * per:(i + 1) * per].to(device, non_blocking=True)


def _collect(mesh: Mesh, per_row: Dict[int, object], per: int, batch: int):
    """Rows' results -> the whole batch on the mesh's first device (one
    process), or ``ShardedArray``s of this process's rows. A 0-dim field
    (``n_layers_run``) is the same in every row: the first row's."""
    first = next(iter(per_row.values()))
    if isinstance(first, tuple):
        fields = [_collect(mesh, {i: v[k] for i, v in per_row.items()}, per, batch)
                  for k in range(len(first))]
        return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)
    if first.dim() == 0:
        return first
    if multihost.is_multiprocess():
        return ShardedArray((batch,) + tuple(first.shape[1:]),
                            [Shard(i * per, v) for i, v in sorted(per_row.items())])
    home = mesh.devices[0][0]
    return torch.cat([per_row[i].to(home) for i in sorted(per_row)], dim=0)


def _run_step(mesh: Mesh, body: Callable, args, tensor_parallel: bool, policy):
    """``body(i, j, device, tp, *rows)`` over the mesh on the data-split
    ``args``; returns the collected batch."""
    batch = _batch(args)
    data = mesh.shape[AXIS_DATA]
    if batch % data:
        raise ValueError(f"batch {batch} does not split over a data axis of {data}")
    per = batch // data

    def shard_body(i, j, dev, tp):
        return body(i, j, dev, tp, *(_rows(a, i, per, dev) for a in args))

    with precision_scope(policy):  # the TF32 switches are global: set once, around the threads
        per_row = _run_shards(mesh, shard_body, tensor_parallel)
    return _collect(mesh, per_row, per, batch)


# ---------------------------------------------------------------------------
# sharded steps
# ---------------------------------------------------------------------------


def make_parallel_match_fn(mesh: Mesh, config: PipelineConfig, bucket0: int, bucket1: int,
                           full: bool = False):
    """Batched LightGlue matching over (data, model): ``forward`` then
    ``filter_matches`` at ``k = min(max_matches, bucket0)`` on every shard.

    The returned ``call(lg_params, kpts0, kpts1, desc0, desc1, lengths0,
    lengths1)`` takes a ``MeshParams`` (``shard_lightglue_params``; a plain
    tree is sharded on each call) and the global batch (tensors or arrays,
    or ``ShardedArray``s), whose size the data axis must divide; it returns
    ``(LightGlueOutput, Matches)``. ``full=True`` runs the unmasked variant
    (lengths ignored) for batches where every pair fills its bucket.
    """
    policy = policy_for(config.precision)
    tp = mesh.shape[AXIS_MODEL]
    if config.lightglue.num_heads % tp:
        raise ValueError(f"a model axis of {tp} splits {config.lightglue.num_heads} heads")
    k = min(config.max_matches, bucket0)

    def step(lg_params, tp_ctx, kpts0, kpts1, desc0, desc1, lengths0, lengths1):
        out = lightglue.forward(
            lg_params, kpts0, kpts1, desc0, desc1,
            None if full else lengths0, None if full else lengths1,
            config=config.lightglue, policy=policy, tp=tp_ctx)
        matches = filter_matches(out.scores, threshold=config.match_threshold, max_matches=k)
        return out, matches

    def build(specs):
        def run(lg_params: MeshParams, *args):
            if lg_params.specs != specs:
                raise ValueError("params sharded under other specs than this build's")

            def body(i, j, dev, tp_ctx, *rows):
                return step(lg_params.shards[(i, j)], tp_ctx, *rows)

            return _run_step(mesh, body, args, tp > 1, policy)

        return run

    compiled = {}

    def call(lg_params, *args):
        if not isinstance(lg_params, MeshParams):
            lg_params = shard_lightglue_params(lg_params, mesh)
        if lg_params.mesh is not mesh:
            raise ValueError("params were sharded for another mesh")
        # keyed on the tree's structure: an int8 tree (w_q, scale, w_t) gets
        # its own build with its own specs
        key = _structure(next(iter(lg_params.shards.values())))
        if key not in compiled:
            compiled[key] = build(lg_params.specs)
        return compiled[key](lg_params, *args)

    return call


def make_parallel_adaptive_fn(mesh: Mesh, config: PipelineConfig, full: bool = False):
    """Data-parallel ``forward_adaptive`` (early depth exit and width
    pruning) over the mesh: ``call(lg_params, kpts0, kpts1, desc0, desc1,
    lengths0, lengths1) -> AdaptiveOutput``.

    The adaptive path has no tensor-parallel variant (per-pair exit
    registers and compaction do not split over heads), so ``lg_params`` is
    the whole tree, placed on each device, and a model axis only repeats
    work (one entry per data row runs). Per-pair exits and compacted index
    maps come out of each data shard as a single device gives them; the
    downshift's host read happens once per shard.
    """
    policy = policy_for(config.precision)

    def step(lg_params, kpts0, kpts1, desc0, desc1, lengths0, lengths1):
        return lightglue.forward_adaptive(
            lg_params, kpts0, kpts1, desc0, desc1, lengths0, lengths1,
            config=config.lightglue, policy=policy, full=full)

    def call(lg_params, *args):
        def body(i, j, dev, tp_ctx, *rows):
            return step(_place(lg_params, dev), *rows)

        return _run_step(mesh, body, args, False, policy)

    return call


def make_parallel_extract_fn(mesh: Mesh, config: PipelineConfig):
    """Data-parallel SuperPoint and extraction over the mesh:
    ``run(sp_params, images) -> Extraction`` for (B, H, W, 1) images, B
    divisible by the data axis. Each shard convolves its images one at a
    time (``models/superpoint.py:_conv``), as a single device does."""
    policy = policy_for(config.precision)

    def run(sp_params, images):
        def body(i, j, dev, tp_ctx, rows):
            scores, desc = superpoint.forward(_place(sp_params, dev), rows,
                                              config=config.superpoint, policy=policy, nms=False)
            return extract_keypoints(scores, desc, config=config.superpoint, raw_scores=True)

        return _run_step(mesh, body, (images,), False, policy)

    return run
