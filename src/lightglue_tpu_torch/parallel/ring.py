"""Ring attention: attention over a sequence split into stripes around a ring.

Counterpart of ``lightglue_tpu/parallel/ring.py``. Each ring position holds
one Q stripe and starts with the K/V block of the same rows; at every step
it merges the block it holds into its running online-softmax carries
(``kernels.attention.flash_attention_step``) while that block moves on to
the next position, so after ``ring`` steps every stripe has seen every
block without the full (N_q, N_kv) similarity existing anywhere. The merge
is algebraically exact, so the result is single-device attention up to fp
rounding.

``ring_attention_local`` is one position's body. Before each step but the
last it posts the transfer of the block it holds to the next position (and
the receive of its predecessor's), then runs the step, then waits for the
transfer: JAX's ``ppermute`` for step s+1, which XLA starts before step s's
matmuls (:97-114). A ``Transport`` moves the blocks:

- ``ring_attention(..., devices=[...])``: every position in this process,
  one after another (``_LocalTransport``). Position i computes on
  ``devices[i]`` and a block moves to the next position's device with
  ``.to(...)``, a real copy between two cards and no copy at all when the
  ring repeats one card (``[cuda:0] * P``, the serial ring that measures
  the path on one H100).
- ``ring_attention(..., group=...)``: one position per process of a
  ``torch.distributed`` group, rank r at position r, each passing its own
  stripe and getting its own output stripe back (a sharded ``jax.Array``'s
  addressable shard). The transport follows the group's backend for the
  block's device, never an error: on NCCL with device tensors and on gloo
  with CPU tensors the block goes straight to the next rank
  (``_DirectTransport``, ``dist.batch_isend_irecv``); on gloo with CUDA
  tensors, ranks that share one card (NCCL refuses two ranks on a card, and
  gloo sends only host memory), it is staged through pinned host buffers
  (``_StagedTransport``) while the step runs on the card.

Both process transports receive into two slots: the block for step s+1
lands in slot s % 2 while step s reads the other (the caller's block at
step 0), so no step reads a slot that is being written. K and V travel as
one packed [k; v] buffer, one message each way a step, so a ring of two,
where the next rank is the previous one, cannot cross them, and a step
pays one message's latency, not two.

Masking follows the repo contract: ``lengths`` (B, 2) GLOBAL [q_len,
kv_len]; padded KV columns are -1e30 before the softmax and padded Q rows
are 0.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from lightglue_tpu_torch.kernels.attention import _NEG_INF, flash_attention_step

AXIS_SEQ = "seq"

Block = Tuple[torch.Tensor, torch.Tensor]

# host seconds spent inside the process transports' post and wait calls
# (stage_s: the part of post_s spent waiting for the caller's block to reach
# host memory), and the posts made, since the caller last set them to 0
transport_time = {"posts": 0, "post_s": 0.0, "stage_s": 0.0, "wait_s": 0.0}


class Transport:
    """Moves K/V blocks one position on around the ring, for one
    ``ring_attention_local`` call: ``post(k, v, src)`` starts sending the
    block this position holds (it originated at position ``src``) to the
    next position and receiving the predecessor's; ``wait(handle)`` returns
    the received block. The step between the two reads only the held block."""

    def post(self, k: torch.Tensor, v: torch.Tensor, src: int):
        raise NotImplementedError

    def wait(self, handle) -> Block:
        raise NotImplementedError


class _LocalTransport(Transport):
    """A position of a ring run in this process: the block its predecessor
    holds now (it originated at ``src - 1``), copied onto this position's
    card from the card it started on."""

    def __init__(self, ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor], device):
        self.ks, self.vs, self.device = ks, vs, device

    def post(self, k, v, src):
        return (src - 1) % len(self.ks)

    def wait(self, prev):
        return self.ks[prev].to(self.device), self.vs[prev].to(self.device)


class ProcessRing:
    """This process's place in a ``torch.distributed`` group used as a ring:
    its position (the group rank), the ring size, the global ranks of the
    next and previous positions, and whether the group's backend for
    ``device`` needs its blocks staged through host memory."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.idx = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.next = dist.get_global_rank(group, (self.idx + 1) % self.size)
        self.prev = dist.get_global_rank(group, (self.idx - 1) % self.size)
        backend = str(dist.get_backend(group))
        if ":" in backend:  # a device-mapped group, "cpu:gloo,cuda:nccl"
            backend = dict(p.split(":") for p in backend.split(","))[torch.device(device).type]
        # gloo moves host memory only: CUDA blocks are staged through it
        self.staged = backend == "gloo" and torch.device(device).type == "cuda"

    def transport(self, k: torch.Tensor, v: torch.Tensor) -> "_DoubleBuffered":
        """A transport for one ring call over blocks shaped like ``k``/``v``."""
        return (_StagedTransport if self.staged else _DirectTransport)(self, k, v)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every position's stripe of ``x``, concatenated along ``dim`` in ring
        order, on every position (through host memory where ``staged``)."""
        src = x.cpu().contiguous() if self.staged else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim=dim).to(x.device)


class _DoubleBuffered(Transport):
    """The process transports' two receive slots: post s receives the block
    of step s+1 into slot s % 2, which step s does not read (it reads slot
    (s - 1) % 2, or the caller's block at s = 0). ``_start`` and ``_finish``
    move the bytes."""

    def __init__(self, ring: ProcessRing):
        self.ring = ring
        self.posted = 0

    def post(self, k, v, src):
        s, t = self.posted, time.perf_counter()
        self.posted += 1
        handle = (s % 2, self._start(k, v, s, s % 2))
        transport_time["posts"] += 1
        transport_time["post_s"] += time.perf_counter() - t
        return handle

    def wait(self, handle):
        t = time.perf_counter()
        block = self._finish(*handle)
        transport_time["wait_s"] += time.perf_counter() - t
        return block

    def _start(self, k, v, s: int, slot: int):
        raise NotImplementedError

    def _finish(self, slot: int, pending) -> Block:
        raise NotImplementedError


class _DirectTransport(_DoubleBuffered):
    """Blocks straight to the next rank: gloo with CPU tensors, NCCL with
    device tensors (its P2P runs on NCCL's stream, which waits for the work
    queued before the post, so a slot's receive follows the step that read
    it). Each block travels as one packed [k; v] message: post 0 packs the
    caller's block, and every later post sends on the slot the previous
    post received into, the block the step has just read."""

    def __init__(self, ring: ProcessRing, k: torch.Tensor, v: torch.Tensor):
        super().__init__(ring)
        self.slots = [_packed_like(k, v, k.device) for _ in range(2)]

    def _start(self, k, v, s, slot):
        send = torch.stack([k, v]) if s == 0 else self.slots[1 - slot]  # held until the wait
        r = self.ring
        return send, dist.batch_isend_irecv([dist.P2POp(dist.isend, send, r.next, r.group),
                                             dist.P2POp(dist.irecv, self.slots[slot], r.prev,
                                                        r.group)])

    def _finish(self, slot, pending):
        for work in pending[1]:
            work.wait()
        return self.slots[slot][0], self.slots[slot][1]


def _packed_like(k: torch.Tensor, v: torch.Tensor, device, pin_memory=False) -> torch.Tensor:
    """An empty (2, *k.shape) buffer for one packed [k; v] block."""
    if k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError(f"ring transport: k {tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} "
                         f"{v.dtype}")
    return torch.empty((2,) + tuple(k.shape), dtype=k.dtype, device=device,
                       pin_memory=pin_memory)


class _StagedTransport(_DoubleBuffered):
    """gloo between ranks that share a card: each block crosses in host
    memory while the step runs on the card.

    Two pinned host buffers of the packed [k; v] block and two device slots,
    allocated once per ring call. Post s sends host buffer s % 2 and
    receives into the other; the caller's block reaches host buffer 0 by
    one device-to-host copy on a side stream before post 0 sends it, and
    every later block is sent on from the host buffer it arrived in. Wait s
    waits for the host P2P (the step kernel runs meanwhile), then copies the
    received buffer into device slot s % 2 on the side stream, after the
    work queued before post s (step s - 1, the last reader of that slot),
    and makes the caller's stream wait for that copy before the next step.
    A host buffer is received into again only after the host has seen its
    last copy to the card finish."""

    def __init__(self, ring: ProcessRing, k: torch.Tensor, v: torch.Tensor):
        super().__init__(ring)
        self.main = torch.cuda.current_stream(k.device)
        self.side = _side_stream(k.device)
        self.host = [_packed_like(k, v, "cpu", pin_memory=True) for _ in range(2)]
        self.slots = [_packed_like(k, v, k.device) for _ in range(2)]
        self.copied = [None, None]  # the last copy out of each host buffer
        self.freed = None           # the caller's stream after the reader of the next slot

    def _start(self, k, v, s, slot):
        send, recv = self.host[slot], self.host[1 - slot]
        if s == 0:  # the caller's block to host memory
            staged = self._on_side(lambda: (send[0].copy_(k, non_blocking=True),
                                            send[1].copy_(v, non_blocking=True)))
            t = time.perf_counter()
            staged.synchronize()
            transport_time["stage_s"] += time.perf_counter() - t
        if self.copied[1 - slot] is not None:
            self.copied[1 - slot].synchronize()
        self.freed = torch.cuda.Event()
        self.freed.record(self.main)
        r = self.ring
        return dist.batch_isend_irecv([dist.P2POp(dist.isend, send, r.next, r.group),
                                       dist.P2POp(dist.irecv, recv, r.prev, r.group)])

    def _finish(self, slot, works):
        for work in works:
            work.wait()
        dst = self.slots[slot]
        self.copied[1 - slot] = self._on_side(
            lambda: dst.copy_(self.host[1 - slot], non_blocking=True), after=self.freed)
        self.main.wait_event(self.copied[1 - slot])
        return dst[0], dst[1]

    def _on_side(self, copy, after=None) -> torch.cuda.Event:
        """``copy`` on the side stream once the caller's stream has reached
        ``after`` (default: now); returns the event of its end."""
        if after is None:
            after = torch.cuda.Event()
            after.record(self.main)
        done = torch.cuda.Event()
        with torch.cuda.stream(self.side):
            self.side.wait_event(after)
            copy()
            done.record(self.side)
        return done


_SIDE_STREAMS = {}


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(device=index)
    return _SIDE_STREAMS[index]


def ring_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor],
    *,
    idx: int,
    ring: int,
    transport: Transport,
    scale: Optional[float] = None,
    step: Callable = flash_attention_step,
) -> torch.Tensor:
    """One ring position's body (JAX :53-121).

    Args:
      q: (B, H, n, D) this position's Q stripe (n = N_q / ring).
      k, v: (B, H, nk, D) the K/V block that originated here.
      lengths: optional (B, 2) GLOBAL [q_len, kv_len].
      idx/ring: this position and the ring size.
      transport: moves the blocks; the transfer for step s+1 is posted
        before step s and waited for after it.
      step: the merge; ``flash_attention_step_plain`` runs the same loop on
        the plain version.

    Returns:
      (B, H, n, D) in q's dtype.
    """
    b, h, n, d = q.shape
    nk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    m = torch.full((b, h, n, 1), _NEG_INF, device=q.device)
    l = torch.zeros((b, h, n, 1), device=q.device)
    acc = torch.zeros((b, h, n, d), device=q.device)
    if lengths is not None:
        lengths = lengths.to(q.device, torch.int32)
    # step s merges the block that originated at position (idx - s) mod ring
    for s in range(ring):
        src = (idx - s) % ring
        pending = transport.post(k, v, src) if s + 1 < ring else None
        m, l, acc = step(q, k, v, m, l, acc, lengths, idx * n, src * nk, scale=scale)
        if pending is not None:
            k, v = transport.wait(pending)
    out = acc / torch.where(l == 0.0, 1.0, l)
    if lengths is not None:
        rows = idx * n + torch.arange(n, device=q.device)  # global row ids of this stripe
        valid = rows[None, :] < lengths[:, :1]  # (B, n)
        out = torch.where(valid[:, None, :, None], out, 0.0)
    return out.to(q.dtype)


def divide_error(nq: int, nk: int, ring: int) -> ValueError:
    return ValueError(f"sequence dims {nq}/{nk} must divide the ring size {ring}")


def agree(group, signature, size: int) -> list:
    """Every rank's ``signature`` (a picklable shape summary), gathered on
    every rank before any P2P is posted, so a check that reads them fails
    on all ranks alike instead of leaving the others waiting for a block."""
    sigs = [None] * size
    dist.all_gather_object(sigs, signature, group=group)
    return sigs


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    *,
    devices: Optional[Sequence[torch.device]] = None,
    group=None,
    scale: Optional[float] = None,
    step: Callable = flash_attention_step,
) -> torch.Tensor:
    """Sequence-split attention (JAX :124-168) over ``devices`` in this
    process, or over the processes of ``group``.

    Args:
      q: (B, H, N_q, D); k, v: (B, H, N_kv, D); both sequence lengths
        divisible by the ring size. Under ``group``: this rank's stripe of
        q and block of k and v, every rank's of one shape.
      lengths: optional (B, 2) global [q_len, kv_len], on every rank alike.
      devices: the ring, one ``torch.device`` per position; it may repeat
        one card. Stripe i of q, k and v goes to ``devices[i]``.
      group: a ``torch.distributed`` group (``dist.group.WORLD`` for all);
        rank r is position r and holds stripe r. Every rank's shapes are
        gathered and checked on every rank before the first transfer.

    Returns:
      (B, H, N_q, D) in q's dtype, on q's device; under ``group`` this
      rank's (B, H, n, D) stripe of it.
    """
    if (devices is None) == (group is None):
        raise ValueError("ring_attention: pass devices= (every position in this process) "
                         "or group= (one position per process)")
    if group is not None:
        return _ring_attention_group(q, k, v, lengths, group, scale, step)
    ring = len(devices)
    if q.shape[2] % ring or k.shape[2] % ring:
        raise divide_error(q.shape[2], k.shape[2], ring)
    devices = [torch.device(dev) for dev in devices]
    qs = [t.to(dev) for t, dev in zip(q.chunk(ring, dim=2), devices)]
    ks = [t.to(dev) for t, dev in zip(k.chunk(ring, dim=2), devices)]
    vs = [t.to(dev) for t, dev in zip(v.chunk(ring, dim=2), devices)]
    outs = [ring_attention_local(qs[idx], ks[idx], vs[idx], lengths, idx=idx, ring=ring,
                                 transport=_LocalTransport(ks, vs, dev), scale=scale, step=step)
            for idx, dev in enumerate(devices)]
    return torch.cat([o.to(q.device) for o in outs], dim=2)


def _ring_attention_group(q, k, v, lengths, group, scale, step):
    pr = ProcessRing(group, k.device)
    shapes = tuple(None if t is None else tuple(t.shape) for t in (q, k, v, lengths))
    sigs = agree(group, shapes, pr.size)
    nq, nk = (sum(sig[i][2] for sig in sigs) for i in (0, 1))
    if len({(sig[0][2], sig[1][2], sig[2][2]) for sig in sigs}) > 1:
        raise divide_error(nq, nk, pr.size)
    if len(set(sigs)) > 1:
        raise ValueError(f"ring_attention: the ranks' (q, k, v, lengths) shapes differ: {sigs}")
    b, h, _, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[1], k.shape[3]) != (b, h, d):
        raise ValueError(f"ring_attention: q {shapes[0]}, k {shapes[1]}, v {shapes[2]}")
    if lengths is not None and shapes[3] != (b, 2):
        raise ValueError(f"ring_attention: lengths {shapes[3]}, want ({b}, 2)")
    return ring_attention_local(q, k, v, lengths, idx=pr.idx, ring=pr.size,
                                transport=pr.transport(k, v), scale=scale, step=step)
