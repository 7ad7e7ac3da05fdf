"""Continuous batching of image pairs with keypoint-count buckets, on one card.

Counterpart of ``lightglue_tpu/parallel/batcher.py:ContinuousBatcher``
(:58-188). The reference processes pairs strictly serially
(demo/demo_mono.cpp:211); here pairs are routed to the queue of the smallest
bucket that holds both sides, and a fixed-size batch is dispatched to the
match step whenever a queue fills, so every dispatch runs a runner of a
fixed shape: on a card, the session's CUDA graph of (bucket, bucket, batch),
captured at its first dispatch (``session_match_fn``), the counterpart of
JAX retracing per shape.

Each dispatch stages its inputs in pinned host buffers (one set per bucket)
and copies them to the card asynchronously; the graph's outputs are static
buffers that its next replay overwrites, so the dispatch copies counts,
indices and scores to pinned host memory and synchronises once before it
returns. The data-parallel path over a mesh (``sharding``) waits for the
port's ``parallel/mesh.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from lightglue_tpu_torch.runtime.session import resolve_device


@dataclass
class _PairItem:
    pair_id: int
    kpts0: np.ndarray  # (N0, 2) normalized
    kpts1: np.ndarray
    desc0: np.ndarray  # (N0, E)
    desc1: np.ndarray
    n0: int
    n1: int


@dataclass
class MatchResult:
    pair_id: int
    indices: np.ndarray  # (K, 2) valid matches only
    scores: np.ndarray   # (K,)


def session_match_fn(session) -> Callable:
    """``match_fn(params, kpts0, kpts1, desc0, desc1, len0, len1)`` on a
    ``MatcherSession``'s runners: the (bucket0, bucket1, batch) of the
    arrays' shapes picks ``session._match_fn(bucket0, bucket1, False,
    batch)``. ``params`` must be the session's LightGlue tree, which its
    runners hold."""

    def match_fn(params, kpts0, kpts1, desc0, desc1, len0, len1):
        if params is not session.lg_params:
            raise ValueError("match_fn runs the session's own LightGlue weights; pass "
                             "session.lg_params")
        run = session._match_fn(kpts0.shape[1], kpts1.shape[1], False, kpts0.shape[0])
        return run(kpts0, kpts1, desc0, desc1, len0, len1)

    return match_fn


class ContinuousBatcher:
    """Groups pairs into per-bucket batches and dispatches fixed shapes.

    Args:
      match_fn: callable (params, kpts0, kpts1, desc0, desc1, len0, len1) ->
        (model_out, Matches) on device tensors; typically
        ``session_match_fn(session)``.
      params: LightGlue parameter tree passed through to ``match_fn``.
      buckets: ascending keypoint buckets; a pair lands in the smallest
        bucket >= max(n0, n1) (one bucket for both sides keeps the number of
        runners linear, not quadratic, in the bucket count).
      batch_size: pairs per dispatch; a partial batch is padded with its
        last pair, whose extra results are dropped.
      sharding: a data-parallel mesh: not ported yet (``parallel/mesh.py``).
      device: where ``match_fn`` runs (None: the card; "cpu" only when asked).
    """

    def __init__(
        self,
        match_fn: Callable,
        params,
        buckets: Tuple[int, ...] = (256, 512, 1024),
        batch_size: int = 8,
        sharding=None,
        device: Optional[str] = None,
    ):
        if sharding is not None:
            raise NotImplementedError(
                "ContinuousBatcher(sharding=...): the data-parallel path needs the port's "
                "parallel/mesh.py, which is not ported yet; the batcher runs on one card")
        self.match_fn = match_fn
        self.params = params
        self.buckets = tuple(sorted(buckets))
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.queues: Dict[int, List[_PairItem]] = {b: [] for b in self.buckets}
        self.results: List[MatchResult] = []
        self.dispatches = 0
        self._staging: Dict[Tuple[int, int], List[torch.Tensor]] = {}

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def submit(self, pair_id, kpts0, kpts1, desc0, desc1) -> None:
        n0, n1 = len(kpts0), len(kpts1)
        bucket = self._bucket_for(max(n0, n1))
        n0, n1 = min(n0, bucket), min(n1, bucket)
        self.queues[bucket].append(
            _PairItem(pair_id, kpts0[:n0], kpts1[:n1], desc0[:n0], desc1[:n1], n0, n1)
        )
        if len(self.queues[bucket]) >= self.batch_size:
            self._dispatch(bucket)

    def flush(self) -> List[MatchResult]:
        """Dispatch all partial batches (padding with replicas of the last
        pair, whose results are dropped) and return accumulated results."""
        for bucket, queue in self.queues.items():
            if queue:
                self._dispatch(bucket)
        return self.results

    def _inputs(self, bucket: int, dim: int) -> List[torch.Tensor]:
        """The bucket's host input buffers (pinned on a card), zeroed: kpts0,
        kpts1, desc0, desc1, len0, len1. The last dispatch's copies out of
        them finished at its synchronisation."""
        key = (bucket, dim)
        if key not in self._staging:
            b, pin = self.batch_size, self.device.type == "cuda"
            shapes = [((b, bucket, 2), torch.float32)] * 2 + [((b, bucket, dim), torch.float32)] * 2
            shapes += [((b,), torch.int32)] * 2
            self._staging[key] = [torch.empty(s, dtype=dt, pin_memory=pin) for s, dt in shapes]
        bufs = self._staging[key]
        for t in bufs:
            t.zero_()
        return bufs

    def _dispatch(self, bucket: int) -> None:
        queue = self.queues[bucket]
        items = queue[: self.batch_size]
        del queue[: len(items)]
        real = len(items)
        while len(items) < self.batch_size:  # pad the batch with ballast
            items.append(items[-1])

        host = self._inputs(bucket, items[0].desc0.shape[-1])
        kpts0, kpts1, desc0, desc1, len0, len1 = (t.numpy() for t in host)
        for i, it in enumerate(items):
            kpts0[i, : it.n0] = it.kpts0
            kpts1[i, : it.n1] = it.kpts1
            desc0[i, : it.n0] = it.desc0
            desc1[i, : it.n1] = it.desc1
            len0[i], len1[i] = it.n0, it.n1
        arrays = [t.to(self.device, non_blocking=True) for t in host]
        with torch.inference_mode():
            _, matches = self.match_fn(self.params, *arrays)
        self.dispatches += 1

        counts, indices, scores = self._fetch(matches.count, matches.indices, matches.scores)
        for i in range(real):
            c = int(counts[i])
            self.results.append(
                MatchResult(items[i].pair_id, indices[i, :c], scores[i, :c])
            )

    def _fetch(self, *tensors: torch.Tensor) -> List[np.ndarray]:
        """Device tensors as host arrays of their own (pinned, one sync)."""
        if self.device.type != "cuda":
            return [t.numpy().copy() for t in tensors]
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return [h.numpy() for h in host]
