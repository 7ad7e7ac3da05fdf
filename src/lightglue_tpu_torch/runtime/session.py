"""Single-host inference session: bucketed end-to-end match on one card,
replayed from per-bucket CUDA graphs.

Counterpart of ``lightglue_tpu/runtime/session.py:MatcherSession``. It runs
the same two steps — extract (SuperPoint + keypoint selection) and match
(LightGlue + mutual-NN filtering) — with each pair padded to the smallest
keypoint bucket that holds it, and keeps the JAX session's two caches of
per-shape runners: ``_extract_cache`` (one per (batch, H, W), JAX
``_extract_fn`` :92) and ``_match_cache`` (one per (bucket0, bucket1, full,
batch): JAX ``_match_fn``'s key and its rules for ``full``, :137-163, plus
the batch, since a graph has a fixed shape). ``warmup`` fills them ahead of
serving with JAX's signature and variant rules (:341-389); a key it did not
warm is filled at its first dispatch.

On a CUDA device each runner is a ``torch.cuda.CUDAGraph`` of the eager
body (``_extract_eager``, ``_match_eager``), captured on static input
buffers after one eager warm-up call on a side stream (which builds the
kernel library and runs every first-launch setup) and then replayed. Each
extraction graph has a memory pool of its own (a call with two image shapes
reads the first graph's outputs after the second's replay); the match
graphs share one pool, since a call's match outputs are fetched or cloned
before the next dispatch, except a split graph's first half, whose state
the second half reads. The images go in through a pinned staging buffer;
the match graph's inputs are filled by device-to-device copies from the
extraction's outputs; the bucket is picked on the host from the two
keypoint counts (one fetch); the results come back through pinned memory
with one sync. A replay runs no Python of the kernel wrappers, so their
``launches`` counters move only in a key's first call (its eager warm-up
and its capture). A capture or replay that fails raises; nothing falls
back to the eager path.

Adaptive width pruning with ``downshift_layer`` reads the host once
mid-forward, at buckets where the downshift applies, to pick phase 2's
width (``models/lightglue.py:adaptive_head``): its match runner there is
two graphs, phase 1 up to the read, then the read (one fetch), then the
phase-2 graph of the value read (one per value, each captured at its first
use). On the CPU (``device="cpu"``, which only tests ask for) every runner
is the eager body, and the caches and ``warmup`` record the same keys.

The bodies are module functions that take the weights as an argument
(``extract_body``, ``match_head``, ``match_rest``): the session binds its
own, and ``runtime/aot.py`` exports the same functions with the weights as
the programs' first input.

An adaptive config (``depth_confidence`` / ``width_confidence`` > 0) runs
``lightglue.forward_adaptive`` and maps match rows and columns, which index
compacted (pruned) slots, back to the original keypoint indices on the
device.

Every precision rung runs on the card (``config.precision``): FP32, MIXED
(fp32 activations and statistics, bf16 products: the kernels' mixed
instantiations), BF16 and INT8 (``quant.quantize_lightglue``: int8 weights
with fp32 per-channel scales, bf16 activations; the layer stack's GEMM
dequantizes while it stages the weights, or with ``LGTPU_W8A8=1`` runs
int8 x int8 products on row-quantized activations; a graph keeps the mode
it was captured in).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from lightglue_tpu_torch.config import PipelineConfig
from lightglue_tpu_torch.models import lightglue, superpoint
from lightglue_tpu_torch.pipeline.extract import Extraction, extract_keypoints
from lightglue_tpu_torch.pipeline.match import Matches, filter_matches
from lightglue_tpu_torch.precision import DTypePolicy, policy_for
from lightglue_tpu_torch.quant import quantize_lightglue
from lightglue_tpu_torch.runtime import weights as weights_lib
from lightglue_tpu_torch.utils.logging import ErrorRecorder


def _remap(matches: Matches, index0: torch.Tensor, index1: torch.Tensor) -> Matches:
    """Match rows/columns index compacted slots; map them to the original
    keypoint indices (JAX session.py:205-219)."""
    rows = matches.indices[..., 0].clamp_min(0).long()
    cols = matches.indices[..., 1].clamp_min(0).long()
    orig = torch.stack([torch.gather(index0, 1, rows), torch.gather(index1, 1, cols)], -1)
    indices = torch.where(matches.mask[..., None], orig.to(matches.indices.dtype), -1)
    return Matches(indices, matches.scores, matches.mask, matches.count)


def extract_body(sp_params, images: torch.Tensor, *, config: PipelineConfig,
                 policy: DTypePolicy) -> Extraction:
    """SuperPoint and keypoint selection on (B, H, W, 1) fp32 images: the
    body of each extraction runner and of ``aot.export_extractor``."""
    scores, desc = superpoint.forward(sp_params, images, config=config.superpoint, policy=policy,
                                      nms=False)
    return extract_keypoints(scores, desc, config=config.superpoint, raw_scores=True)


def is_adaptive(config: PipelineConfig) -> bool:
    lgc = config.lightglue
    return lgc.depth_confidence > 0 or lgc.width_confidence > 0


def match_head(lg_params, kpts0, kpts1, desc0, desc1, count0, count1, *, config: PipelineConfig,
               policy: DTypePolicy, full: bool) -> dict:
    """The match body up to the downshift's host read (all of LightGlue
    elsewhere): kpts/desc are the extractions cut to the buckets,
    count0/count1 their (B,) keypoint counts; ``full`` as
    ``MatcherSession._match_fn`` normalized it."""
    lgc = config.lightglue
    lengths0 = torch.clamp(count0, max=kpts0.shape[1])
    lengths1 = torch.clamp(count1, max=kpts1.shape[1])
    inputs = (kpts0, kpts1, desc0, desc1)
    if is_adaptive(config):
        # adaptive always passes lengths; full runs the unmasked variant
        return lightglue.adaptive_head(lg_params, *inputs, lengths0, lengths1, config=lgc,
                                       policy=policy, full=full)
    return dict(out=lightglue.forward(
        lg_params, *inputs, None if full else lengths0, None if full else lengths1,
        config=lgc, policy=policy))


def match_rest(lg_params, head: dict, fits: Optional[bool], *, config: PipelineConfig,
               policy: DTypePolicy):
    """The match body from the host read on: the downshift's phase 2 at the
    width ``fits`` picks (None where ``head`` has no flag), the exit layer's
    head, the match filter. Returns (LightGlueOutput or AdaptiveOutput,
    Matches)."""
    adaptive = is_adaptive(config)
    if adaptive:
        out = lightglue.adaptive_rest(lg_params, head, fits, config=config.lightglue,
                                      policy=policy)
    else:
        out = head["out"]
    matches = filter_matches(
        out.scores,
        threshold=config.match_threshold,
        max_matches=min(config.max_matches, out.scores.shape[1]),
    )
    if adaptive:
        matches = _remap(matches, out.index0, out.index1)
    return out, matches


def reads_host(lg_params, bucket0: int, bucket1: int, config: PipelineConfig,
               policy: DTypePolicy) -> bool:
    """Whether the match body of (bucket0, bucket1) makes the downshift's
    host read (``match_head`` then returns the flag ``fits``)."""
    return is_adaptive(config) and lightglue.reads_host(lg_params, bucket0, bucket1,
                                                        config.lightglue, policy.act_dtype)


def resolve_device(device: Optional[str]) -> torch.device:
    """``None`` means the card; the CPU only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "MatcherSession runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev


class _Graph:
    """``body(*static inputs)`` captured in a CUDA graph at the first call and
    replayed at every call after the inputs are copied into the static
    buffers. ``pool``: a memory pool shared with other graphs (None: one of
    its own)."""

    def __init__(self, body: Callable, device: torch.device, pool=None):
        self.body, self.device, self.pool = body, device, pool
        self.graph = self.out = None
        self.static: Tuple[torch.Tensor, ...] = ()

    def __call__(self, *inputs: torch.Tensor):
        if self.graph is None:
            self.static = tuple(torch.empty(t.shape, dtype=t.dtype, device=self.device)
                                for t in inputs)
        for s, t in zip(self.static, inputs, strict=True):
            if s.shape != t.shape or s.dtype != t.dtype:
                raise ValueError(f"graph input {tuple(t.shape)} {t.dtype}, captured at "
                                 f"{tuple(s.shape)} {s.dtype}")
            s.copy_(t, non_blocking=True)
        if self.graph is None:
            self._capture()
        else:
            self.graph.replay()
        return self.out

    def _capture(self) -> None:
        # the first launches (the kernel library's build and load, the
        # launchers' one-time attribute and occupancy calls, the decision's
        # scratch) run eagerly, outside the capture
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self.body(*self.static)
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            out = self.body(*self.static)
        self.graph, self.out = graph, out
        graph.replay()


class _SplitGraph:
    """A match body with one host read in its middle as two graphs: ``head``
    (to the read, in a pool of its own: ``rest`` reads its state) and, per
    value of the flag it reads, ``rest`` (in ``pool``)."""

    def __init__(self, head: Callable, rest: Callable, read: Callable, device: torch.device,
                 pool):
        self.rest, self.read, self.device, self.pool = rest, read, device, pool
        self.first = _Graph(head, device)
        self.second: Dict[bool, _Graph] = {}

    def __call__(self, *inputs: torch.Tensor):
        state = self.first(*inputs)  # the same tensors at every replay
        flag = self.read(state)
        if flag not in self.second:
            self.second[flag] = _Graph(functools.partial(self.rest, state, flag), self.device,
                                       self.pool)
        return self.second[flag]()


class MatcherSession:
    """Holds device-resident weights and per-shape runners (CUDA graphs on a
    card)."""

    def __init__(
        self,
        sp_params=None,
        lg_params=None,
        config: PipelineConfig = PipelineConfig(),
        seed: int = 0,
        device: Optional[str] = None,
        compile_cache_dir: Optional[str] = None,
    ):
        """``compile_cache_dir``: where the kernel library is cached (JAX's
        argument of that name; here the built library is the artifact that
        a warm start reuses): None keeps the checkout's
        ``build/torch_kernels/``. A directory that cannot be used raises.
        The setting is the process's, not the session's
        (``aot.enable_compile_cache``)."""
        self.device = resolve_device(device)
        if compile_cache_dir is not None:
            from lightglue_tpu_torch.runtime import aot  # aot imports this module

            aot.enable_compile_cache(compile_cache_dir)
        self.config = config
        self.policy = policy_for(config.precision)
        sp_params = (
            weights_lib.init_superpoint(seed, config.superpoint)
            if sp_params is None else sp_params
        )
        lg_params = (
            weights_lib.init_lightglue(seed, config.lightglue)
            if lg_params is None else lg_params
        )
        # SuperPoint keeps fp32 master weights (cast per call, like the JAX
        # session's trace-time cast); LightGlue weights are cast once, or on
        # the INT8 rung quantized to int8 with fp32 per-channel scales and
        # NOT cast (JAX session.py:75-78): biases, LayerNorm, posenc and the
        # heads stay fp32, so INT8 is not BF16 with dequantized weights
        self.sp_params = weights_lib.params_from_numpy(sp_params, self.device)
        if self.policy.int8_weights:
            self.lg_params = weights_lib.params_from_numpy(
                quantize_lightglue(lg_params), self.device)
        else:
            self.lg_params = weights_lib.params_from_numpy(
                lg_params, self.device, self.policy.param_dtype
            )
        # runners replay CUDA graphs on a card, run the eager bodies on the CPU
        self._graphs = self.device.type == "cuda"
        self._match_pool = torch.cuda.graph_pool_handle() if self._graphs else None
        self._extract_cache: Dict[Tuple[int, int, int], Callable] = {}
        self._match_cache: Dict[Tuple[int, int, bool, int], Callable] = {}
        # aggregates input-validation failures so a caller sees every problem
        # with a bad batch at once
        self.errors = ErrorRecorder()

    # -- extraction ---------------------------------------------------------

    def _extract_eager(self, images: torch.Tensor) -> Extraction:
        """``extract_body`` on the session's weights: the body each
        extraction runner runs."""
        return extract_body(self.sp_params, images, config=self.config, policy=self.policy)

    def _extract_fn(self, batch: int, h: int, w: int) -> Callable[[np.ndarray], Extraction]:
        """The runner of (batch, h, w): host images in, the Extraction on the
        device out (a graph's static outputs, which its next call overwrites)."""
        key = (batch, h, w)
        if key not in self._extract_cache:
            if self._graphs:
                graph = _Graph(self._extract_eager, self.device)
                staging = torch.empty((batch, h, w, 1), dtype=torch.float32, pin_memory=True)
                copied = torch.cuda.Event()

                def run(images: np.ndarray) -> Extraction:
                    copied.synchronize()  # the last call's copy out of the staging buffer ran
                    staging.numpy()[...] = images
                    out = graph(staging)
                    copied.record()
                    return out

                run.graph = graph
            else:
                def run(images: np.ndarray) -> Extraction:
                    return self._extract_eager(torch.from_numpy(images).to(self.device))

            self._extract_cache[key] = run
        return self._extract_cache[key]

    def _extract(self, images: np.ndarray) -> Extraction:
        self.errors.clear()
        if images.ndim != 4 or images.shape[-1] != 1:
            self.errors.record(
                f"expected (B, H, W, 1) grayscale batch, got {images.shape}"
            )
        else:
            h, w = images.shape[1:3]
            if h % 8 or w % 8:
                self.errors.record(
                    f"H/W must be multiples of the stride-8 encoder, got {h}x{w}"
                )
            if images.dtype != np.float32:
                self.errors.record(f"expected float32 in [0, 1], got {images.dtype}")
        self.errors.raise_if_any("invalid extraction input", exc=ValueError)
        b, h, w, _ = images.shape
        with torch.inference_mode():
            return self._extract_fn(b, h, w)(np.ascontiguousarray(images))

    def extract(self, images: np.ndarray) -> Extraction:
        """images: (B, H, W, 1) float32 in [0, 1], H/W multiples of 8. The
        result is the caller's: a later call does not overwrite it."""
        ext = self._extract(images)
        if not self._graphs:
            return ext
        with torch.inference_mode():
            return Extraction(*(t.clone() for t in ext))

    # -- matching -----------------------------------------------------------

    def _match_eager(self, full: bool, kpts0, kpts1, desc0, desc1, count0, count1):
        """LightGlue and the match filter on one bucket pair: the body each
        match runner runs (``match_head``, the host read, ``match_rest`` on
        the session's weights)."""
        head = self._match_head(full, kpts0, kpts1, desc0, desc1, count0, count1)
        return self._match_rest(head, self._read(head))

    def _match_head(self, full: bool, kpts0, kpts1, desc0, desc1, count0, count1) -> dict:
        return match_head(self.lg_params, kpts0, kpts1, desc0, desc1, count0, count1,
                          config=self.config, policy=self.policy, full=full)

    def _read(self, head: dict) -> Optional[bool]:
        """The downshift's host read (None where the head has no flag)."""
        return bool(self._fetch(head["fits"])[0]) if "fits" in head else None

    def _match_rest(self, head: dict, fits: Optional[bool]):
        return match_rest(self.lg_params, head, fits, config=self.config, policy=self.policy)

    def _match_fn(self, bucket0: int, bucket1: int, full: bool = False, batch: int = 1):
        """The match runner of (bucket0, bucket1, full, batch).

        ``full``: every pair fills its bucket, so the unmasked variant runs.
        The JAX session's rules (session.py:144-163) normalize it: width
        pruning masks through its keep rows anyway, so it has no unmasked
        variant; adaptive depth-only has one at the cap bucket only, the
        only one ``warmup`` fills."""
        lgc = self.config.lightglue
        width = lgc.width_confidence > 0
        cap_full = bucket0 == bucket1 == max(self.config.buckets)
        full = full and not width and (cap_full if is_adaptive(self.config) else True)
        key = (bucket0, bucket1, full, batch)
        if key not in self._match_cache:
            if not self._graphs:
                run = functools.partial(self._match_eager, full)
            elif reads_host(self.lg_params, bucket0, bucket1, self.config, self.policy):
                run = _SplitGraph(functools.partial(self._match_head, full), self._match_rest,
                                  self._read, self.device, self._match_pool)
            else:
                run = _Graph(functools.partial(self._match_eager, full), self.device,
                             self._match_pool)
            self._match_cache[key] = run
        return self._match_cache[key]

    def _fetch(self, *tensors: torch.Tensor) -> List[np.ndarray]:
        """Device tensors as host arrays: through pinned memory allocated per
        call (a later call never overwrites them), one sync for all."""
        if self.device.type == "cpu":
            return [t.numpy() for t in tensors]
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return [h.numpy() for h in host]

    def _match(self, ext0: Extraction, ext1: Extraction):
        """Bucket, cut and match; returns ((host counts0, counts1), (out,
        matches)), the latter a graph's static outputs on a card."""
        # one device -> host fetch; every host value derives from it
        c0, c1 = self._fetch(ext0.count, ext1.count)
        b0 = self.config.bucket_for(max(int(c0.max()), 1))
        b1 = self.config.bucket_for(max(int(c1.max()), 1))
        # every pair fills its bucket -> the unmasked variant
        full = bool((c0 >= b0).all() and (c1 >= b1).all())
        run = self._match_fn(b0, b1, full, len(c0))
        with torch.inference_mode():
            res = run(ext0.keypoints_norm[:, :b0], ext1.keypoints_norm[:, :b1],
                      ext0.descriptors[:, :b0], ext1.descriptors[:, :b1],
                      ext0.count, ext1.count)
        return (c0, c1), res

    def match_from_extractions(self, ext0: Extraction, ext1: Extraction):
        """Bucket, pad-slice and run LightGlue on already-extracted features.

        Extractions are score-descending, so truncating to the bucket keeps
        the strongest keypoints. Returns (LightGlueOutput or AdaptiveOutput,
        Matches), match indices into the original keypoints; the caller's
        (a later call does not overwrite them)."""
        _, (out, matches) = self._match(ext0, ext1)
        if not self._graphs:
            return out, matches
        with torch.inference_mode():
            clone = lambda t: t.clone() if isinstance(t, torch.Tensor) else t  # noqa: E731
            return type(out)(*map(clone, out)), Matches(*map(clone, matches))

    # -- end-to-end ---------------------------------------------------------

    def match_pair(
        self,
        image0: np.ndarray,
        image1: np.ndarray,
        scales0: Optional[Tuple[float, float]] = None,
        scales1: Optional[Tuple[float, float]] = None,
    ) -> Dict:
        """Full pipeline on one image pair; returns host-side numpy results.

        image0/image1: (H, W, 1) float32 grayscale in [0, 1]. Same-shape
        images share one SuperPoint call. scales0/scales1: optional (sx, sy)
        resize scales; matched keypoints map back as (k + 0.5) / scale - 0.5.
        """
        if image0.shape == image1.shape:
            ext = self._extract(np.stack([image0, image1]))
            ext0, ext1 = ext.slice(0, 1), ext.slice(1, 2)
        else:
            ext0 = self._extract(image0[None])
            ext1 = self._extract(image1[None])
        (n0, n1), (out, matches) = self._match(ext0, ext1)
        with torch.inference_mode():
            count, idx, mscores, kpts0, kpts1, scores = self._fetch(
                matches.count[0], matches.indices[0], matches.scores[0], ext0.keypoints[0],
                ext1.keypoints[0], out.scores[0].float())
        count = int(count)
        idx, mscores = idx[:count], mscores[:count]
        if scales0 is not None:
            kpts0 = (kpts0 + 0.5) / np.asarray(scales0, np.float32) - 0.5
        if scales1 is not None:
            kpts1 = (kpts1 + 0.5) / np.asarray(scales1, np.float32) - 0.5
        return {
            "keypoints0": kpts0,
            "keypoints1": kpts1,
            "num_keypoints0": int(n0[0]),
            "num_keypoints1": int(n1[0]),
            "matches": idx,
            "match_scores": mscores,
            "matched_kpts0": kpts0[idx[:, 0]] if count else np.zeros((0, 2)),
            "matched_kpts1": kpts1[idx[:, 1]] if count else np.zeros((0, 2)),
            "scores": scores,
        }

    def match_batch(self, images0: np.ndarray, images1: np.ndarray) -> List[Dict]:
        """Batched full pipeline over B pairs of same-shape images: one
        SuperPoint call over the 2B images and one bucketed LightGlue call."""
        b = images0.shape[0]
        ext = self._extract(np.concatenate([images0, images1], axis=0))
        ext0, ext1 = ext.slice(0, b), ext.slice(b, 2 * b)
        (n0, n1), (_, matches) = self._match(ext0, ext1)
        with torch.inference_mode():
            counts, indices, scores, k0, k1 = self._fetch(
                matches.count, matches.indices, matches.scores, ext0.keypoints, ext1.keypoints)
        results = []
        for i in range(b):
            c = int(counts[i])
            idx = indices[i, :c]
            results.append(
                {
                    "keypoints0": k0[i],
                    "keypoints1": k1[i],
                    "num_keypoints0": int(n0[i]),
                    "num_keypoints1": int(n1[i]),
                    "matches": idx,
                    "match_scores": scores[i, :c],
                    "matched_kpts0": k0[i][idx[:, 0]] if c else np.zeros((0, 2)),
                    "matched_kpts1": k1[i][idx[:, 1]] if c else np.zeros((0, 2)),
                }
            )
        return results

    # -- warmup (the runners ahead of serving) ------------------------------

    def warmup(self, image_hw: Tuple[int, int], batch: int = 1, pairs=None) -> None:
        """Fill the extraction runner of (batch, H, W) and the match runners
        ahead of serving: on a card, capture their graphs (JAX session.py
        :341-389, which compiles its executables).

        ``pairs``: iterable of (bucket0, bucket1) to warm. Default: the
        diagonal only (mixed-bucket pairs are rare and captured at their
        first dispatch); "all" for the full product. Where (cap, cap) is
        warmed, the cap bucket's full (unmasked) variant is too: the
        dispatch of pairs that fill it, as ``_match_fn`` normalizes it.
        """
        h, w = image_hw
        with torch.inference_mode():
            self._extract_fn(batch, h, w)(np.zeros((batch, h, w, 1), np.float32))
        buckets = self.config.buckets
        if pairs is None:
            pairs = [(b, b) for b in buckets]
        elif pairs == "all":
            pairs = [(b0, b1) for b0 in buckets for b1 in buckets]
        pairs = list(pairs)
        cap = max(buckets)
        variants = [(b0, b1, False) for b0, b1 in pairs]
        if (cap, cap) in pairs:
            variants.append((cap, cap, True))
        dim = self.config.lightglue.input_dim
        dev = self.device
        with torch.inference_mode():
            for b0, b1, full in variants:
                self._match_fn(b0, b1, full, batch)(
                    torch.zeros((batch, b0, 2), device=dev),
                    torch.zeros((batch, b1, 2), device=dev),
                    torch.zeros((batch, b0, dim), device=dev),
                    torch.zeros((batch, b1, dim), device=dev),
                    torch.full((batch,), b0, dtype=torch.int32, device=dev),
                    torch.full((batch,), b1, dtype=torch.int32, device=dev),
                )
