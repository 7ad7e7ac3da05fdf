"""Single-host inference session: bucketed end-to-end match on one card.

Counterpart of ``lightglue_tpu/runtime/session.py:MatcherSession``. It runs
the same two steps — extract (SuperPoint + keypoint selection) and match
(LightGlue + mutual-NN filtering) — eagerly in PyTorch, with each pair
padded to the smallest keypoint bucket that holds it. The host round trips
are reading the two keypoint counts that pick the bucket and, for an
adaptive config with the downshift, the one read that picks phase 2's
width. There is no jit cache and no compile cache: the kernels are built
once per checkout (kernels/_build.py).

An adaptive config (``depth_confidence`` / ``width_confidence`` > 0) runs
``lightglue.forward_adaptive`` and maps match rows and columns, which index
compacted (pruned) slots, back to the original keypoint indices on the
device.

Every precision rung runs on the card (``config.precision``): FP32, MIXED
(fp32 activations and statistics, bf16 products: the kernels' mixed
instantiations), BF16 and INT8 (``quant.quantize_lightglue``: int8 weights
with fp32 per-channel scales, bf16 activations; the layer stack's GEMM
dequantizes while it stages the weights, or with ``LGTPU_W8A8=1`` runs
int8 x int8 products on row-quantized activations).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from lightglue_tpu_torch.config import PipelineConfig
from lightglue_tpu_torch.models import lightglue, superpoint
from lightglue_tpu_torch.pipeline.extract import Extraction, extract_keypoints
from lightglue_tpu_torch.pipeline.match import Matches, filter_matches
from lightglue_tpu_torch.precision import policy_for
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


def resolve_device(device: Optional[str]) -> torch.device:
    """``None`` means the card; the CPU only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "MatcherSession runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev


class MatcherSession:
    """Holds device-resident weights and runs the bucketed pipeline."""

    def __init__(
        self,
        sp_params=None,
        lg_params=None,
        config: PipelineConfig = PipelineConfig(),
        seed: int = 0,
        device: Optional[str] = None,
    ):
        self.device = resolve_device(device)
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
        # aggregates input-validation failures so a caller sees every problem
        # with a bad batch at once
        self.errors = ErrorRecorder()

    # -- extraction ---------------------------------------------------------

    def extract(self, images: np.ndarray) -> Extraction:
        """images: (B, H, W, 1) float32 in [0, 1], H/W multiples of 8."""
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
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        with torch.inference_mode():
            scores, desc = superpoint.forward(
                self.sp_params, x, config=self.config.superpoint,
                policy=self.policy, nms=False,
            )
            return extract_keypoints(
                scores, desc, config=self.config.superpoint, raw_scores=True
            )

    # -- matching -----------------------------------------------------------

    def match_from_extractions(self, ext0: Extraction, ext1: Extraction):
        """Bucket, pad-slice and run LightGlue on already-extracted features.

        Extractions are score-descending, so truncating to the bucket keeps
        the strongest keypoints. Returns (LightGlueOutput or AdaptiveOutput,
        Matches), match indices into the original keypoints."""
        # two device -> host fetches; every host value derives from them
        c0 = ext0.count.cpu().numpy()
        c1 = ext1.count.cpu().numpy()
        b0 = self.config.bucket_for(max(int(c0.max()), 1))
        b1 = self.config.bucket_for(max(int(c1.max()), 1))
        # every pair fills its bucket -> the unmasked variant
        full = bool((c0 >= b0).all() and (c1 >= b1).all())
        lgc = self.config.lightglue
        adaptive = lgc.depth_confidence > 0 or lgc.width_confidence > 0
        lengths0 = torch.clamp(ext0.count, max=b0)
        lengths1 = torch.clamp(ext1.count, max=b1)
        inputs = (ext0.keypoints_norm[:, :b0], ext1.keypoints_norm[:, :b1],
                  ext0.descriptors[:, :b0], ext1.descriptors[:, :b1])
        with torch.inference_mode():
            if adaptive:
                # the JAX session's rules (session.py:144-162): adaptive always
                # passes lengths; the unmasked variant exists for depth-only
                # and is used at the cap bucket only
                full = (full and lgc.width_confidence <= 0
                        and b0 == b1 == max(self.config.buckets))
                out = lightglue.forward_adaptive(
                    self.lg_params, *inputs, lengths0, lengths1,
                    config=lgc, policy=self.policy, full=full)
            else:
                out = lightglue.forward(
                    self.lg_params, *inputs,
                    None if full else lengths0, None if full else lengths1,
                    config=lgc, policy=self.policy)
            matches = filter_matches(
                out.scores,
                threshold=self.config.match_threshold,
                max_matches=min(self.config.max_matches, b0),
            )
            if adaptive:
                matches = _remap(matches, out.index0, out.index1)
        return out, matches

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
            ext = self.extract(np.stack([image0, image1]))
            ext0, ext1 = ext.slice(0, 1), ext.slice(1, 2)
        else:
            ext0 = self.extract(image0[None])
            ext1 = self.extract(image1[None])
        out, matches = self.match_from_extractions(ext0, ext1)
        count = int(matches.count[0])
        idx = matches.indices[0, :count].cpu().numpy()
        kpts0 = ext0.keypoints[0].cpu().numpy()
        kpts1 = ext1.keypoints[0].cpu().numpy()
        if scales0 is not None:
            kpts0 = (kpts0 + 0.5) / np.asarray(scales0, np.float32) - 0.5
        if scales1 is not None:
            kpts1 = (kpts1 + 0.5) / np.asarray(scales1, np.float32) - 0.5
        return {
            "keypoints0": kpts0,
            "keypoints1": kpts1,
            "num_keypoints0": int(ext0.count[0]),
            "num_keypoints1": int(ext1.count[0]),
            "matches": idx,
            "match_scores": matches.scores[0, :count].cpu().numpy(),
            "matched_kpts0": kpts0[idx[:, 0]] if count else np.zeros((0, 2)),
            "matched_kpts1": kpts1[idx[:, 1]] if count else np.zeros((0, 2)),
            "scores": out.scores[0].float().cpu().numpy(),
        }

    def match_batch(self, images0: np.ndarray, images1: np.ndarray) -> List[Dict]:
        """Batched full pipeline over B pairs of same-shape images: one
        SuperPoint call over the 2B images and one bucketed LightGlue call."""
        b = images0.shape[0]
        ext = self.extract(np.concatenate([images0, images1], axis=0))
        ext0, ext1 = ext.slice(0, b), ext.slice(b, 2 * b)
        _, matches = self.match_from_extractions(ext0, ext1)
        counts = matches.count.cpu().numpy()
        indices = matches.indices.cpu().numpy()
        scores = matches.scores.cpu().numpy()
        k0 = ext0.keypoints.cpu().numpy()
        k1 = ext1.keypoints.cpu().numpy()
        n0 = ext0.count.cpu().numpy()
        n1 = ext1.count.cpu().numpy()
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
