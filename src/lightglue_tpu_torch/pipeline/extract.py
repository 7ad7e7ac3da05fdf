"""Device-side keypoint extraction with static shapes.

Counterpart of ``lightglue_tpu/pipeline/extract.py``: border mask ->
threshold -> top-k -> bilinear descriptor sampling -> L2 normalisation ->
coordinate normalisation, with a fixed capacity k and validity masks
instead of dynamic shapes. On the ``raw_scores`` hot path NMS, border and
per-tile candidates run fused in ``kernels.nms.nms_candidates``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from lightglue_tpu_torch.config import SuperPointConfig
from lightglue_tpu_torch.kernels.nms import nms_candidates, simple_nms, tile_candidates


class Extraction(NamedTuple):
    keypoints: torch.Tensor       # (B, K, 2) pixel (x, y), fp32; junk beyond count
    keypoints_norm: torch.Tensor  # (B, K, 2) normalized to [-1, 1] for LightGlue
    descriptors: torch.Tensor     # (B, K, 256) L2-normalized, fp32
    scores: torch.Tensor          # (B, K) detection scores (descending)
    mask: torch.Tensor            # (B, K) bool validity
    count: torch.Tensor           # (B,) int32 number of valid keypoints

    def slice(self, start: int, stop: int) -> "Extraction":
        """The batch rows [start, stop) of every field."""
        return Extraction(*(t[start:stop] for t in self))


def mask_borders(scores: torch.Tensor, border: int) -> torch.Tensor:
    """Set a border frame of (B, H, W) scores to -1."""
    _, h, w = scores.shape
    row = torch.arange(h, device=scores.device)[None, :, None]
    col = torch.arange(w, device=scores.device)[None, None, :]
    inside = (row >= border) & (row < h - border) & (col >= border) & (col < w - border)
    return torch.where(inside, scores, -1.0)


def sample_descriptors(
    keypoints: torch.Tensor, desc_map: torch.Tensor, s: int = 8
) -> torch.Tensor:
    """Bilinear descriptor sampling at keypoints, grid_sample(align_corners=
    True) composed with the reference's coordinate transform; returns
    (B, K, C) L2-normalised descriptors.

    keypoints: (B, K, 2) pixel (x, y); desc_map: (B, h, w, C) stride-s grid."""
    b, h, w, c = desc_map.shape
    off = s / 2.0 - 0.5
    px = ((keypoints[..., 0] - off) / (w * s - s / 2.0 - 0.5) * (w - 1)).clamp(0.0, w - 1.0)
    py = ((keypoints[..., 1] - off) / (h * s - s / 2.0 - 0.5) * (h - 1)).clamp(0.0, h - 1.0)
    x0 = torch.floor(px).long().clamp(0, w - 2)
    y0 = torch.floor(py).long().clamp(0, h - 2)
    fx = (px - x0)[..., None]
    fy = (py - y0)[..., None]
    flat = desc_map.reshape(b, h * w, c)

    def gather(yy, xx):
        idx = (yy * w + xx)[..., None].expand(-1, -1, c)
        return torch.gather(flat, 1, idx)

    desc = (
        gather(y0, x0) * (1 - fy) * (1 - fx)
        + gather(y0, x0 + 1) * (1 - fy) * fx
        + gather(y0 + 1, x0) * fy * (1 - fx)
        + gather(y0 + 1, x0 + 1) * fy * fx
    )
    return desc * torch.rsqrt((desc * desc).sum(dim=-1, keepdim=True) + 1e-12)


def _topk_candidates(
    cand_v: torch.Tensor, cand_i: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a candidate list, chunked two-stage: per-chunk top-k,
    then a top-k over the shortlist. Tie order at the k-th value may differ
    from a single-stage sort (as in the reference)."""
    b, ncand = cand_v.shape
    chunks = 4
    if ncand % chunks == 0 and ncand // chunks >= k:
        sv, ss = torch.topk(cand_v.reshape(b * chunks, ncand // chunks), k, dim=1)
        si = torch.gather(cand_i.reshape(b * chunks, ncand // chunks), 1, ss)
        cand_v, cand_i = sv.reshape(b, chunks * k), si.reshape(b, chunks * k)
    top_v, sel = torch.topk(cand_v, k, dim=1)
    return top_v, torch.gather(cand_i, 1, sel)


def _topk_nms_tiled(
    masked: torch.Tensor, k: int, cap: int = 4
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over an NMS'd map via per-8x8-tile top-``cap`` candidates
    (NMS radius >= 4 leaves at most ``cap`` survivors per tile)."""
    return _topk_candidates(*tile_candidates(masked, cap), k)


def normalize_keypoints(keypoints: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(x, y) pixels -> [-1, 1] by max(h, w)/2 around the image center.

    The center and the scale are filled on the device (no host-to-device
    copy, so a CUDA graph can capture it); both are exact in fp32, and the
    division is by a tensor, as the JAX package divides."""
    dev = keypoints.device
    center = torch.full((2,), width / 2.0, dtype=torch.float32, device=dev)
    center[1:].fill_(height / 2.0)
    scale = torch.full((), max(width, height) / 2.0, dtype=torch.float32, device=dev)
    return (keypoints - center) / scale


def extract_keypoints(
    scores: torch.Tensor,
    desc_map: torch.Tensor,
    *,
    config: SuperPointConfig = SuperPointConfig(),
    k: int | None = None,
    raw_scores: bool = False,
) -> Extraction:
    """Select top-k keypoints from a dense score map, device-side.

    Args:
      scores: (B, H, W) from ``models.superpoint.forward``: NMS'd, or raw
        (``forward(..., nms=False)``) with ``raw_scores=True``, in which case
        NMS + border + tile candidates run in ``nms_candidates``.
      desc_map: (B, H/8, W/8, C) dense descriptors from the same forward.
      k: fixed keypoint capacity (defaults to config.max_num_keypoints).
    """
    k = k or config.max_num_keypoints
    b, h, w = scores.shape
    tile, cap = 8, 4
    tiled_ok = (
        config.detection_threshold > 0
        and config.nms_radius >= tile // 2
        and h % tile == 0
        and w % tile == 0
        and (h // tile) * (w // tile) * cap >= k
    )
    if raw_scores and tiled_ok:
        cand_v, cand_i = nms_candidates(
            scores, nms_radius=config.nms_radius, border=config.remove_borders, cap=cap
        )
        top_scores, top_idx = _topk_candidates(cand_v, cand_i, k)
    else:
        if raw_scores:
            scores = simple_nms(scores, config.nms_radius)
        masked = mask_borders(scores.float(), config.remove_borders)
        if tiled_ok:
            top_scores, top_idx = _topk_nms_tiled(masked, k, cap)
        else:
            top_scores, top_idx = torch.topk(masked.reshape(b, h * w), k, dim=1)
    ys = (top_idx // w).float()
    xs = (top_idx % w).float()
    kpts = torch.stack([xs, ys], dim=-1)  # (x, y), column first

    valid = top_scores > config.detection_threshold
    count = valid.sum(dim=-1, dtype=torch.int32)

    desc = sample_descriptors(kpts, desc_map, config.stride)
    kpts_norm = normalize_keypoints(kpts, h, w)
    # keep padded slots harmless: zero descriptors, coordinates at the center
    desc = torch.where(valid[..., None], desc, 0.0)
    kpts_norm = torch.where(valid[..., None], kpts_norm, 0.0)
    return Extraction(kpts, kpts_norm, desc, top_scores, valid, count)
