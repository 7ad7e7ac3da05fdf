"""Non-maximum suppression for dense SuperPoint score maps.

- ``simple_nms``: the dense-map form (reference superpoint.py:52-69 via
  ``lightglue_tpu/kernels/nms.py:simple_nms``), plain PyTorch.
- ``nms_candidates``: counterpart of ``lightglue_tpu/kernels/nms.py:
  nms_candidates`` (wrapper :199, pallas_call :227): NMS + border mask +
  per-8x8-tile top-``cap`` candidates in one pass. On a CUDA tensor it
  launches ``csrc/nms.cu`` (see its header for the design and what bounds
  it); on a CPU tensor it runs ``nms_candidates_plain``. Both are the
  implementations of the operator ``lightglue_tpu_torch::nms_candidates``
  (``_build.define_op``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from lightglue_tpu_torch.kernels import _build

TILE = 8
# csrc/nms.cu's launch rule: a block takes a band of BAND rows x cols plus a
# 5r halo, and the kernel is built for radii 0..MAX_RADIUS
BAND = (32, 64)
MAX_RADIUS = 6


def nms_smem_bytes(radius: int) -> int:
    """Dynamic shared memory of one block (csrc/nms.cu:Band::smem, held
    equal by chip_smoke.py:plan_checks): two fp32 planes and one byte of
    flags per pixel of the haloed band, rows padded to an odd stride."""
    rows, cols = BAND[0] + 10 * radius, BAND[1] + 10 * radius
    return (2 * 4 + 1) * rows * (cols | 1)


def _max_pool_same(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 sliding max over the last two dims of (B, H, W); max_pool2d
    pads with -inf, the reference's SAME padding."""
    k = 2 * radius + 1
    return F.max_pool2d(x[:, None], k, stride=1, padding=radius)[:, 0]


def simple_nms(scores: torch.Tensor, nms_radius: int = 4) -> torch.Tensor:
    """Keep a pixel iff it is the max of its neighbourhood, with two rounds
    that re-admit maxima of the suppressed-score map. scores: (B, H, W)."""
    if nms_radius < 0:
        raise ValueError(f"nms_radius must be >= 0, got {nms_radius}")
    zeros = torch.zeros_like(scores)
    max_mask = scores == _max_pool_same(scores, nms_radius)
    for _ in range(2):
        supp_mask = _max_pool_same(max_mask.to(scores.dtype), nms_radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == _max_pool_same(supp_scores, nms_radius)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def nms_candidates_plain(
    scores: torch.Tensor, nms_radius: int = 4, border: int = 4, cap: int = 4
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``nms_candidates``, same outputs exactly."""
    _, h, w = scores.shape
    sc = simple_nms(scores.float(), nms_radius)
    row = torch.arange(h, device=sc.device)[:, None]
    col = torch.arange(w, device=sc.device)[None, :]
    inside = (row >= border) & (row < h - border) & (col >= border) & (col < w - border)
    sc = torch.where(inside, sc, torch.full_like(sc, -1.0))
    return tile_candidates(sc, cap)


def tile_candidates(
    masked: torch.Tensor, cap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-8x8-tile top-``cap`` of a (B, H, W) map by repeated max-and-mask:
    (B, TH*TW*cap) values and int32 flat indices y*W + x, tile-major /
    round-minor. ``max`` takes the first maximum and intra-tile order is
    flat-index order, so ties go to the smallest flat index."""
    b, h, w = masked.shape
    th, tw = h // TILE, w // TILE
    tiles = (
        masked.reshape(b, th, TILE, tw, TILE).permute(0, 1, 3, 2, 4)
        .reshape(b, th * tw, TILE * TILE).clone()
    )
    vals, args = [], []
    for _ in range(cap):
        v, a = tiles.max(dim=-1)
        vals.append(v)
        args.append(a)
        tiles.scatter_(-1, a[..., None], float("-inf"))
    cand_v = torch.stack(vals, dim=-1)  # (B, T, cap)
    cand_a = torch.stack(args, dim=-1)
    t = torch.arange(th * tw, device=masked.device)[None, :, None]
    gy = (t // tw) * TILE + cand_a // TILE
    gx = (t % tw) * TILE + cand_a % TILE
    cand_i = (gy * w + gx).to(torch.int32)
    return cand_v.reshape(b, -1), cand_i.reshape(b, -1)


def _nms_candidates_cuda(scores: torch.Tensor, nms_radius: int, border: int,
                         cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The operator's CUDA implementation: checks, then one launch."""
    b, h, w = scores.shape
    if h % TILE or w % TILE:
        raise ValueError(f"nms_candidates needs H, W multiples of 8, got {h}x{w}")
    # the kernel is instantiated for radii 0..MAX_RADIUS, all of whose bands
    # fit a block's shared memory (nms_smem_bytes(6) is 103,500 bytes)
    if not 0 <= nms_radius <= MAX_RADIUS or not 1 <= cap <= TILE * TILE:
        raise ValueError(f"nms_candidates: radius {nms_radius}, cap {cap}")
    x = scores.float().contiguous()
    n = (h // TILE) * (w // TILE) * cap
    cand_v = torch.empty((b, n), dtype=torch.float32, device=x.device)
    cand_i = torch.empty((b, n), dtype=torch.int32, device=x.device)
    err = _build.lib().lg_nms_candidates(
        x.data_ptr(), cand_v.data_ptr(), cand_i.data_ptr(), b, h, w,
        nms_radius, border, cap, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "nms_candidates")
    nms_candidates.launches += 1
    return cand_v, cand_i


def _nms_candidates_fake(scores, nms_radius, border, cap):
    b, h, w = scores.shape
    n = (h // TILE) * (w // TILE) * cap
    return (scores.new_empty((b, n), dtype=torch.float32),
            scores.new_empty((b, n), dtype=torch.int32))


_OP = _build.define_op(
    "nms_candidates(Tensor scores, int nms_radius, int border, int cap) -> (Tensor, Tensor)",
    cpu=nms_candidates_plain, cuda=_nms_candidates_cuda, fake=_nms_candidates_fake)


def nms_candidates(
    scores: torch.Tensor, nms_radius: int = 4, border: int = 4, cap: int = 4
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused simple_nms + border mask + per-8x8-tile top-``cap``.

    Args:
      scores: (B, H, W) raw (pre-NMS) scores; H % 8 == 0, W % 8 == 0.
    Returns:
      cand_v: (B, TH*TW*cap) fp32 candidate scores, tile-major / round-minor.
      cand_i: (B, TH*TW*cap) int32 flat indices y*W + x.
    """
    return _build.run(_OP, nms_candidates_plain, _nms_candidates_cuda, scores, nms_radius,
                      border, cap)


nms_candidates.launches = 0
