"""Mutual-nearest-neighbour match filtering with static shapes.

Counterpart of ``lightglue_tpu/pipeline/match.py``: row/col argmax over the
log-assignment matrix, mutual check, exp(score) thresholding, and a
fixed-capacity (K, 2) match table ordered by confidence with a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Matches(NamedTuple):
    indices: torch.Tensor  # (B, K, 2) int32 [idx_in_image0, idx_in_image1]
    scores: torch.Tensor   # (B, K) fp32 exp'd match confidence (descending)
    mask: torch.Tensor     # (B, K) bool validity
    count: torch.Tensor    # (B,) int32 number of valid matches


def filter_matches(
    scores: torch.Tensor,
    threshold: float = 0.1,
    max_matches: int = 1024,
    mask0: Optional[torch.Tensor] = None,
) -> Matches:
    """Mutual-NN matches from a (B, M, N) log assignment matrix whose padded
    rows/columns already carry -inf-like scores."""
    _, m, _ = scores.shape
    max0_val, m0 = scores.max(dim=2)  # best col per row (first on ties)
    m1 = scores.argmax(dim=1)         # best row per col
    back = torch.gather(m1, 1, m0)
    mutual = back == torch.arange(m, device=scores.device)[None, :]

    probs = torch.exp(max0_val.float())
    mscores = torch.where(mutual, probs, 0.0)
    if mask0 is not None:
        mscores = torch.where(mask0, mscores, 0.0)
    valid = mscores > threshold

    k = min(max_matches, m)
    sel_scores, sel_rows = torch.topk(torch.where(valid, mscores, -1.0), k, dim=1)
    sel_cols = torch.gather(m0, 1, sel_rows)
    sel_valid = sel_scores > threshold
    count = sel_valid.sum(dim=-1, dtype=torch.int32)
    indices = torch.stack([sel_rows.int(), sel_cols.int()], dim=-1)
    indices = torch.where(sel_valid[..., None], indices, -1)
    return Matches(indices, sel_scores.clamp_min(0.0), sel_valid, count)
