"""LightGlue transformer matcher in PyTorch, fixed depth.

Counterpart of ``lightglue_tpu/models/lightglue.py:forward`` (:479-576): the
learnable Fourier positional encoding (tiled per half, paired with the
half-split RoPE the q/k weights are permuted into at load time), all layers
through ``kernels.layer_stack.transformer_stack``, and the last layer's
log-assignment head. Layouts follow the JAX package: (B, N, E)
descriptors, (B, 2, N, D) freqs, (B,) lengths.

The per-block fallback the JAX package takes when the stack's gate fails
(N > 1024, N % 128 != 0, tensor parallelism) and adaptive depth/width are
queued for later slices; they raise here instead of falling back.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from lightglue_tpu_torch.config import LightGlueConfig
from lightglue_tpu_torch.kernels import layer_stack
from lightglue_tpu_torch.precision import DTypePolicy, precision_scope

_NEG_INF = -1e30


def _linear(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


def posenc(p, kpts: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Learnable Fourier positional encoding -> (B, 2, N, head_dim), the
    frequencies tiled ([f0..f31, f0..f31]) for half-split RoPE."""
    projected = kpts @ p["wr"].float()  # (B, N, head_dim // 2)
    emb = torch.stack([torch.cos(projected), torch.sin(projected)], dim=1)
    return torch.cat([emb, emb], dim=-1)


def match_assignment(
    p,
    d0: torch.Tensor,
    d1: torch.Tensor,
    mask0: Optional[torch.Tensor],
    mask1: Optional[torch.Tensor],
    dim: int,
) -> torch.Tensor:
    """Log assignment matrix: log_softmax(sim, cols) + log_softmax(sim, rows)
    + logsigmoid(z0) + logsigmoid(z1)^T, with padded rows/columns at -1e30.

    Projections stay in the activation dtype; sim accumulates in fp32 and the
    softmax math runs in fp32."""
    scale = float(dim) ** 0.25
    md0 = _linear(p["proj"], d0) / torch.tensor(scale, dtype=d0.dtype)
    md1 = _linear(p["proj"], d1) / torch.tensor(scale, dtype=d1.dtype)
    sim = md0.float() @ md1.float().transpose(-1, -2)
    z0 = _linear(p["match"], d0).float()  # (B, M, 1)
    z1 = _linear(p["match"], d1).float()  # (B, N, 1)
    certainties = F.logsigmoid(z0) + F.logsigmoid(z1).transpose(-1, -2)
    if mask1 is not None:
        sim = torch.where(mask1[:, None, :], sim, _NEG_INF)
    scores0 = F.log_softmax(sim, dim=2)
    if mask0 is not None:
        sim = torch.where(mask0[:, :, None], sim, _NEG_INF)
    scores1 = F.log_softmax(sim, dim=1)
    scores = scores0 + scores1 + certainties
    if mask0 is not None:
        scores = torch.where(mask0[:, :, None], scores, _NEG_INF)
    if mask1 is not None:
        scores = torch.where(mask1[:, None, :], scores, _NEG_INF)
    return scores


class LightGlueOutput(NamedTuple):
    desc0: torch.Tensor         # (B, M, E) final descriptors, image 0
    desc1: torch.Tensor         # (B, N, E) final descriptors, image 1
    scores: torch.Tensor        # (B, M, N) log assignment matrix
    n_layers_run: torch.Tensor  # scalar: layers executed


def _masks_from_lengths(lengths0, lengths1, m: int, n: int):
    mask0 = None if lengths0 is None else (
        torch.arange(m, device=lengths0.device)[None, :] < lengths0[:, None]
    )
    mask1 = None if lengths1 is None else (
        torch.arange(n, device=lengths1.device)[None, :] < lengths1[:, None]
    )
    return mask0, mask1


def forward(
    params,
    kpts0: torch.Tensor,
    kpts1: torch.Tensor,
    desc0: torch.Tensor,
    desc1: torch.Tensor,
    lengths0: Optional[torch.Tensor] = None,
    lengths1: Optional[torch.Tensor] = None,
    *,
    config: LightGlueConfig,
    policy: DTypePolicy,
) -> LightGlueOutput:
    """Fixed-depth forward: all layers, last-layer assignment only.

    Args:
      params: the port's LightGlue tree (runtime/weights.py:params_from_numpy).
      kpts0/kpts1: (B, M, 2) / (B, N, 2) keypoints normalised to [-1, 1].
      desc0/desc1: (B, M, E) / (B, N, E) descriptors.
      lengths0/lengths1: optional (B,) true keypoint counts (bucketed pads).
    """
    if config.depth_confidence > 0 or config.width_confidence > 0:
        raise NotImplementedError("adaptive depth/width is queued for a later slice")
    with precision_scope(policy):
        d0 = desc0.to(policy.act_dtype)
        d1 = desc1.to(policy.act_dtype)
        if "input_proj" in params:  # non-SuperPoint features (input_dim != E)
            d0 = _linear(params["input_proj"], d0)
            d1 = _linear(params["input_proj"], d1)
        freqs0 = posenc(params["posenc"], kpts0.float(), config.head_dim)
        freqs1 = posenc(params["posenc"], kpts1.float(), config.head_dim)
        if not layer_stack.supports(params["layers"], d0.shape[1], d1.shape[1], d0.dtype):
            raise NotImplementedError(
                f"buckets {d0.shape[1]}x{d1.shape[1]} fail the layer-stack gate "
                "(multiples of 128, at most 1024); the per-block path is queued"
            )
        d0, d1 = layer_stack.transformer_stack(
            params["layers"], d0, d1, freqs0, freqs1, lengths0, lengths1,
            num_heads=config.num_heads,
            head_dim=config.head_dim,
            stat_dtype=policy.attn_stat_dtype,
            attn_dtype=policy.attn_in_dtype,
        )
        mask0, mask1 = _masks_from_lengths(lengths0, lengths1, kpts0.shape[1], kpts1.shape[1])
        last_assign = {k: {kk: vv[-1] for kk, vv in v.items()}
                       for k, v in params["assign"].items()}
        scores = match_assignment(last_assign, d0, d1, mask0, mask1, config.descriptor_dim)
    return LightGlueOutput(d0, d1, scores, torch.tensor(config.n_layers))
