"""LightGlue transformer matcher in PyTorch: fixed depth and adaptive.

Counterpart of ``lightglue_tpu/models/lightglue.py:forward`` (:479-576): the
learnable Fourier positional encoding (tiled per half, paired with the
half-split RoPE the q/k weights are permuted into at load time), all layers
through ``kernels.layer_stack.transformer_stack``, and the last layer's
log-assignment head; and of ``forward_adaptive`` (:699-1168): adaptive
depth and width pruning on ``transformer_stack_adaptive``, the two-phase
downshift, and the per-layer loop that is the parity oracle. Layouts follow
the JAX package: (B, N, E) descriptors, (B, 2, N, D) freqs, (B,) lengths.

The per-block fallback the JAX package takes when the stack's gate fails
(N > 1024, N % 128 != 0, tensor parallelism) is queued for a later slice;
it raises here instead of falling back.
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


def _linear_maybe_batched(p, x: torch.Tensor) -> torch.Tensor:
    """Linear whose weights may carry a leading per-pair axis (B, in, out):
    each pair of an adaptive batch uses the head of the layer it exited at."""
    w = p["w"].to(x.dtype)
    if w.dim() == x.dim():
        return torch.bmm(x, w) + p["b"].to(x.dtype)[:, None, :]
    return _linear(p, x)


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
    md0 = _linear_maybe_batched(p["proj"], d0) / torch.tensor(scale, dtype=d0.dtype)
    md1 = _linear_maybe_batched(p["proj"], d1) / torch.tensor(scale, dtype=d1.dtype)
    sim = md0.float() @ md1.float().transpose(-1, -2)
    z0 = _linear_maybe_batched(p["match"], d0).float()  # (B, M, 1)
    z1 = _linear_maybe_batched(p["match"], d1).float()  # (B, N, 1)
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


def token_confidence(p, d0: torch.Tensor, d1: torch.Tensor):
    """Per-token confidence in [0, 1] (reference lightglue.py:87-99)."""
    return torch.sigmoid(_linear(p, d0))[..., 0], torch.sigmoid(_linear(p, d1))[..., 0]


def matchability(p, d: torch.Tensor) -> torch.Tensor:
    """sigmoid(matchability logit) (reference lightglue.py:260-262)."""
    return torch.sigmoid(_linear(p["match"], d).float())[..., 0]


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


def _require_stack(params, d0: torch.Tensor, d1: torch.Tensor) -> None:
    if not layer_stack.supports(params["layers"], d0.shape[1], d1.shape[1], d0.dtype):
        raise NotImplementedError(
            f"buckets {d0.shape[1]}x{d1.shape[1]} fail the layer-stack gate "
            "(multiples of 128, at most 1024); the per-block path is queued"
        )


def _embed(params, kpts0, kpts1, desc0, desc1, config, policy):
    d0 = desc0.to(policy.act_dtype)
    d1 = desc1.to(policy.act_dtype)
    if "input_proj" in params:  # non-SuperPoint features (input_dim != E)
        d0 = _linear(params["input_proj"], d0)
        d1 = _linear(params["input_proj"], d1)
    freqs0 = posenc(params["posenc"], kpts0.float(), config.head_dim)
    freqs1 = posenc(params["posenc"], kpts1.float(), config.head_dim)
    return d0, d1, freqs0, freqs1


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
    """Fixed-depth forward: all layers, last-layer assignment only. The
    depth/width knobs of ``config`` are not read (``forward_adaptive`` is
    the adaptive entry point, as in the JAX package).

    Args:
      params: the port's LightGlue tree (runtime/weights.py:params_from_numpy).
      kpts0/kpts1: (B, M, 2) / (B, N, 2) keypoints normalised to [-1, 1].
      desc0/desc1: (B, M, E) / (B, N, E) descriptors.
      lengths0/lengths1: optional (B,) true keypoint counts (bucketed pads).
    """
    with precision_scope(policy):
        d0, d1, freqs0, freqs1 = _embed(params, kpts0, kpts1, desc0, desc1, config, policy)
        _require_stack(params, d0, d1)
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


# ---------------------------------------------------------------------------
# adaptive depth + width pruning
# ---------------------------------------------------------------------------


class AdaptiveOutput(NamedTuple):
    scores: torch.Tensor      # (B, M, N) log assignment over *compacted* slots
    index0: torch.Tensor      # (B, M) int32 compacted slot -> original keypoint
    index1: torch.Tensor      # (B, N) int32
    lengths0: torch.Tensor    # (B,) int32 surviving keypoint counts
    lengths1: torch.Tensor    # (B,) int32
    exit_layer: torch.Tensor  # (B,) int32 1-based layer each pair exited at


def confidence_threshold(layer_index: int, n_layers: int) -> torch.Tensor:
    """Per-layer early-exit threshold clip(0.8 + 0.1 exp(-4 i / L), 0, 1),
    fp32 (upstream LightGlue's schedule)."""
    i = torch.tensor(float(layer_index))
    return torch.clamp(0.8 + 0.1 * torch.exp(-4.0 * i / n_layers), 0.0, 1.0)


def _compact(keep: torch.Tensor, *arrays):
    """Stable-partition kept tokens to the front: returns (new_length,
    gathered arrays). ``keep`` is (B, N) bool; arrays are (B, N), (B, N, C)
    or (B, 2, N, C) freqs."""
    order = torch.argsort((~keep).to(torch.uint8), dim=-1, stable=True)  # (B, N)
    new_len = keep.sum(-1, dtype=torch.int32)
    out = []
    for a in arrays:
        if a.dim() == 2:
            out.append(torch.gather(a, 1, order))
        elif a.dim() == 3:
            out.append(torch.gather(a, 1, order[..., None].expand(-1, -1, a.shape[-1])))
        else:
            idx = order[:, None, :, None].expand(-1, a.shape[1], -1, a.shape[-1])
            out.append(torch.gather(a, 2, idx))
    return new_len, out


def _layer(tree, i):
    """One layer's leaves (``i`` an int, or a (B,) index tensor: per pair)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _slice(tree, lo, hi):
    return {k: _slice(v, lo, hi) if isinstance(v, dict) else v[lo:hi] for k, v in tree.items()}


def forward_adaptive(
    params,
    kpts0: torch.Tensor,
    kpts1: torch.Tensor,
    desc0: torch.Tensor,
    desc1: torch.Tensor,
    lengths0: torch.Tensor,
    lengths1: torch.Tensor,
    *,
    config: LightGlueConfig,
    policy: DTypePolicy,
    force_loop: bool = False,
    full: bool = False,
) -> AdaptiveOutput:
    """Adaptive-depth + keypoint-pruning forward, entirely on the device.

    Upstream LightGlue's ``depth_confidence`` / ``width_confidence``: after
    layer i a pair stops when its share of confident tokens exceeds
    ``depth_confidence``; tokens that are confident and not matchable are
    pruned. Each pair's assignment uses the head of the layer it exited at.

    The main path runs ``transformer_stack_adaptive`` (exit register and
    keep masks on the device, one compaction at the end; with
    ``downshift_layer`` the two-phase ``_adaptive_downshift``).
    ``force_loop=True`` runs the per-layer oracle instead: the JAX
    while-loop of ``_forward_adaptive_impl`` (:904-1045) with a compaction
    after every layer, on ``transformer_stack`` one layer at a time. It runs
    all layers (a pair that stopped is frozen) instead of ending when every
    pair has stopped, which needs no host read and gives the same result.

    Args:
      lengths0/lengths1: (B,) true keypoint counts (the session always
        passes them).
      full: every pair fills its bucket; depth-only then runs the unmasked
        variant of the stack.
    """
    with precision_scope(policy):
        d0, d1, freqs0, freqs1 = _embed(params, kpts0, kpts1, desc0, desc1, config, policy)
        _require_stack(params, d0, d1)
        b, m, n = d0.shape[0], d0.shape[1], d1.shape[1]
        lengths0 = lengths0.to(d0.device, torch.int32)
        lengths1 = lengths1.to(d0.device, torch.int32)
        idx0 = torch.arange(m, dtype=torch.int32, device=d0.device).expand(b, m)
        idx1 = torch.arange(n, dtype=torch.int32, device=d0.device).expand(b, n)
        args = (params, d0, d1, freqs0, freqs1, lengths0, lengths1, idx0, idx1)
        do_depth = config.depth_confidence > 0
        do_width = config.width_confidence > 0
        if force_loop or not (do_depth or do_width):
            final = _adaptive_loop(*args, config=config, policy=policy)
        elif do_width and _use_downshift(params, m, n, config, d0.dtype):
            final = _adaptive_downshift(*args, config=config, policy=policy)
        else:
            final = _adaptive_single(*args, config=config, policy=policy, full=full)
        return _adaptive_tail(params, final, m, n, config)


def _stack_kw(config, policy, **extra):
    return dict(num_heads=config.num_heads, head_dim=config.head_dim,
                stat_dtype=policy.attn_stat_dtype, attn_dtype=policy.attn_in_dtype, **extra)


def _depth_arg(config) -> float:
    # width without depth rides the same stack: 2.0 is never reached, so
    # only the last layer forces the exit
    return float(config.depth_confidence) if config.depth_confidence > 0 else 2.0


def _use_downshift(params, m, n, config, act_dtype) -> bool:
    ds = int(config.downshift_layer)
    return (0 < ds <= config.n_layers - 2 and m == n and (m // 2) % 128 == 0
            and layer_stack.supports(params["layers"], m // 2, m // 2, act_dtype))


def _adaptive_single(params, d0, d1, freqs0, freqs1, lengths0, lengths1, idx0, idx1, *,
                     config, policy, full):
    """One call of the adaptive stack; with width, one tail compaction."""
    width = config.width_confidence > 0
    out = layer_stack.transformer_stack_adaptive(
        params["layers"], params["token"], d0, d1, freqs0, freqs1, lengths0, lengths1,
        params["assign"]["match"] if width else None,
        **_stack_kw(config, policy, depth_confidence=_depth_arg(config),
                    width_confidence=float(config.width_confidence),
                    masked=width or not full))
    if not width:
        return dict(d0=out[0], d1=out[1], len0=lengths0, len1=lengths1,
                    idx0=idx0, idx1=idx1, exit_layer=out[2])
    fd0, fd1, exit_layer, keep0, keep1 = out
    nl0, (cd0, cidx0) = _compact(keep0 > 0.5, fd0, idx0)
    nl1, (cd1, cidx1) = _compact(keep1 > 0.5, fd1, idx1)
    return dict(d0=cd0, d1=cd1, len0=nl0, len1=nl1, idx0=cidx0, idx1=cidx1,
                exit_layer=exit_layer)


def _adaptive_downshift(params, d0, d1, freqs0, freqs1, lengths0, lengths1, idx0, idx1, *,
                        config, policy):
    """Two-phase adaptive forward with the bucket-ladder downshift
    (``lightglue_tpu/models/lightglue.py:_adaptive_downshift``).

    Phase 1 runs layers [0, ds) at full width; the survivors are compacted;
    phase 2 runs layers [ds, L) at half width when every pair's survivors
    fit N/2, else at full width. Choosing the arm is the one host read of
    the adaptive path (the JAX package's ``lax.cond`` on ``fits``), once
    per call; nothing is read back per layer.

    Phase 2 takes phase 1's exit values as they are: a pair that exited in
    phase 1 is dead at every global layer of phase 2. The JAX kernel passes
    a 0/1 flag instead and tests liveness against its LOCAL layer index, so
    a pair that meets the depth criterion inside phase 2 runs on and is
    overwritten by the forced last-layer exit; this port follows the
    ``force_loop`` oracle (ROADMAP queue 3).
    """
    ds, n_layers, m = int(config.downshift_layer), config.n_layers, d0.shape[1]
    half = m // 2
    tok, match = params["token"], params["assign"]["match"]
    kw = _stack_kw(config, policy, depth_confidence=_depth_arg(config),
                   width_confidence=float(config.width_confidence), total_layers=n_layers)

    fd0, fd1, exit1, kf0, kf1 = layer_stack.transformer_stack_adaptive(
        _slice(params["layers"], 0, ds), _slice(tok, 0, ds), d0, d1, freqs0, freqs1,
        lengths0, lengths1, _slice(match, 0, ds), **kw)
    nl0, (cd0, cf0, cidx0) = _compact(kf0 > 0.5, fd0, freqs0, idx0)
    nl1, (cd1, cf1, cidx1) = _compact(kf1 > 0.5, fd1, freqs1, idx1)
    fits = bool(((nl0 <= half) & (nl1 <= half)).all())  # the one host read
    w = half if fits else m
    o0, o1, exit_layer, k0, k1 = layer_stack.transformer_stack_adaptive(
        _slice(params["layers"], ds, n_layers), _slice(tok, ds, n_layers - 1),
        cd0[:, :w].contiguous(), cd1[:, :w].contiguous(), cf0[:, :, :w], cf1[:, :, :w],
        nl0, nl1, _slice(match, ds, n_layers), exit1, layer_offset=ds, **kw)
    if fits:  # back to the bucket: padded slots are never kept
        o0, o1 = (F.pad(t, (0, 0, 0, m - half)) for t in (o0, o1))
        k0, k1 = (F.pad(t, (0, m - half)) for t in (k0, k1))
    fl0, (gd0, gidx0) = _compact(k0 > 0.5, o0, cidx0)
    fl1, (gd1, gidx1) = _compact(k1 > 0.5, o1, cidx1)
    return dict(d0=gd0, d1=gd1, len0=fl0, len1=fl1, idx0=gidx0, idx1=gidx1,
                exit_layer=exit_layer)


def _adaptive_loop(params, d0, d1, freqs0, freqs1, lengths0, lengths1, idx0, idx1, *,
                   config, policy):
    """The per-layer oracle (JAX ``_forward_adaptive_impl`` :904-1045)."""
    n_layers = config.n_layers
    do_depth = config.depth_confidence > 0
    do_width = config.width_confidence > 0
    b, m, n = d0.shape[0], d0.shape[1], d1.shape[1]
    dev = d0.device
    len0, len1 = lengths0, lengths1
    stopped = torch.zeros(b, dtype=torch.bool, device=dev)
    exit_layer = torch.full((b,), n_layers, dtype=torch.int32, device=dev)
    kw = _stack_kw(config, policy)
    for i in range(n_layers):
        nd0, nd1 = layer_stack.transformer_stack(_slice(params["layers"], i, i + 1),
                                                 d0, d1, freqs0, freqs1, len0, len1, **kw)
        live = ~stopped  # freeze pairs that already exited
        nd0 = torch.where(live[:, None, None], nd0, d0)
        nd1 = torch.where(live[:, None, None], nd1, d1)
        mask0, mask1 = _masks_from_lengths(len0, len1, m, n)
        is_last = i == n_layers - 1
        if do_depth or do_width:
            c0, c1 = token_confidence(_layer(params["token"], min(i, n_layers - 2)), nd0, nd1)
            th = confidence_threshold(i, n_layers).to(dev)
        if do_depth:
            conf = ((c0 >= th) & mask0).float().sum(-1) + ((c1 >= th) & mask1).float().sum(-1)
            ratio = conf / (len0 + len1).float().clamp_min(1.0)
            stop_now = live & ((ratio > config.depth_confidence) | is_last)
        else:
            stop_now = live & is_last
        exit_layer = torch.where(stop_now, i + 1, exit_layer).to(torch.int32)
        stopped = stopped | stop_now
        if do_width:
            assign_p = _layer(params["assign"], i)
            keep0 = ((matchability(assign_p, nd0) > 1 - config.width_confidence)
                     | (c0 <= th)) & mask0
            keep1 = ((matchability(assign_p, nd1) > 1 - config.width_confidence)
                     | (c1 <= th)) & mask1
            # pairs that just stopped (or had stopped) keep everything
            keep0 = keep0 | (stopped[:, None] & mask0)
            keep1 = keep1 | (stopped[:, None] & mask1)
            # compacting an all-kept prefix is the identity, so the loop
            # compacts every layer and never asks whether anything was pruned
            len0, (nd0, freqs0, idx0) = _compact(keep0, nd0, freqs0, idx0)
            len1, (nd1, freqs1, idx1) = _compact(keep1, nd1, freqs1, idx1)
        d0, d1 = nd0, nd1
    return dict(d0=d0, d1=d1, len0=len0, len1=len1, idx0=idx0, idx1=idx1,
                exit_layer=exit_layer)


def _adaptive_tail(params, final, m, n, config) -> AdaptiveOutput:
    """Per-pair assignment head of the exit layer and output packing."""
    exit_idx = (final["exit_layer"].long() - 1).clamp(0, config.n_layers - 1)
    assign_p = _layer(params["assign"], exit_idx)  # (B, in, out) per pair
    mask0, mask1 = _masks_from_lengths(final["len0"], final["len1"], m, n)
    scores = match_assignment(assign_p, final["d0"], final["d1"], mask0, mask1,
                              config.descriptor_dim)
    return AdaptiveOutput(scores, final["idx0"], final["idx1"], final["len0"],
                          final["len1"], final["exit_layer"])
