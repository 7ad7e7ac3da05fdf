"""LightGlue transformer matcher in PyTorch: fixed depth and adaptive.

Counterpart of ``lightglue_tpu/models/lightglue.py:forward`` (:479-576): the
learnable Fourier positional encoding (tiled per half, paired with the
half-split RoPE the q/k weights are permuted into at load time), the layers,
and the last layer's log-assignment head; and of ``forward_adaptive``
(:699-1168): adaptive depth and width pruning on
``transformer_stack_adaptive``, the two-phase downshift, and the per-layer
loop that is the parity oracle. Layouts follow the JAX package: (B, N, E)
descriptors, (B, 2, N, D) freqs, (B,) lengths.

The layers take one of two routes, as in the JAX package. Where
``layer_stack.supports`` passes (both buckets multiples of 128, at most
1024) they run ``kernels.layer_stack.transformer_stack``. Elsewhere (a 2048
bucket, a pad-to-64 ladder) they take the per-block route: ``self_block``,
``cross_block`` and ``transformer_layer`` layer by layer, with projections,
LayerNorm and GELU in plain torch and attention on
``kernels.attention.fused_mha`` and ``bidirectional_cross_attention``.

Tensor parallelism (JAX ``tp_axis``) rides the per-block route only: with a
``TensorParallel`` context the weights are one shard's whole heads and FFN
columns (``parallel/mesh.py:shard_lightglue_params``), the head count is
the local one (read from the qkv weight), ``out`` and ``ffn2`` sum their
partial products over the model axis before their bias, and the LayerNorm
between ffn1 and ffn2 sums its statistics over it. The layer stack is never
taken under it (``layer_stack.supports``).

``forward_ring`` (:590-695) is the sequence-split forward: every attention
through ``parallel/ring.py`` on the ``kernels.attention.flash_attention_step``
kernel, the ring's positions in this process (``devices=``) or one per
process of a ``torch.distributed`` group (``group=``, the per-token ops on
each rank's stripe).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from lightglue_tpu_torch import quant
from lightglue_tpu_torch.config import LightGlueConfig
from lightglue_tpu_torch.kernels import attention, layer_stack
from lightglue_tpu_torch.parallel import ring
from lightglue_tpu_torch.precision import DTypePolicy, precision_scope

_NEG_INF = -1e30


def _weight(p, dtype) -> torch.Tensor:
    """A linear's weight in ``dtype``; an int8 one is dequantized on the fly
    (JAX :71-77). The scale carries one value per output channel (and the
    weight's leading axes)."""
    if "w_q" in p:
        return quant.dequantize({"w_q": p["w_q"], "scale": p["scale"].unsqueeze(-2)}, dtype)
    return p["w"].to(dtype)


def _per_entry(fn, *xs: torch.Tensor) -> torch.Tensor:
    """``fn(*xs)`` one batch entry at a time, each kept as a batch of one,
    concatenated: every call has the shape it has for one pair alone, as
    ``superpoint._conv`` convolves one image at a time. cuBLAS picks a
    product's algorithm by the whole shape, batch included, and so its sum
    order (``scripts/tune_torch_batch_invariance.py``, PERF.md section 6)."""
    if xs[0].shape[0] == 1:
        return fn(*xs)
    return torch.cat([fn(*(x[i:i + 1] for x in xs)) for i in range(xs[0].shape[0])])


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of a linear: ``w`` (in, out), or (B, in, out) with a weight
    per pair. An fp32 ``x`` with a batch axis runs one batch entry at a time
    (``_per_entry``): at MIXED and FP32 the match head's and the per-block
    route's projections gave a pair other bits in a batch of 4 than alone;
    bf16 products did not move."""
    if w.dim() == x.dim():
        if x.dtype == torch.float32:
            return _per_entry(torch.bmm, x, w)
        return torch.bmm(x, w)
    if x.dim() > 2 and x.dtype == torch.float32:
        return _per_entry(lambda xi: xi @ w, x)
    return x @ w


def _linear(p, x: torch.Tensor) -> torch.Tensor:
    return _matmul(x, _weight(p, x.dtype)) + p["b"].to(x.dtype)


class TensorParallel(NamedTuple):
    """One shard's view of the ``model`` mesh axis (JAX ``tp_axis``):
    ``size`` shards split the heads and FFN columns, and ``all_reduce(x)``
    returns the sum of every shard's ``x`` in x's dtype, on x's device (JAX
    ``lax.psum``)."""

    size: int
    all_reduce: Callable[[torch.Tensor], torch.Tensor]


def _linear_rowshard(p, x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """Row-sharded linear (JAX :88-94): x holds the local feature slice, w the
    matching rows; the partial products are summed over the model axis and
    the bias is added once, after the sum."""
    partial = _matmul(x, _weight(p, x.dtype))
    if tp is not None:
        partial = tp.all_reduce(partial)
    return partial + p["b"].to(x.dtype)


def _linear_maybe_batched(p, x: torch.Tensor) -> torch.Tensor:
    """Linear whose weights may carry a leading per-pair axis (B, in, out):
    each pair of an adaptive batch uses the head of the layer it exited at."""
    w = _weight(p, x.dtype)
    if w.dim() == x.dim():
        return _matmul(x, w) + p["b"].to(x.dtype)[:, None, :]
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
    # one pair at a time: at 200 keypoints the batched fp32 product gave a
    # pair other bits in a batch of 4 than alone
    sim = _per_entry(lambda a, b: a @ b.transpose(-1, -2), md0.float(), md1.float())
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


# ---------------------------------------------------------------------------
# the per-block route (lightglue.py:97-378), where the stack's gate fails
# ---------------------------------------------------------------------------

# beyond this the bidirectional kernel's whole S rows outgrow fast memory;
# the two cross directions then run as two fused_mha calls (lightglue.py:61)
_BIDIR_MAX_N = 1024


def _layer_norm(g, b, x: torch.Tensor, eps: float = 1e-5,
                tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """LayerNorm over the last dim in fp32, var = E[x^2] - mean^2 (:97-111).
    Under ``tp`` x is a feature slice: the sums of x and x^2 are summed over
    the model axis (one all-reduce of both) and divided by the global width."""
    xf = x.float()
    if tp is None:
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    else:
        n = xf.shape[-1] * tp.size
        sums = tp.all_reduce(torch.cat([xf.sum(dim=-1, keepdim=True),
                                        (xf * xf).sum(dim=-1, keepdim=True)], dim=-1))
        mean = sums[..., :1] / n
        var = sums[..., 1:] / n - mean * mean
    return ((xf - mean) * torch.rsqrt(var + eps) * g + b).to(x.dtype)


# sqrt(1/2) rounded to each float dtype, as a Python float: rounded once
# here, so the model reads no tensor's value while it runs (a fake tensor
# under torch.export has none)
_SQRT_HALF = {dt: torch.tensor(math.sqrt(0.5), dtype=dt).item()
              for dt in (torch.float64, torch.float32, torch.bfloat16, torch.float16)}


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU as ``jax.nn.gelu(approximate=False)`` writes it, in x's
    dtype: 0.5 * x * erfc(-x * sqrt(1/2)), the constant rounded to x's dtype."""
    return 0.5 * x * torch.erfc(-x * _SQRT_HALF[x.dtype])


# RoPE under the JAX module's names (:131-149): the model applies it inside
# fused_mha, whose plain version shares it with the layer stack's
rotate_half, apply_rotary = layer_stack.rotate_half, layer_stack.apply_rotary
# the head split and merge of (B, N, H*D) <-> (B, H, N, D) (:152-160)
_split_heads, _merge_heads = attention._heads, attention._merge


def _attend(q, k, v, lengths, policy: DTypePolicy, num_heads: int, freqs=None,
            ops=attention.KERNEL_OPS) -> torch.Tensor:
    """(B, N, H*D) q/k/v -> (B, N, H*D) through ``fused_mha`` (:164-185)."""
    dt = policy.attn_in_dtype
    out = ops.fused_mha(q.to(dt), k.to(dt), v.to(dt), freqs, lengths, num_heads=num_heads,
                        stat_dtype=policy.attn_stat_dtype, out_dtype=policy.attn_out_dtype)
    return out.to(q.dtype)


def _ffn(p, x: torch.Tensor, message: torch.Tensor,
         tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """Residual FFN over cat(x, message) (:188-202). Under ``tp`` ffn1 is
    column-sharded and ffn2 row-sharded around the reduced LayerNorm."""
    h = _linear(p["ffn1"], torch.cat([x, message], dim=-1))
    h = _gelu(_layer_norm(p["ln_g"], p["ln_b"], h, tp=tp))
    return x + _linear_rowshard(p["ffn2"], h, tp)


def self_block(p, x, freqs, lengths, num_heads: int, policy: DTypePolicy,
               ops=attention.KERNEL_OPS, tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """Self-attention block (:205-233): one [q | k | v] projection, RoPE
    inside ``fused_mha`` on column slices of it. ``num_heads`` is the local
    head count under ``tp`` (the shard's q, k and v columns are its heads')."""
    qkv = _linear(p["qkv"], x)
    e = qkv.shape[-1] // 3
    lens2 = None if lengths is None else torch.stack([lengths, lengths], dim=-1)
    ctx = _attend(qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:], lens2, policy,
                  num_heads, freqs, ops)
    return _ffn(p, x, _linear_rowshard(p["out"], ctx, tp), tp)


def _cross_attend(qk0, qk1, v0, v1, lengths0, lengths1, policy: DTypePolicy, num_heads: int,
                  ops=attention.KERNEL_OPS):
    """Both cross directions (:263-295): the shared-S kernel up to
    ``_BIDIR_MAX_N``, else two ``fused_mha`` calls."""
    dt = policy.attn_in_dtype
    if max(qk0.shape[1], qk1.shape[1]) <= _BIDIR_MAX_N:
        lens = None if lengths0 is None else torch.stack([lengths0, lengths1], dim=-1)
        m0, m1 = ops.bidirectional_cross_attention(
            qk0.to(dt), qk1.to(dt), v0.to(dt), v1.to(dt), lens, num_heads=num_heads,
            stat_dtype=policy.attn_stat_dtype, out_dtype=policy.attn_out_dtype)
        return m0.to(qk0.dtype), m1.to(qk0.dtype)
    l01 = l10 = None
    if lengths0 is not None:
        l01 = torch.stack([lengths0, lengths1], dim=-1)
        l10 = torch.stack([lengths1, lengths0], dim=-1)
    return (_attend(qk0, qk1, v1, l01, policy, num_heads, ops=ops),
            _attend(qk1, qk0, v0, l10, policy, num_heads, ops=ops))


def cross_block(p, x0, x1, lengths0, lengths1, num_heads: int, policy: DTypePolicy,
                ops=attention.KERNEL_OPS, tp: Optional[TensorParallel] = None):
    """Bidirectional symmetric cross-attention (:236-260); the shared qk and
    v projections are one [qk | v] product per image."""
    a0, a1 = _linear(p["qk_v"], x0), _linear(p["qk_v"], x1)
    e = a0.shape[-1] // 2
    m0, m1 = _cross_attend(a0[..., :e], a1[..., :e], a0[..., e:], a1[..., e:],
                           lengths0, lengths1, policy, num_heads, ops)
    return (_ffn(p, x0, _linear_rowshard(p["out"], m0, tp), tp),
            _ffn(p, x1, _linear_rowshard(p["out"], m1, tp), tp))


def cross_block_fused(p, x, b: int, lens, num_heads: int, policy: DTypePolicy,
                      ops=attention.KERNEL_OPS, tp: Optional[TensorParallel] = None):
    """Both cross directions of a stacked [image0; image1] batch (:347-378):
    projections and FFN run once over the 2B stack."""
    a = _linear(p["qk_v"], x)
    e = a.shape[-1] // 2
    qk, v = a[..., :e], a[..., e:]
    m0, m1 = _cross_attend(qk[:b], qk[b:], v[:b], v[b:],
                           None if lens is None else lens[:b],
                           None if lens is None else lens[b:], policy, num_heads, ops)
    out = _ffn(p, x, _linear_rowshard(p["out"], torch.cat([m0, m1], dim=0), tp), tp)
    return out[:b], out[b:]


def transformer_layer(p, d0, d1, freqs0, freqs1, lengths0, lengths1, num_heads: int,
                      policy: DTypePolicy, ops=attention.KERNEL_OPS,
                      tp: Optional[TensorParallel] = None):
    """self(d0) -> self(d1) -> cross (:298-344). When both images share a
    bucket they are stacked on the batch axis: one self call and one cross
    call over 2B, with (2B, 2) lengths built from both images' lengths."""
    if d0.shape == d1.shape:
        b = d0.shape[0]
        lens = None if lengths0 is None else torch.cat([lengths0, lengths1], dim=0)
        x = self_block(p["self_attn"], torch.cat([d0, d1], dim=0),
                       torch.cat([freqs0, freqs1], dim=0), lens, num_heads, policy, ops, tp)
        return cross_block_fused(p["cross_attn"], x, b, lens, num_heads, policy, ops, tp)
    d0 = self_block(p["self_attn"], d0, freqs0, lengths0, num_heads, policy, ops, tp)
    d1 = self_block(p["self_attn"], d1, freqs1, lengths1, num_heads, policy, ops, tp)
    return cross_block(p["cross_attn"], d0, d1, lengths0, lengths1, num_heads, policy, ops, tp)


def transformer_layers(layers, d0, d1, freqs0, freqs1, lengths0=None, lengths1=None, *,
                       num_heads: int, policy: DTypePolicy, ops=attention.KERNEL_OPS,
                       tp: Optional[TensorParallel] = None):
    """Every stacked layer on the per-block route (the ``lax.scan`` of
    :548-567). ``ops=attention.PLAIN_OPS`` runs the same loop on the
    attention kernels' plain versions. An int8 tree runs weight-only
    (``_weight``), whatever ``LGTPU_W8A8`` says, as in the JAX package."""
    for i in range(layers["self_attn"]["ln_g"].shape[0]):
        d0, d1 = transformer_layer(_layer(layers, i), d0, d1, freqs0, freqs1,
                                   lengths0, lengths1, num_heads, policy, ops, tp)
    return d0, d1


def local_heads(params, head_dim: int) -> int:
    """The head count of a (possibly model-sharded) tree: qkv's output
    columns over 3 x head_dim (JAX :514-516)."""
    qkv = params["layers"]["self_attn"]["qkv"]
    return (qkv["w_q"] if "w_q" in qkv else qkv["w"]).shape[-1] // (3 * head_dim)


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
    tp: Optional[TensorParallel] = None,
) -> LightGlueOutput:
    """Fixed-depth forward: all layers, last-layer assignment only. The
    depth/width knobs of ``config`` are not read (``forward_adaptive`` is
    the adaptive entry point, as in the JAX package).

    Args:
      params: the port's LightGlue tree (runtime/weights.py:params_from_numpy);
        under ``tp`` one shard's slices of it (heads read from its shapes).
      kpts0/kpts1: (B, M, 2) / (B, N, 2) keypoints normalised to [-1, 1].
      desc0/desc1: (B, M, E) / (B, N, E) descriptors.
      lengths0/lengths1: optional (B,) true keypoint counts (bucketed pads).
      tp: the model axis this shard is part of (``parallel/mesh.py``), or
        None.
    """
    with precision_scope(policy):
        d0, d1, freqs0, freqs1 = _embed(params, kpts0, kpts1, desc0, desc1, config, policy)
        if layer_stack.supports(params["layers"], d0.shape[1], d1.shape[1], d0.dtype, tp):
            d0, d1 = layer_stack.transformer_stack(
                params["layers"], d0, d1, freqs0, freqs1, lengths0, lengths1,
                num_heads=config.num_heads,
                head_dim=config.head_dim,
                stat_dtype=policy.attn_stat_dtype,
                attn_dtype=policy.attn_in_dtype,
            )
        else:
            d0, d1 = transformer_layers(params["layers"], d0, d1, freqs0, freqs1,
                                        lengths0, lengths1,
                                        num_heads=local_heads(params, config.head_dim),
                                        policy=policy, tp=tp)
        scores = _last_assignment(params, d0, d1, lengths0, lengths1, kpts0.shape[1],
                                  kpts1.shape[1], config.descriptor_dim)
    return LightGlueOutput(d0, d1, scores, torch.tensor(config.n_layers))


def _last_assignment(params, d0, d1, lengths0, lengths1, m: int, n: int, dim: int):
    mask0, mask1 = _masks_from_lengths(lengths0, lengths1, m, n)
    last_assign = {k: {kk: vv[-1] for kk, vv in v.items()} for k, v in params["assign"].items()}
    return match_assignment(last_assign, d0, d1, mask0, mask1, dim)


def forward_ring(
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
    devices=None,
    group=None,
    step=attention.flash_attention_step,
) -> LightGlueOutput:
    """Sequence-split fixed-depth forward (JAX :590-695): every self and
    cross attention rides ``parallel/ring.py`` at fp32 stats (the JAX
    function passes no stat dtype), over ``devices`` in this process or over
    the processes of ``group``.

    Semantically ``forward``: self-attention per image, RoPE applied to the
    heads before the ring in ``policy.attn_in_dtype``, the cross directions
    (qk0, qk1, v1) and (qk1, qk0, v0), the last layer's assignment.

    - ``devices``: only attention is split; the projections, LayerNorm, GELU
      and the assignment run on the whole tensors on ``devices[0]`` (the
      params must be there).
    - ``group``: JAX's ``shard_seq`` (:622-627). Every rank passes the whole
      inputs on its own device (the params there too), keeps its stripe of
      both images' tokens (rank r the r-th of ``ring`` equal stripes), and
      runs the input projection, posenc, every projection, the FFN with its
      LayerNorm and GELU, and RoPE on that stripe only; each attention is
      the process ring; at the end the descriptors are gathered over the
      group and the assignment runs on every rank, which returns the whole
      output, as JAX's global arrays read. Both buckets must divide the ring
      size, checked on every rank before the first transfer.

    ``step=attention.flash_attention_step_plain`` runs the same loop on the
    plain step. An int8 tree runs weight-only (``_weight``), whatever
    ``LGTPU_W8A8`` says, as in the JAX package.
    """
    if (devices is None) == (group is None):
        raise ValueError("forward_ring: pass devices= (one process) or group= (one ring "
                         "position per process)")
    if group is not None:
        return _forward_ring_group(params, kpts0, kpts1, desc0, desc1, lengths0, lengths1,
                                   config, policy, group, step)
    home = torch.device(devices[0])
    kpts0, kpts1, desc0, desc1 = (t.to(home) for t in (kpts0, kpts1, desc0, desc1))
    if lengths0 is not None:
        lengths0, lengths1 = lengths0.to(home), lengths1.to(home)

    def attend(q, k, v, freqs, lq, lkv):
        out = ring.ring_attention(*_ring_heads(q, k, v, freqs, config, policy),
                                  _ring_lengths(lq, lkv), devices=devices, step=step)
        return _merge_heads(out).to(q.dtype)

    with precision_scope(policy):
        d0, d1, freqs0, freqs1 = _embed(params, kpts0, kpts1, desc0, desc1, config, policy)
        d0, d1 = _ring_layers(params["layers"], d0, d1, freqs0, freqs1, lengths0, lengths1,
                              attend)
        scores = _last_assignment(params, d0, d1, lengths0, lengths1, kpts0.shape[1],
                                  kpts1.shape[1], config.descriptor_dim)
    return LightGlueOutput(d0, d1, scores, torch.tensor(config.n_layers))


def _forward_ring_group(params, kpts0, kpts1, desc0, desc1, lengths0, lengths1, config,
                        policy, group, step) -> LightGlueOutput:
    """``forward_ring`` over the processes of ``group``: the per-token ops on
    this rank's stripes, each attention through the process ring."""
    pr = ring.ProcessRing(group, desc0.device)
    shapes = tuple(tuple(t.shape) for t in (kpts0, kpts1, desc0, desc1))
    sigs = ring.agree(group, shapes, pr.size)
    if len(set(sigs)) > 1:
        raise ValueError(f"forward_ring: the ranks' input shapes differ: {sigs}")
    m, n = kpts0.shape[1], kpts1.shape[1]
    if m % pr.size or n % pr.size:
        raise ring.divide_error(m, n, pr.size)
    s0 = slice(pr.idx * m // pr.size, (pr.idx + 1) * m // pr.size)
    s1 = slice(pr.idx * n // pr.size, (pr.idx + 1) * n // pr.size)

    def attend(q, k, v, freqs, lq, lkv):
        qh, kh, vh = _ring_heads(q, k, v, freqs, config, policy)
        out = ring.ring_attention_local(qh, kh, vh, _ring_lengths(lq, lkv), idx=pr.idx,
                                        ring=pr.size, transport=pr.transport(kh, vh), step=step)
        return _merge_heads(out).to(q.dtype)

    with precision_scope(policy):
        d0, d1, freqs0, freqs1 = _embed(params, kpts0[:, s0], kpts1[:, s1], desc0[:, s0],
                                        desc1[:, s1], config, policy)
        d0, d1 = _ring_layers(params["layers"], d0, d1, freqs0, freqs1, lengths0, lengths1,
                              attend)
        d0, d1 = pr.gather(d0, dim=1), pr.gather(d1, dim=1)
        scores = _last_assignment(params, d0, d1, lengths0, lengths1, m, n,
                                  config.descriptor_dim)
    return LightGlueOutput(d0, d1, scores, torch.tensor(config.n_layers))


def _ring_heads(q, k, v, freqs, config, policy):
    """(B, N, H*D) q/k/v -> ring heads in ``policy.attn_in_dtype``, RoPE on
    q and k where ``freqs`` is given."""
    qh, kh, vh = (_split_heads(t.to(policy.attn_in_dtype), config.num_heads) for t in (q, k, v))
    if freqs is not None:
        qh, kh = apply_rotary(freqs, qh), apply_rotary(freqs, kh)
    return qh, kh, vh


def _ring_lengths(lq, lkv):
    return None if lq is None else torch.stack([lq, lkv], dim=-1).to(torch.int32)


def _ring_layers(layers, d0, d1, freqs0, freqs1, lengths0, lengths1, attend):
    """``forward_ring``'s layers over whichever rows ``d0``/``d1`` hold (the
    whole images, or a rank's stripes with ``freqs`` of the same rows);
    ``attend(q, k, v, freqs, len_q, len_kv)`` is the ring."""
    e = d0.shape[-1]
    for i in range(layers["self_attn"]["ln_g"].shape[0]):
        sp, cp = _layer(layers["self_attn"], i), _layer(layers["cross_attn"], i)
        new = []
        for x, freqs, lens in ((d0, freqs0, lengths0), (d1, freqs1, lengths1)):
            qkv = _linear(sp["qkv"], x)
            ctx = attend(qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:], freqs, lens, lens)
            new.append(_ffn(sp, x, _linear(sp["out"], ctx)))
        d0, d1 = new
        a0, a1 = _linear(cp["qk_v"], d0), _linear(cp["qk_v"], d1)
        m0 = attend(a0[..., :e], a1[..., :e], a1[..., e:], None, lengths0, lengths1)
        m1 = attend(a1[..., :e], a0[..., :e], a0[..., e:], None, lengths1, lengths0)
        d0 = _ffn(cp, d0, _linear(cp["out"], m0))
        d1 = _ffn(cp, d1, _linear(cp["out"], m1))
    return d0, d1


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
    ``downshift_layer`` the two phases ``_downshift_phase1`` and
    ``_downshift_phase2`` around one host read).
    ``force_loop=True``, and buckets that fail the stack's gate, run the
    per-layer loop instead: the JAX while-loop of ``_forward_adaptive_impl``
    (:904-1045) with a compaction after every layer, on
    ``transformer_stack`` one layer at a time or, off the gate, on the
    per-block ``transformer_layer``. It runs all layers (a pair that
    stopped is frozen) instead of ending when every pair has stopped,
    which needs no host read and gives the same result.

    Args:
      lengths0/lengths1: (B,) true keypoint counts (the session always
        passes them).
      full: every pair fills its bucket; depth-only then runs the unmasked
        variant of the stack.
    """
    head = adaptive_head(params, kpts0, kpts1, desc0, desc1, lengths0, lengths1,
                         config=config, policy=policy, force_loop=force_loop, full=full)
    # the downshift's one host read: do every pair's survivors fit N/2?
    fits = bool(head["fits"]) if "fits" in head else None
    return adaptive_rest(params, head, fits, config=config, policy=policy)


def reads_host(params, m: int, n: int, config: LightGlueConfig, act_dtype) -> bool:
    """Whether ``forward_adaptive`` at buckets (m, n) takes the downshift,
    whose phase-2 width one host read picks (``adaptive_head`` then returns
    ``fits``)."""
    do_width = config.width_confidence > 0
    return (do_width and layer_stack.supports(params["layers"], m, n, act_dtype)
            and _use_downshift(params, m, n, config, act_dtype))


def adaptive_head(params, kpts0, kpts1, desc0, desc1, lengths0, lengths1, *,
                  config: LightGlueConfig, policy: DTypePolicy, force_loop: bool = False,
                  full: bool = False) -> dict:
    """``forward_adaptive`` up to the downshift's host read, on the device:
    the final state (``final``), or with the downshift phase 1's compacted
    state and the device flag ``fits``; ``m`` and ``n``, the buckets."""
    with precision_scope(policy):
        d0, d1, freqs0, freqs1 = _embed(params, kpts0, kpts1, desc0, desc1, config, policy)
        b, m, n = d0.shape[0], d0.shape[1], d1.shape[1]
        lengths0 = lengths0.to(d0.device, torch.int32)
        lengths1 = lengths1.to(d0.device, torch.int32)
        idx0 = torch.arange(m, dtype=torch.int32, device=d0.device).expand(b, m)
        idx1 = torch.arange(n, dtype=torch.int32, device=d0.device).expand(b, n)
        args = (params, d0, d1, freqs0, freqs1, lengths0, lengths1, idx0, idx1)
        do_depth = config.depth_confidence > 0
        do_width = config.width_confidence > 0
        use_stack = layer_stack.supports(params["layers"], m, n, d0.dtype)
        if force_loop or not (do_depth or do_width) or not use_stack:
            final = _adaptive_loop(*args, config=config, policy=policy, use_stack=use_stack)
        elif reads_host(params, m, n, config, d0.dtype):
            return dict(_downshift_phase1(*args, config=config, policy=policy), m=m, n=n)
        else:
            final = _adaptive_single(*args, config=config, policy=policy, full=full)
        return dict(final=final, m=m, n=n)


def adaptive_rest(params, head: dict, fits: Optional[bool], *, config: LightGlueConfig,
                  policy: DTypePolicy) -> AdaptiveOutput:
    """``forward_adaptive`` from ``adaptive_head``'s state: the downshift's
    phase 2 at the width ``fits`` picks (None without the downshift), the
    per-pair head of the exit layer and the output."""
    with precision_scope(policy):
        final = head["final"] if fits is None else _downshift_phase2(
            params, head, fits, config=config, policy=policy)
        return _adaptive_tail(params, final, head["m"], head["n"], config)


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


def _downshift_phase1(params, d0, d1, freqs0, freqs1, lengths0, lengths1, idx0, idx1, *,
                      config, policy):
    """Phase 1 of the two-phase adaptive forward with the bucket-ladder
    downshift (``lightglue_tpu/models/lightglue.py:_adaptive_downshift``):
    layers [0, ds) at full width, the survivors compacted, and ``fits``, a
    device flag: every pair's survivors fit N/2.

    ``_downshift_phase2`` runs layers [ds, L) at half width when ``fits``,
    else at full width. Reading ``fits`` between the two is the one host
    read of the adaptive path (the JAX package's ``lax.cond``), once per
    call; nothing is read back per layer.

    Phase 2 takes phase 1's exit values as they are: a pair that exited in
    phase 1 is dead at every global layer of phase 2. The JAX kernel passes
    a 0/1 flag instead and tests liveness against its LOCAL layer index, so
    a pair that meets the depth criterion inside phase 2 runs on and is
    overwritten by the forced last-layer exit; this port follows the
    ``force_loop`` oracle (ROADMAP queue 3).
    """
    ds, m = int(config.downshift_layer), d0.shape[1]
    half = m // 2
    fd0, fd1, exit1, kf0, kf1 = layer_stack.transformer_stack_adaptive(
        _slice(params["layers"], 0, ds), _slice(params["token"], 0, ds), d0, d1, freqs0,
        freqs1, lengths0, lengths1, _slice(params["assign"]["match"], 0, ds),
        **_downshift_kw(config, policy))
    nl0, (cd0, cf0, cidx0) = _compact(kf0 > 0.5, fd0, freqs0, idx0)
    nl1, (cd1, cf1, cidx1) = _compact(kf1 > 0.5, fd1, freqs1, idx1)
    return dict(cd0=cd0, cd1=cd1, cf0=cf0, cf1=cf1, nl0=nl0, nl1=nl1, cidx0=cidx0,
                cidx1=cidx1, exit1=exit1, fits=((nl0 <= half) & (nl1 <= half)).all())


def _downshift_kw(config, policy):
    return _stack_kw(config, policy, depth_confidence=_depth_arg(config),
                     width_confidence=float(config.width_confidence),
                     total_layers=config.n_layers)


def _downshift_phase2(params, p1, fits: bool, *, config, policy):
    """Phase 2 of the downshift: layers [ds, L) on phase 1's compacted state
    ``p1`` at half width where ``fits``, else at full width, back to the
    bucket, and the final compaction."""
    ds, n_layers, m = int(config.downshift_layer), config.n_layers, p1["cd0"].shape[1]
    half = m // 2
    tok, match = params["token"], params["assign"]["match"]
    w = half if fits else m
    cd0, cd1, cf0, cf1 = p1["cd0"], p1["cd1"], p1["cf0"], p1["cf1"]
    o0, o1, exit_layer, k0, k1 = layer_stack.transformer_stack_adaptive(
        _slice(params["layers"], ds, n_layers), _slice(tok, ds, n_layers - 1),
        cd0[:, :w].contiguous(), cd1[:, :w].contiguous(), cf0[:, :, :w], cf1[:, :, :w],
        p1["nl0"], p1["nl1"], _slice(match, ds, n_layers), p1["exit1"], layer_offset=ds,
        **_downshift_kw(config, policy))
    if fits:  # back to the bucket: padded slots are never kept
        o0, o1 = (F.pad(t, (0, 0, 0, m - half)) for t in (o0, o1))
        k0, k1 = (F.pad(t, (0, m - half)) for t in (k0, k1))
    fl0, (gd0, gidx0) = _compact(k0 > 0.5, o0, p1["cidx0"])
    fl1, (gd1, gidx1) = _compact(k1 > 0.5, o1, p1["cidx1"])
    return dict(d0=gd0, d1=gd1, len0=fl0, len1=fl1, idx0=gidx0, idx1=gidx1,
                exit_layer=exit_layer)


def _adaptive_loop(params, d0, d1, freqs0, freqs1, lengths0, lengths1, idx0, idx1, *,
                   config, policy, use_stack):
    """The per-layer loop (JAX ``_forward_adaptive_impl`` :904-1045): each
    layer on ``transformer_stack`` where its gate passes, else on the
    per-block ``transformer_layer`` (:921-966)."""
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
        if use_stack:
            nd0, nd1 = layer_stack.transformer_stack(_slice(params["layers"], i, i + 1),
                                                     d0, d1, freqs0, freqs1, len0, len1, **kw)
        else:
            nd0, nd1 = transformer_layer(_layer(params["layers"], i), d0, d1, freqs0, freqs1,
                                         len0, len1, config.num_heads, policy)
        live = ~stopped  # freeze pairs that already exited
        nd0 = torch.where(live[:, None, None], nd0, d0)
        nd1 = torch.where(live[:, None, None], nd1, d1)
        mask0, mask1 = _masks_from_lengths(len0, len1, m, n)
        is_last = i == n_layers - 1
        if do_depth or do_width:
            c0, c1 = token_confidence(_layer(params["token"], min(i, n_layers - 2)), nd0, nd1)
            # a 0-dim CPU tensor meets the device tensors as a scalar: no copy
            th = confidence_threshold(i, n_layers)
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
