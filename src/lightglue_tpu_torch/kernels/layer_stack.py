"""The LightGlue layer stack on three hand-written kernels.

Counterpart of ``lightglue_tpu/kernels/layer_stack.py:transformer_stack``
(wrapper :801, pallas_call :894, body :121-748, fixed-depth branch). The TPU
kernel keeps a pair's activations in VMEM across all layers in one
pallas_call; here a Python loop over the layers launches, per layer and
image, the kernels of ``csrc/``:

- ``linear`` (``csrc/linear.cu``): every projection — fused qkv, the cross
  block's fused [qk | v], the out projections, ffn1 over cat(x, message)
  taken as two operands, ffn2 with its residual add;
- ``attention`` (``csrc/attention.cu``): masked self-attention with RoPE and
  both cross-attention directions (one launch each);
- ``ln_gelu`` (``csrc/ln_gelu.cu``): the FFN's LayerNorm + GELU.

Each wrapper launches its kernel on a CUDA tensor and runs its plain PyTorch
version (``*_plain``) on a CPU tensor; ``transformer_stack_plain`` runs the
same loop on the plain versions on any device. Rounding follows the JAX
kernel's points exactly (see each kernel's header).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from lightglue_tpu_torch.kernels import _build

MAX_SEQ = 1024  # the JAX kernel's VMEM gate, kept as the port's contract
HEAD_DIM = 64   # the attention kernel's head width
_NEG_INF = -1e30
_DEAD = _NEG_INF * 0.5  # all-masked-row clamp (layer_stack.py:276-292)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def _check_same(name: str, dtype, *tensors) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"{name}: dtype {dtype} (fp32 and bf16 only)")
    for t in tensors:
        if t is not None and (t.dtype != dtype or t.device != tensors[0].device):
            raise NotImplementedError(
                f"{name}: operands must share dtype {dtype} and a device; got "
                f"{t.dtype} on {t.device} (mixed-precision rung on the card is queued)"
            )


# ---------------------------------------------------------------------------
# linear
# ---------------------------------------------------------------------------


def linear_plain(a, w, b, a2=None, residual=None):
    """[a | a2] @ w + b (+ residual): fp32 accumulation of w-dtype operands,
    cast to a's dtype, bias added in a's dtype, residual added in a's dtype."""
    x = a if a2 is None else torch.cat([a, a2], dim=-1)
    y = (x.to(w.dtype).float() @ w.float()).to(a.dtype) + b.to(a.dtype)
    return y if residual is None else y + residual


def linear(a, w, b, a2=None, residual=None):
    """Y = [a | a2] @ w + b (+ residual) over the last dim.

    Args:
      a: (..., K1) activations; a2: optional (..., K - K1) second operand
        (the concat is never materialised); w: (K, N); b: (N,);
        residual: optional (..., N). On the card all share one dtype.
    """
    if a.device.type == "cpu":
        return linear_plain(a, w, b, a2, residual)
    _check_same("linear", a.dtype, a, w, b, a2, residual)
    k, n = w.shape
    k1 = a.shape[-1]
    lead = a.shape[:-1]
    m = a.numel() // k1
    if n % 64 or k % 16 or (a2 is None and k1 != k):
        raise ValueError(f"linear: K={k} (x16), N={n} (x64), K1={k1}")
    if a2 is not None and (a2.shape[:-1] != lead or k1 + a2.shape[-1] != k):
        raise ValueError(f"linear: operands {a.shape} + {a2.shape} vs K={k}")
    if b.shape != (n,) or (residual is not None and residual.shape != (*lead, n)):
        raise ValueError("linear: bias or residual shape")
    for t in (a, a2, w, b, residual):
        if t is not None and not t.is_contiguous():
            raise ValueError("linear: operands must be contiguous")
    y = torch.empty((*lead, n), dtype=a.dtype, device=a.device)
    err = _build.lib().lg_linear(
        a.data_ptr(), None if a2 is None else a2.data_ptr(), k1,
        w.data_ptr(), b.data_ptr(),
        None if residual is None else residual.data_ptr(), y.data_ptr(),
        m, n, k, _is_bf16(a), _stream(a),
    )
    _build.check(err, "linear")
    linear.launches += 1
    return y


linear.launches = 0


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _quant(x: torch.Tensor, stat_dtype) -> torch.Tensor:
    return x if stat_dtype == torch.float32 else x.to(stat_dtype).float()


def _rope(v: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = v.shape[-1] // 2
    rot = torch.cat([-v[..., half:], v[..., :half]], dim=-1)
    return v * cos + rot * sin


def attention_plain(q, k, v, freqs, len_q, len_kv, num_heads, stat_dtype,
                    out_dtype=None):
    """Masked multi-head attention with the reference's rounding points.

    q: (B, Nq, H*D), k/v: (B, Nk, H*D) in the operand dtype; freqs:
    (B, 2, N, D) fp32 or None; len_q/len_kv: (B,) ints or None. The fp32
    result is cast once to ``out_dtype`` (default: the operand dtype)."""
    bsz, nq, e = q.shape
    nk = k.shape[1]
    d = e // num_heads
    dt = q.dtype

    def heads(t, n):
        return t.reshape(bsz, n, num_heads, d).transpose(1, 2)  # (B, H, N, D)

    qh, kh, vh = heads(q, nq), heads(k, nk), heads(v, nk)
    if freqs is not None:
        cos = freqs[:, 0, None].to(dt)
        sin = freqs[:, 1, None].to(dt)
        qh, kh = _rope(qh, cos, sin), _rope(kh, cos, sin)
    s = _quant((qh.float() @ kh.float().transpose(-1, -2)) * (1.0 / math.sqrt(d)),
               stat_dtype)
    masked = len_q is not None
    if masked:
        cols = torch.arange(nk, device=q.device)
        s = torch.where(cols < len_kv.view(-1, 1, 1, 1), s, _NEG_INF)
    m = _quant(s.amax(dim=-1, keepdim=True), stat_dtype)
    if masked:
        m = m.clamp_min(_DEAD)
    p = _quant(torch.exp(s - m), stat_dtype)
    l = _quant(p.sum(dim=-1, keepdim=True), stat_dtype)
    o = (p.to(dt).float() @ vh.float()) / torch.where(l == 0.0, 1.0, l)
    if masked:
        rows = torch.arange(nq, device=q.device)[:, None]
        o = torch.where(rows < len_q.view(-1, 1, 1, 1), o, 0.0)
    return o.transpose(1, 2).reshape(bsz, nq, e).to(out_dtype or dt)


def attention(q, k, v, freqs, len_q, len_kv, num_heads, stat_dtype,
              out_dtype=None):
    """Multi-head attention over (B, N, H*64) rows, heads in column blocks.

    q, k, v may be column slices of a wider projection (any batch and row
    stride, unit column stride). ``freqs`` (B, 2, N, 64) turns on half-split
    RoPE for q and k (self-attention, Nq == Nk); ``len_q``/``len_kv`` (B,)
    mask padded rows/columns (both or neither). Returns (B, Nq, H*64) in
    ``out_dtype``, which on the card must be the operand dtype."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, freqs, len_q, len_kv, num_heads,
                               stat_dtype, out_dtype)
    _check_same("attention", q.dtype, q, k, v)
    if out_dtype not in (None, q.dtype):
        raise NotImplementedError(
            "attention: output dtype differs from the operands (mixed-precision "
            "rung on the card is queued)")
    bsz, nq, e = q.shape
    nk = k.shape[1]
    if e != num_heads * HEAD_DIM or k.shape[-1] != e or v.shape[:2] != k.shape[:2]:
        raise ValueError(f"attention: head dim must be {HEAD_DIM}: {q.shape} {k.shape}")
    if k.shape[0] != bsz or v.shape[-1] != e:
        raise ValueError(f"attention: shapes {q.shape} {k.shape} {v.shape}")
    if min(t.stride(-1) for t in (q, k, v)) != 1 or max(t.stride(-1) for t in (q, k, v)) != 1:
        raise ValueError("attention: q/k/v need unit column stride")
    smem = 4 * (16 * HEAD_DIM + 64 * (HEAD_DIM + 1) + 16 * nk + 16)
    if smem > _build.MAX_DYNAMIC_SMEM:
        raise ValueError(f"attention: {nk} keys exceed the shared-memory row block")
    if stat_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"attention: stat dtype {stat_dtype}")
    if freqs is not None:
        if nq != nk or freqs.shape != (bsz, 2, nq, HEAD_DIM):
            raise ValueError(f"attention: freqs {tuple(freqs.shape)} for N={nq}")
        freqs = freqs.float().contiguous()
    if (len_q is None) != (len_kv is None):
        raise ValueError("attention: pass both lengths or neither")
    if len_q is not None:
        len_q = len_q.to(torch.int32).contiguous()
        len_kv = len_kv.to(torch.int32).contiguous()
        if len_q.shape != (bsz,) or len_kv.shape != (bsz,):
            raise ValueError("attention: lengths must be (B,)")
    out = torch.empty((bsz, nq, e), dtype=q.dtype, device=q.device)
    err = _build.lib().lg_attention(
        q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(1),
        v.data_ptr(), v.stride(0), v.stride(1),
        None if freqs is None else freqs.data_ptr(),
        None if len_q is None else len_q.data_ptr(),
        None if len_kv is None else len_kv.data_ptr(),
        out.data_ptr(), bsz, nq, nk, num_heads, 1.0 / math.sqrt(HEAD_DIM),
        int(stat_dtype == torch.bfloat16), _is_bf16(q), _stream(q),
    )
    _build.check(err, "attention")
    attention.launches += 1
    return out


attention.launches = 0


# ---------------------------------------------------------------------------
# LayerNorm + GELU
# ---------------------------------------------------------------------------


def ln_gelu_plain(h, g, b):
    hf = h.float()
    mean = hf.mean(dim=-1, keepdim=True)
    var = (hf * hf).mean(dim=-1, keepdim=True) - mean * mean
    n = (hf - mean) * torch.rsqrt(var + 1e-5) * g.float() + b.float()
    return (0.5 * n * (1.0 + torch.erf(n * (1.0 / math.sqrt(2.0))))).to(h.dtype)


def ln_gelu(h, g, b):
    """GELU(LayerNorm(h) * g + b) over the last dim (<= 512), fp32 math,
    result in h's dtype."""
    if h.device.type == "cpu":
        return ln_gelu_plain(h, g, b)
    _check_same("ln_gelu", h.dtype, h, g, b)
    c = h.shape[-1]
    if c > 512 or g.shape != (c,) or b.shape != (c,):
        raise ValueError(f"ln_gelu: width {c} (<= 512), gamma/beta {g.shape}")
    if not (h.is_contiguous() and g.is_contiguous() and b.is_contiguous()):
        raise ValueError("ln_gelu: operands must be contiguous")
    y = torch.empty_like(h)
    err = _build.lib().lg_ln_gelu(
        h.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
        h.numel() // c, c, _is_bf16(h), _stream(h),
    )
    _build.check(err, "ln_gelu")
    ln_gelu.launches += 1
    return y


ln_gelu.launches = 0


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------


class _Ops(NamedTuple):
    linear: Callable
    attention: Callable
    ln_gelu: Callable


KERNEL_OPS = _Ops(linear, attention, ln_gelu)
PLAIN_OPS = _Ops(linear_plain, attention_plain, ln_gelu_plain)


def supports(layers_params, n0: int, n1: int, act_dtype, tp_axis=None) -> bool:
    """The JAX kernel's gate (layer_stack.py:750-759): no tensor parallelism,
    both buckets multiples of 128 and at most 1024, fp32 or bf16 activations."""
    if tp_axis is not None:
        return False
    if max(n0, n1) > MAX_SEQ or n0 % 128 or n1 % 128:
        return False
    return act_dtype in (torch.bfloat16, torch.float32)


def _run_stack(layers, d0, d1, freqs0, freqs1, lengths0, lengths1, *,
               num_heads, stat_dtype, attn_dtype, ops: _Ops):
    if "w_q" in layers["self_attn"]["qkv"]:
        raise NotImplementedError("int8 / W8A8 layer weights are queued for a later slice")
    e = d0.shape[-1]
    n_layers = layers["self_attn"]["ln_g"].shape[0]
    attn_dtype = attn_dtype or d0.dtype
    lens = (None, None) if lengths0 is None else (lengths0, lengths1)
    freqs = (freqs0.float(), freqs1.float())
    sp, cp = layers["self_attn"], layers["cross_attn"]

    def lin(p, name, l, x, a2=None, residual=None):
        return ops.linear(x, p[name]["w"][l].to(attn_dtype), p[name]["b"][l],
                          a2=a2, residual=residual)

    def ffn(p, l, x, message):
        h = lin(p, "ffn1", l, x, a2=message)
        act = ops.ln_gelu(h, p["ln_g"][l], p["ln_b"][l])
        return lin(p, "ffn2", l, act, residual=x)

    def attend(q, k, v, f, lq, lk):
        return ops.attention(q.to(attn_dtype), k.to(attn_dtype), v.to(attn_dtype),
                             f, lq, lk, num_heads, stat_dtype, d0.dtype)

    x = [d0, d1]
    for l in range(n_layers):
        for i in (0, 1):  # self block, per image (the buckets may differ)
            qkv = lin(sp, "qkv", l, x[i])  # (B, N, 3E) = [q | k | v]
            ctx = attend(qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:],
                         freqs[i], lens[i], lens[i])
            x[i] = ffn(sp, l, x[i], lin(sp, "out", l, ctx))
        qk_v = [lin(cp, "qk_v", l, x[i]) for i in (0, 1)]  # (B, N, 2E) = [qk | v]
        qk = [t[..., :e] for t in qk_v]
        v = [t[..., e:] for t in qk_v]
        msgs = (
            attend(qk[0], qk[1], v[1], None, lens[0], lens[1]),
            attend(qk[1], qk[0], v[0], None, lens[1], lens[0]),
        )
        x = [ffn(cp, l, x[i], lin(cp, "out", l, msgs[i])) for i in (0, 1)]
    return x[0], x[1]


def transformer_stack(
    layers,
    d0: torch.Tensor,
    d1: torch.Tensor,
    freqs0: torch.Tensor,
    freqs1: torch.Tensor,
    lengths0: Optional[torch.Tensor],
    lengths1: Optional[torch.Tensor],
    *,
    num_heads: int,
    head_dim: int,
    stat_dtype=torch.float32,
    attn_dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run all stacked LightGlue layers.

    Args:
      layers: the port's ``params["layers"]`` (see runtime/weights.py:
        params_from_numpy), leading layer axis L.
      d0/d1: (B, N0, E) / (B, N1, E) descriptors (buckets may differ).
      freqs0/freqs1: (B, 2, N, D) fp32 rope [cos; sin] (tiled per half).
      lengths0/lengths1: optional (B,) true keypoint counts.
    Returns (d0', d1') of the same shapes.
    """
    if head_dim != HEAD_DIM and d0.device.type != "cpu":
        raise NotImplementedError(f"head_dim {head_dim}: the kernel takes {HEAD_DIM}")
    return _run_stack(layers, d0, d1, freqs0, freqs1, lengths0, lengths1,
                      num_heads=num_heads, stat_dtype=stat_dtype,
                      attn_dtype=attn_dtype, ops=KERNEL_OPS)


def transformer_stack_plain(layers, d0, d1, freqs0, freqs1, lengths0, lengths1,
                            *, num_heads, head_dim, stat_dtype=torch.float32,
                            attn_dtype=None):
    """``transformer_stack`` on the plain versions, on any device."""
    return _run_stack(layers, d0, d1, freqs0, freqs1, lengths0, lengths1,
                      num_heads=num_heads, stat_dtype=stat_dtype,
                      attn_dtype=attn_dtype, ops=PLAIN_OPS)
