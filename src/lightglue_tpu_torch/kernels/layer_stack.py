"""The LightGlue layer stack on four hand-written kernels.

Counterpart of ``lightglue_tpu/kernels/layer_stack.py:transformer_stack``
(wrapper :801, pallas_call :894, body :121-748, fixed-depth branch) and of
``transformer_stack_adaptive`` (wrapper :974, pallas_call :1229, the
adaptive branches of the same body). The TPU kernel keeps a pair's
activations in VMEM across all layers in one pallas_call; here a Python
loop over the layers launches, per layer and image, the kernels of
``csrc/``:

- ``linear`` (``csrc/linear.cu``): every projection — fused qkv, the cross
  block's fused [qk | v], the out projections, ffn1 over cat(x, message)
  taken as two operands, ffn2 with its residual add. Bound by bytes at the
  path's shapes (a 1024-row product moves 1.2-2.6 MB). bf16 operands run a
  pipelined ``mma.sync`` GEMM (64-deep K chunks in a 3-buffer ``cp.async``
  ring, fp32 sums in registers) at the tile ``linear_plan`` gives: at least
  256 blocks at 1024 rows, tiles of at most 64 rows so none straddles two
  pairs. The epilogue is JAX ``_linear``'s: round to T, add the bias in T,
  add the residual in T.
- ``attention`` (``csrc/attention.cu``): masked self-attention with RoPE and
  both cross-attention directions (one launch each), one softmax over the
  whole row (N <= 1024). Bound by the tensor cores (1.07 GFLOP per call at
  B = 1, H = 4, N = 1024). bf16 operands run ``flash_attn.cu``'s machinery
  (``csrc/mma.cuh``) at one tile of Nk keys: two passes (row max, then p,
  sum p and P.V), at the row groups ``attention_plan`` gives; RoPE first,
  once, into a scratch. It keeps the stack's contract where the flash
  kernel's differs: acc is never rounded (P.V / l in fp32, one cast to T),
  the row max is clamped at -5e29 when masked, dead columns are -1e30 in
  every chunk under keep masks, keep and liveness operands stay.
- ``ln_gelu`` (``csrc/ln_gelu.cu``): the FFN's LayerNorm + GELU;
- ``adaptive_decide`` (``csrc/adaptive.cu``, adaptive stack only): after
  each layer, the early-exit and pruning decision of every live pair.

fp32 operands (the FP32 rung) run FMA kernels in ``linear.cu`` and
``attention.cu``: one TF32 ``mma`` would miss the rung's 1e-4 gate.

The adaptive stack carries a per-pair exit register (B,) fp32 and, under
width pruning, (B, N) fp32 keep masks, both on the device. The three layer
kernels take the register and the global layer index (``Live``) and skip
retired pairs; attention takes the keep masks in place of the lengths. The
layer loop reads nothing back to the host.

Each wrapper launches its kernel on a CUDA tensor and runs its plain PyTorch
version (``*_plain``) on a CPU tensor; ``transformer_stack_plain`` and
``transformer_stack_adaptive_plain`` run the same loops on the plain
versions on any device. Rounding follows the JAX kernel's points exactly
(see each kernel's header).
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

# csrc/mma.cuh: keys per staged chunk, warps of an attention block, bf16 row
# pitch in shared memory, fp32 record per warp row, blocks a launch aims for
_KC, _WARPS, _LD, _RS, _FILL_BLOCKS = 64, 4, HEAD_DIM + 8, 2 + HEAD_DIM + 8, 256
# csrc/linear.cu: the bf16 GEMM's K chunk, ring buffers, candidate tiles in
# order of preference and the blocks a tile plan aims for (two per SM)
_LIN_BK, _LIN_STAGES, _LIN_TILES, _LIN_MIN_BLOCKS = 64, 3, ((64, 64), (64, 32), (32, 32)), 256


def fill_row_groups(batch: int, heads: int, nq: int) -> int:
    """16-row groups per block of the bf16 attention kernels (4, 2 or 1):
    the most that still give ``_FILL_BLOCKS`` blocks, else 1, whose four
    warps then split each 64-key chunk (csrc/mma.cuh:fill_row_groups)."""
    for groups in (4, 2):
        if batch * heads * -(-nq // (16 * groups)) >= _FILL_BLOCKS:
            return groups
    return 1


def mma_smem(row_groups: int, stages: int) -> int:
    """Dynamic shared memory of a bf16 attention block: Q, ``stages`` K and
    V chunks, and (columns split) the warps' partial row max, sum p and P.V
    (csrc/mma.cuh:mma_smem)."""
    smem = 2 * (16 * row_groups + 2 * _KC * stages) * _LD
    if row_groups < _WARPS:
        smem += 4 * _WARPS * 16 * _RS
    return smem


class AttentionPlan(NamedTuple):
    """Launch of ``csrc/attention.cu`` for one shape."""

    row_groups: int  # 16-row groups per block (bf16: 4, 2 or 1; fp32: 1)
    col_split: int   # warps of a row group that split each chunk's keys
    blocks: int      # blocks of the launch
    smem: int        # dynamic shared memory per block, bytes


def attention_plan(batch: int, heads: int, nq: int, nk: int,
                   dtype=torch.bfloat16) -> AttentionPlan:
    """The stack attention's launch: bf16 operands at ``fill_row_groups``
    with two K/V chunk buffers (the whole row streams through them, so any
    Nk fits), fp32 operands one 16-row block with a 16 x Nk slab of S.
    Raises past the contract's N <= 1024 or the card's shared memory."""
    if nk > MAX_SEQ:
        raise ValueError(f"attention: {nk} keys exceed the layer stack's {MAX_SEQ}")
    if dtype == torch.bfloat16:
        groups = fill_row_groups(batch, heads, nq)
        smem = mma_smem(groups, 2)
        plan = AttentionPlan(groups, _WARPS // groups,
                             batch * heads * -(-nq // (16 * groups)), smem)
    else:
        plan = AttentionPlan(1, 1, batch * heads * -(-nq // 16),
                             4 * (16 * HEAD_DIM + _KC * (HEAD_DIM + 1) + 16 * nk + 16))
    if plan.smem > _build.MAX_DYNAMIC_SMEM:
        raise ValueError(f"attention: {plan.smem} B of shared memory for {nk} keys")
    return plan


class LinearPlan(NamedTuple):
    """Launch of ``csrc/linear.cu``'s bf16 GEMM for one shape."""

    bm: int      # tile rows (a divisor of 64: a tile never straddles two pairs)
    bn: int      # tile columns
    bk: int      # K depth of a staged chunk
    chunks: int  # K chunks a block runs through
    stages: int  # chunk buffers in the cp.async ring
    blocks: int  # blocks of the launch
    smem: int    # dynamic shared memory per block, bytes


def linear_plan(m: int, n: int, k: int) -> LinearPlan:
    """The bf16 GEMM's tile for an (m, k) x (k, n) product: 64 x 64 where
    that gives 256 blocks, else 64 x 32, else 32 x 32
    (csrc/linear.cu:linear_tile)."""
    for bm, bn in _LIN_TILES:
        blocks = -(-m // bm) * (n // bn)
        if blocks >= _LIN_MIN_BLOCKS:
            break
    smem = 2 * _LIN_STAGES * (bm * (_LIN_BK + 8) + _LIN_BK * (bn + 8))
    return LinearPlan(bm, bn, _LIN_BK, -(-k // _LIN_BK), _LIN_STAGES, blocks, smem)


class Live(NamedTuple):
    """Liveness operand of the layer kernels: pair b runs global layer
    ``layer`` iff ``exit[b] > layer`` (the Pallas kernel's pl.when(live))."""

    exit: torch.Tensor  # (B,) fp32 exit register
    layer: int          # global layer index


def _live_args(live: Optional[Live], rows_per_pair: int):
    if live is None:
        return None, 0, 1
    if live.exit.dtype != torch.float32 or not live.exit.is_contiguous():
        raise ValueError("exit register must be contiguous fp32")
    return live.exit.data_ptr(), live.layer, rows_per_pair


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


def linear_plain(a, w, b, a2=None, residual=None, live: Optional[Live] = None):
    """[a | a2] @ w + b (+ residual): fp32 accumulation of w-dtype operands,
    cast to a's dtype, bias added in a's dtype, residual added in a's dtype.
    With ``live`` and a residual, a retired pair's rows are the residual."""
    x = a if a2 is None else torch.cat([a, a2], dim=-1)
    y = (x.to(w.dtype).float() @ w.float()).to(a.dtype) + b.to(a.dtype)
    if residual is None:
        return y
    y = y + residual
    if live is not None:
        y = torch.where((live.exit > live.layer).view(-1, 1, 1), y, residual)
    return y


def linear(a, w, b, a2=None, residual=None, live: Optional[Live] = None):
    """Y = [a | a2] @ w + b (+ residual) over the last dim.

    Args:
      a: (..., K1) activations; a2: optional (..., K - K1) second operand
        (the concat is never materialised); w: (K, N); b: (N,);
        residual: optional (..., N). On the card all share one dtype.
      live: optional liveness operand; then ``a`` is (B, N, K1) and a
        retired pair's rows are skipped (unwritten) or, with a residual,
        copied from it.
    """
    if a.device.type == "cpu":
        return linear_plain(a, w, b, a2, residual, live)
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
    rows = a.shape[1] if a.dim() == 3 else m
    if live is not None and (a.dim() != 3 or rows % 64 or live.exit.shape != (a.shape[0],)):
        raise ValueError(f"linear: liveness needs (B, N % 64 == 0, K) rows, got {a.shape}")
    y = torch.empty((*lead, n), dtype=a.dtype, device=a.device)
    err = _build.lib().lg_linear(
        a.data_ptr(), None if a2 is None else a2.data_ptr(), k1,
        w.data_ptr(), b.data_ptr(),
        None if residual is None else residual.data_ptr(), y.data_ptr(),
        m, n, k, *_live_args(live, rows), _is_bf16(a), _stream(a),
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


def rotate_half(t: torch.Tensor) -> torch.Tensor:
    """Half-split rotation: (..., [x, y]) halves -> (..., [-y, x])."""
    half = t.shape[-1] // 2
    return torch.cat([-t[..., half:], t[..., :half]], dim=-1)


def apply_rotary(freqs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Half-split RoPE: t*cos + rotate_half(t)*sin with freqs (B, 2, N, D)
    [cos; sin] cast to t's dtype, onto (B, H, N, D) heads (JAX
    models/lightglue.py:131-149)."""
    cos = freqs[:, 0, None].to(t.dtype)
    sin = freqs[:, 1, None].to(t.dtype)
    return t * cos + rotate_half(t) * sin


def attention_plain(q, k, v, freqs, len_q, len_kv, num_heads, stat_dtype,
                    out_dtype=None, keep_q=None, keep_kv=None,
                    live: Optional[Live] = None):
    """Masked multi-head attention with the reference's rounding points.

    q: (B, Nq, H*D), k/v: (B, Nk, H*D) in the operand dtype; freqs:
    (B, 2, N, D) fp32 or None; len_q/len_kv: (B,) ints or None;
    keep_q/keep_kv: (B, Nq)/(B, Nk) fp32 0/1 keep masks, which replace the
    lengths. The fp32 result is cast once to ``out_dtype`` (default: the
    operand dtype). ``live`` changes nothing here: a retired pair's rows
    are computed, where the kernel leaves them unwritten."""
    bsz, nq, e = q.shape
    nk = k.shape[1]
    d = e // num_heads
    dt = q.dtype

    def heads(t, n):
        return t.reshape(bsz, n, num_heads, d).transpose(1, 2)  # (B, H, N, D)

    qh, kh, vh = heads(q, nq), heads(k, nk), heads(v, nk)
    if freqs is not None:
        qh, kh = apply_rotary(freqs, qh), apply_rotary(freqs, kh)
    s = _quant((qh.float() @ kh.float().transpose(-1, -2)) * (1.0 / math.sqrt(d)),
               stat_dtype)
    keep = keep_q is not None
    masked = len_q is not None or keep
    if keep:
        s = torch.where(keep_kv.view(bsz, 1, 1, nk) >= 0.5, s, _NEG_INF)
    elif masked:
        cols = torch.arange(nk, device=q.device)
        s = torch.where(cols < len_kv.view(-1, 1, 1, 1), s, _NEG_INF)
    m = _quant(s.amax(dim=-1, keepdim=True), stat_dtype)
    if masked:
        m = m.clamp_min(_DEAD)
    p = _quant(torch.exp(s - m), stat_dtype)
    l = _quant(p.sum(dim=-1, keepdim=True), stat_dtype)
    o = (p.to(dt).float() @ vh.float()) / torch.where(l == 0.0, 1.0, l)
    if keep:
        o = o * keep_q.view(bsz, 1, nq, 1)
    elif masked:
        rows = torch.arange(nq, device=q.device)[:, None]
        o = torch.where(rows < len_q.view(-1, 1, 1, 1), o, 0.0)
    return o.transpose(1, 2).reshape(bsz, nq, e).to(out_dtype or dt)


def attention(q, k, v, freqs, len_q, len_kv, num_heads, stat_dtype,
              out_dtype=None, keep_q=None, keep_kv=None,
              live: Optional[Live] = None):
    """Multi-head attention over (B, N, H*64) rows, heads in column blocks.

    q, k, v may be column slices of a wider projection (any batch and row
    stride, unit column stride). ``freqs`` (B, 2, N, 64) turns on half-split
    RoPE for q and k (self-attention, Nq == Nk); ``len_q``/``len_kv`` (B,)
    mask padded rows/columns (both or neither). ``keep_q``/``keep_kv``
    (B, Nq)/(B, Nk) fp32 0/1 (both or neither) mask by width pruning's keep
    vectors instead: kv columns < 0.5 are masked and output rows are scaled
    by their keep. ``live`` skips retired pairs (their rows stay unwritten).
    Returns (B, Nq, H*64) in ``out_dtype``, which on the card must be the
    operand dtype. On the card Nk <= 1024 (``attention_plan``); with bf16
    operands and RoPE, q and k are rotated once into a scratch first, and
    the pair of launches counts as one."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, freqs, len_q, len_kv, num_heads,
                               stat_dtype, out_dtype, keep_q, keep_kv, live)
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
    attention_plan(bsz, num_heads, nq, nk, q.dtype)  # raises where the launch cannot run
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
    if (keep_q is None) != (keep_kv is None):
        raise ValueError("attention: pass both keep masks or neither")
    if keep_q is not None:
        if keep_q.shape != (bsz, nq) or keep_kv.shape != (bsz, nk):
            raise ValueError(f"attention: keep masks {keep_q.shape} {keep_kv.shape}")
        if keep_q.dtype != torch.float32 or keep_kv.dtype != torch.float32:
            raise ValueError("attention: keep masks must be fp32")
        keep_q, keep_kv = keep_q.contiguous(), keep_kv.contiguous()
    if live is not None and live.exit.shape != (bsz,):
        raise ValueError(f"attention: exit register {tuple(live.exit.shape)} for B={bsz}")
    out = torch.empty((bsz, nq, e), dtype=q.dtype, device=q.device)
    if freqs is not None and q.dtype == torch.bfloat16:
        # RoPE once per row into a scratch (2, B, N, E), which the kernel reads
        rot = torch.empty((2, bsz, nq, e), dtype=q.dtype, device=q.device)
        err = _build.lib().lg_rope_qk(q.data_ptr(), q.stride(0), q.stride(1),
                                      k.data_ptr(), k.stride(0), k.stride(1),
                                      freqs.data_ptr(), rot.data_ptr(), bsz, nq, num_heads,
                                      _stream(q))
        _build.check(err, "attention (RoPE)")
        q, k, freqs = rot[0], rot[1], None
    err = _build.lib().lg_attention(
        q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(1),
        v.data_ptr(), v.stride(0), v.stride(1),
        None if freqs is None else freqs.data_ptr(),
        None if len_q is None else len_q.data_ptr(),
        None if len_kv is None else len_kv.data_ptr(),
        None if keep_q is None else keep_q.data_ptr(),
        None if keep_kv is None else keep_kv.data_ptr(),
        *_live_args(live, nq)[:2],
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


def ln_gelu_plain(h, g, b, live: Optional[Live] = None):
    """``live`` changes nothing here (the kernel leaves retired rows
    unwritten)."""
    hf = h.float()
    mean = hf.mean(dim=-1, keepdim=True)
    var = (hf * hf).mean(dim=-1, keepdim=True) - mean * mean
    n = (hf - mean) * torch.rsqrt(var + 1e-5) * g.float() + b.float()
    return (0.5 * n * (1.0 + torch.erf(n * (1.0 / math.sqrt(2.0))))).to(h.dtype)


def ln_gelu(h, g, b, live: Optional[Live] = None):
    """GELU(LayerNorm(h) * g + b) over the last dim (<= 512), fp32 math,
    result in h's dtype. With ``live``, h is (B, N, C) and a retired pair's
    rows stay unwritten."""
    if h.device.type == "cpu":
        return ln_gelu_plain(h, g, b, live)
    _check_same("ln_gelu", h.dtype, h, g, b)
    c = h.shape[-1]
    if c > 512 or g.shape != (c,) or b.shape != (c,):
        raise ValueError(f"ln_gelu: width {c} (<= 512), gamma/beta {g.shape}")
    if not (h.is_contiguous() and g.is_contiguous() and b.is_contiguous()):
        raise ValueError("ln_gelu: operands must be contiguous")
    if live is not None and (h.dim() != 3 or live.exit.shape != (h.shape[0],)):
        raise ValueError(f"ln_gelu: liveness needs (B, N, C) rows, got {h.shape}")
    y = torch.empty_like(h)
    err = _build.lib().lg_ln_gelu(
        h.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
        h.numel() // c, c, *_live_args(live, h.shape[1] if h.dim() == 3 else 1),
        _is_bf16(h), _stream(h),
    )
    _build.check(err, "ln_gelu")
    ln_gelu.launches += 1
    return y


ln_gelu.launches = 0


# ---------------------------------------------------------------------------
# the adaptive decision
# ---------------------------------------------------------------------------


def _logit(p: float) -> float:
    return math.log(p) - math.log(1.0 - p)


def token_logit_threshold(layer: int, n_layers: int) -> float:
    """logit(th) of the early-exit schedule th = clip(0.8 + 0.1 exp(-4 g / L))
    at global layer g (layer_stack.py:592-599); th <= 0.9, so the logit is
    finite. The token head's bias is subtracted on the device."""
    th = min(max(0.8 + 0.1 * math.exp(-4.0 * layer / n_layers), 0.0), 1.0)
    return _logit(th)


def _decide_checks(x0, x1, w_tok, b_tok, exit, lengths0, lengths1, w_match, b_match,
                   keep0, keep1):
    bsz, n0, e = x0.shape
    n1 = x1.shape[1]
    if x1.shape != (bsz, n1, e) or w_tok.shape != (e,) or exit.shape != (bsz,):
        raise ValueError(f"adaptive_decide: x {x0.shape} {x1.shape}, w_tok {w_tok.shape}, "
                         f"exit {exit.shape}")
    if (w_match is None) != (keep0 is None) or (keep0 is None) != (keep1 is None):
        raise ValueError("adaptive_decide: width needs w_match, b_match, keep0 and keep1")
    if (lengths0 is None) != (lengths1 is None):
        raise ValueError("adaptive_decide: pass both lengths or neither")
    for t in (exit, b_tok, b_match, keep0, keep1):
        if t is not None and (t.dtype != torch.float32 or not t.is_contiguous()):
            raise ValueError("adaptive_decide: exit, biases and keep masks are contiguous fp32")
    if keep0 is not None and (keep0.shape != (bsz, n0) or keep1.shape != (bsz, n1)):
        raise ValueError(f"adaptive_decide: keep masks {keep0.shape} {keep1.shape}")


def adaptive_decide_plain(x0, x1, w_tok, b_tok, exit, *, layer: int, n_layers: int,
                          depth_confidence: float, lengths0=None, lengths1=None,
                          w_match=None, b_match=None, width_confidence: float = -1.0,
                          keep0=None, keep1=None) -> None:
    """``adaptive_decide`` in plain PyTorch: the same arithmetic, in place."""
    _decide_checks(x0, x1, w_tok, b_tok, exit, lengths0, lengths1, w_match, b_match,
                   keep0, keep1)
    live = exit > layer
    if layer == n_layers - 1:
        exit.copy_(torch.where(live, float(n_layers), exit))
        return

    def logits(x, w):  # operands in w's dtype, fp32 sums
        return x.to(w.dtype).float() @ w.float()

    # Python scalars meet fp32 tensors in fp32, as the kernel's float
    # arguments do (and a graph capture may not copy a host tensor)
    thr = token_logit_threshold(layer, n_layers) - b_tok.reshape(())
    lgt = (logits(x0, w_tok), logits(x1, w_tok))
    if keep0 is not None:
        valid = (keep0 >= 0.5, keep1 >= 0.5)
    elif lengths0 is not None:
        valid = tuple(torch.arange(x.shape[1], device=x.device)[None] < n.view(-1, 1)
                      for x, n in ((x0, lengths0), (x1, lengths1)))
    else:
        valid = (torch.ones_like(lgt[0], dtype=torch.bool),
                 torch.ones_like(lgt[1], dtype=torch.bool))
    cnt = sum(((g >= thr) & v).sum(-1, dtype=torch.int32) for g, v in zip(lgt, valid))
    total = sum(v.sum(-1, dtype=torch.int32) for v in valid).clamp_min(1)
    stop = live & (cnt.float() / total.float() > depth_confidence)
    exit.copy_(torch.where(stop, float(layer + 1), exit))
    if keep0 is None:
        return
    mthr = _logit(1.0 - width_confidence) - b_match.reshape(())
    prune = (live & ~stop).view(-1, 1)
    for keep, x, g in ((keep0, x0, lgt[0]), (keep1, x1, lgt[1])):
        upd = (logits(x, w_match) > mthr) | (g <= thr)
        keep.copy_(torch.where(prune & ~upd, 0.0, keep))


def adaptive_decide(x0, x1, w_tok, b_tok, exit, *, layer: int, n_layers: int,
                    depth_confidence: float, lengths0=None, lengths1=None,
                    w_match=None, b_match=None, width_confidence: float = -1.0,
                    keep0=None, keep1=None) -> None:
    """Early-exit and pruning decision of every live pair after global layer
    ``layer`` of an ``n_layers`` stack; updates ``exit`` and the keep masks
    IN PLACE (they are the stack's device-resident state).

    Args:
      x0/x1: (B, N0, E) / (B, N1, E) activations after the layer.
      w_tok: (E,) token-confidence head in the attention operand dtype;
        b_tok: its fp32 bias, one element.
      exit: (B,) fp32 exit register; a pair is live iff exit > layer. A
        pair whose confident share of valid tokens exceeds
        ``depth_confidence`` gets exit = layer + 1; at the last layer every
        live pair gets exit = n_layers.
      lengths0/lengths1: (B,) valid prefixes when masked (depth-only), or
        None (unmasked: every row is valid).
      w_match/b_match/keep0/keep1: width pruning — the matchability head
        and the (B, N) fp32 0/1 keep masks, which then define validity;
        a live pair that did not stop retires tokens that are confident and
        not matchable at ``width_confidence``.
    """
    if x0.device.type == "cpu":
        return adaptive_decide_plain(
            x0, x1, w_tok, b_tok, exit, layer=layer, n_layers=n_layers,
            depth_confidence=depth_confidence, lengths0=lengths0, lengths1=lengths1,
            w_match=w_match, b_match=b_match, width_confidence=width_confidence,
            keep0=keep0, keep1=keep1)
    _check_same("adaptive_decide", x0.dtype, x0, x1, w_tok, w_match)
    _decide_checks(x0, x1, w_tok, b_tok, exit, lengths0, lengths1, w_match, b_match,
                   keep0, keep1)
    bsz, n0, e = x0.shape
    n1 = x1.shape[1]
    if n0 > MAX_SEQ or n1 > MAX_SEQ or not (x0.is_contiguous() and x1.is_contiguous()):
        raise ValueError(f"adaptive_decide: contiguous rows, N <= {MAX_SEQ}: {n0} {n1}")
    if lengths0 is not None:
        lengths0 = lengths0.to(torch.int32).contiguous()
        lengths1 = lengths1.to(torch.int32).contiguous()
    width = keep0 is not None
    err = _build.lib().lg_adaptive_decide(
        x0.data_ptr(), x1.data_ptr(), bsz, n0, n1, e,
        w_tok.data_ptr(), b_tok.data_ptr(), token_logit_threshold(layer, n_layers),
        w_match.data_ptr() if width else None, b_match.data_ptr() if width else None,
        _logit(1.0 - width_confidence) if width else 0.0,
        None if lengths0 is None else lengths0.data_ptr(),
        None if lengths1 is None else lengths1.data_ptr(),
        keep0.data_ptr() if width else None, keep1.data_ptr() if width else None,
        exit.data_ptr(), layer, n_layers, depth_confidence, _is_bf16(x0), _stream(x0),
    )
    _build.check(err, "adaptive_decide")
    adaptive_decide.launches += 1


adaptive_decide.launches = 0


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------


class _Ops(NamedTuple):
    linear: Callable
    attention: Callable
    ln_gelu: Callable
    decide: Callable


KERNEL_OPS = _Ops(linear, attention, ln_gelu, adaptive_decide)
PLAIN_OPS = _Ops(linear_plain, attention_plain, ln_gelu_plain, adaptive_decide_plain)


def supports(layers_params, n0: int, n1: int, act_dtype, tp_axis=None) -> bool:
    """The JAX kernel's gate (layer_stack.py:750-759): no tensor parallelism,
    both buckets multiples of 128 and at most 1024, fp32 or bf16 activations."""
    if tp_axis is not None:
        return False
    if max(n0, n1) > MAX_SEQ or n0 % 128 or n1 % 128:
        return False
    return act_dtype in (torch.bfloat16, torch.float32)


class _Adaptive:
    """Device-resident state of the adaptive stack: the exit register, the
    keep masks (width only) and the per-layer heads; ``decide`` runs after
    each layer."""

    def __init__(self, token, match, exit, keep, lengths, *, layer_offset, n_layers,
                 depth_confidence, width_confidence, attn_dtype):
        self.exit, self.keep, self.lengths = exit, keep, lengths
        self.layer_offset, self.n_layers = layer_offset, n_layers
        self.depth_confidence, self.width_confidence = depth_confidence, width_confidence
        # (P, E, 1) heads -> (P, E) rows in the operand dtype, fp32 biases
        self.tok_w = token["w"][..., 0].to(attn_dtype).contiguous()
        self.tok_b = token["b"].reshape(-1).float().contiguous()
        self.match_w = self.match_b = None
        if keep is not None:
            self.match_w = match["w"][..., 0].to(attn_dtype).contiguous()
            self.match_b = match["b"].reshape(-1).float().contiguous()

    def live(self, l: int) -> Live:
        return Live(self.exit, self.layer_offset + l)

    def decide(self, ops: _Ops, l: int, x0, x1) -> None:
        # the last layer of the stack has no token head: its slot is never
        # read (the decision only forces the exit there), so the last given
        # head stands in, as the JAX wrapper pads it
        t = min(l, self.tok_w.shape[0] - 1)
        width = self.keep is not None
        ops.decide(
            x0, x1, self.tok_w[t], self.tok_b[t:t + 1], self.exit,
            layer=self.layer_offset + l, n_layers=self.n_layers,
            depth_confidence=self.depth_confidence,
            lengths0=self.lengths[0], lengths1=self.lengths[1],
            w_match=self.match_w[l] if width else None,
            b_match=self.match_b[l:l + 1] if width else None,
            width_confidence=self.width_confidence,
            keep0=self.keep[0] if width else None, keep1=self.keep[1] if width else None,
        )


def _run_stack(layers, d0, d1, freqs0, freqs1, lengths0, lengths1, *,
               num_heads, stat_dtype, attn_dtype, ops: _Ops,
               adaptive: Optional[_Adaptive] = None):
    if "w_q" in layers["self_attn"]["qkv"]:
        raise NotImplementedError("int8 / W8A8 layer weights are queued for a later slice")
    e = d0.shape[-1]
    n_layers = layers["self_attn"]["ln_g"].shape[0]
    attn_dtype = attn_dtype or d0.dtype
    lens = (None, None) if lengths0 is None else (lengths0, lengths1)
    keep = (None, None) if adaptive is None or adaptive.keep is None else adaptive.keep
    freqs = (freqs0.float(), freqs1.float())
    sp, cp = layers["self_attn"], layers["cross_attn"]

    def lin(p, name, l, x, a2=None, residual=None):
        return ops.linear(x, p[name]["w"][l].to(attn_dtype), p[name]["b"][l],
                          a2=a2, residual=residual, live=live)

    def ffn(p, l, x, message):
        h = lin(p, "ffn1", l, x, a2=message)
        act = ops.ln_gelu(h, p["ln_g"][l], p["ln_b"][l], live=live)
        return lin(p, "ffn2", l, act, residual=x)

    def attend(q, k, v, f, i, j):  # rows of image i attend to image j
        return ops.attention(q.to(attn_dtype), k.to(attn_dtype), v.to(attn_dtype),
                             f, lens[i], lens[j], num_heads, stat_dtype, d0.dtype,
                             keep_q=keep[i], keep_kv=keep[j], live=live)

    x = [d0, d1]
    for l in range(n_layers):
        live = None if adaptive is None else adaptive.live(l)
        for i in (0, 1):  # self block, per image (the buckets may differ)
            qkv = lin(sp, "qkv", l, x[i])  # (B, N, 3E) = [q | k | v]
            ctx = attend(qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:], freqs[i], i, i)
            x[i] = ffn(sp, l, x[i], lin(sp, "out", l, ctx))
        qk_v = [lin(cp, "qk_v", l, x[i]) for i in (0, 1)]  # (B, N, 2E) = [qk | v]
        qk = [t[..., :e] for t in qk_v]
        v = [t[..., e:] for t in qk_v]
        msgs = (attend(qk[0], qk[1], v[1], None, 0, 1),
                attend(qk[1], qk[0], v[0], None, 1, 0))
        x = [ffn(cp, l, x[i], lin(cp, "out", l, msgs[i])) for i in (0, 1)]
        if adaptive is not None:
            adaptive.decide(ops, l, x[0], x[1])
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


def _run_adaptive(layers, token, d0, d1, freqs0, freqs1, lengths0, lengths1, match,
                  exit_in, *, num_heads, depth_confidence, width_confidence, layer_offset,
                  total_layers, stat_dtype, attn_dtype, masked, ops: _Ops):
    bsz, dev = d0.shape[0], d0.device
    phase_layers = layers["self_attn"]["ln_g"].shape[0]
    n_layers = layer_offset + phase_layers if total_layers is None else int(total_layers)
    attn_dtype = attn_dtype or d0.dtype
    lens = (lengths0.to(dev, torch.int32), lengths1.to(dev, torch.int32))
    # "still running": any value above n_layers; the last layer forces a real
    # exit, so only a call that ends before the stack's last layer (the
    # downshift's first phase) returns it
    if exit_in is None:
        exit = torch.full((bsz,), n_layers + 1.0, dtype=torch.float32, device=dev)
    else:
        exit = exit_in.to(dev, torch.float32).clone()
    width = match is not None and width_confidence > 0
    keep = None
    if width:  # cumulative keep masks, seeded with the valid prefix
        keep = tuple((torch.arange(x.shape[1], device=dev)[None] < n[:, None]).float()
                     for x, n in ((d0, lens[0]), (d1, lens[1])))
    # width masks by the keep vectors alone; unmasked (full buckets) by nothing
    stack_lens = lens if masked and not width else (None, None)
    state = _Adaptive(
        token, match, exit, keep, stack_lens, layer_offset=layer_offset,
        n_layers=n_layers, depth_confidence=depth_confidence,
        width_confidence=width_confidence, attn_dtype=attn_dtype)
    o0, o1 = _run_stack(layers, d0, d1, freqs0, freqs1, *stack_lens,
                        num_heads=num_heads, stat_dtype=stat_dtype, attn_dtype=attn_dtype,
                        ops=ops, adaptive=state)
    out = (o0, o1, exit.to(torch.int32))
    return out + keep if width else out


def transformer_stack_adaptive(
    layers, token, d0, d1, freqs0, freqs1, lengths0, lengths1, match=None, exit_in=None,
    *, num_heads: int, head_dim: int, depth_confidence: float,
    width_confidence: float = -1.0, layer_offset: int = 0,
    total_layers: Optional[int] = None, stat_dtype=torch.float32, attn_dtype=None,
    masked: bool = True,
):
    """All layers with adaptive depth (early exit) and, with ``match``, width
    pruning, every decision on the device.

    After each layer ``adaptive_decide`` evaluates the token-confidence head
    of every live pair in logit space and writes its exit register; the
    next layer's kernels skip pairs whose register is at or below the
    global layer index, so a retired pair's activations stay frozen. Width
    pruning keeps (B, N) 0/1 masks that mask retired tokens out of every
    attention from the next layer on; compaction happens once, outside.

    Args:
      layers: the port's ``params["layers"]`` for the layers of THIS call
        (a downshift phase passes a slice).
      token: {"w": (P, E, 1), "b": (P, 1)} token heads of this call's
        layers; the stack's last layer has none, and its slot is not read.
      d0/d1, freqs0/freqs1: as ``transformer_stack``.
      lengths0/lengths1: (B,) true keypoint counts (required).
      match: {"w": (P, E, 1), "b": (P, 1)} matchability heads; together
        with ``width_confidence > 0`` this turns on width pruning.
      exit_in: (B,) exit values from an earlier phase (int or float): a
        pair with exit <= layer_offset retired there and passes through;
        the sentinel (> total_layers) marks a pair still running. The JAX
        kernel takes a 0/1 flag here and compares against the LOCAL layer
        index; this one keeps global indices in every phase.
      depth_confidence: stop when the confident share of valid tokens
        exceeds it (width-only passes 2.0, never reached).
      layer_offset/total_layers: global index of this call's first layer
        and the stack's depth (thresholds and the forced last-layer exit).
      masked: False is the unmasked full-bucket variant (depth-only).

    Returns:
      (d0', d1', exit (B,) int32) and, with width, (..., keep0, keep1):
      (B, N) fp32 0/1 masks at each pair's exit (the JAX kernel returns them
      replicated over 128 lanes).
    """
    if head_dim != HEAD_DIM and d0.device.type != "cpu":
        raise NotImplementedError(f"head_dim {head_dim}: the kernel takes {HEAD_DIM}")
    return _run_adaptive(
        layers, token, d0, d1, freqs0, freqs1, lengths0, lengths1, match, exit_in,
        num_heads=num_heads, depth_confidence=depth_confidence,
        width_confidence=width_confidence, layer_offset=layer_offset,
        total_layers=total_layers, stat_dtype=stat_dtype, attn_dtype=attn_dtype,
        masked=masked, ops=KERNEL_OPS)


def transformer_stack_adaptive_plain(
    layers, token, d0, d1, freqs0, freqs1, lengths0, lengths1, match=None, exit_in=None,
    *, num_heads: int, head_dim: int, depth_confidence: float,
    width_confidence: float = -1.0, layer_offset: int = 0,
    total_layers: Optional[int] = None, stat_dtype=torch.float32, attn_dtype=None,
    masked: bool = True,
):
    """``transformer_stack_adaptive`` on the plain versions, on any device."""
    return _run_adaptive(
        layers, token, d0, d1, freqs0, freqs1, lengths0, lengths1, match, exit_in,
        num_heads=num_heads, depth_confidence=depth_confidence,
        width_confidence=width_confidence, layer_offset=layer_offset,
        total_layers=total_layers, stat_dtype=stat_dtype, attn_dtype=attn_dtype,
        masked=masked, ops=PLAIN_OPS)
