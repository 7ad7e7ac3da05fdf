"""Attention of the per-block LightGlue path on two hand-written kernels.

Counterpart of ``lightglue_tpu/kernels/attention.py``:

- ``fused_mha`` (:687, pallas_call :766) and ``flash_attention`` (:197,
  pallas_call :264): the online softmax over ``block_k`` KV tiles, in the
  (B, N, H*D) activation layout with optional half-split RoPE and in the
  (B, H, N, D) layout without. Both run ``csrc/flash_attn.cu``, one
  kernel template addressed by strides: bf16 operands on the tensor cores
  at the launch plan of ``flash_plan`` (with RoPE, q and k rotated once
  into a scratch first), fp32 operands on the FMA units.
- ``flash_attention_step`` (:422, pallas_call :507): the same tile loop
  from running (m, l, acc) carries over one KV block at global offsets,
  carries out, the local step of ring attention; the STEP instantiation of
  the same kernel.
- ``bidirectional_cross_attention`` (:925, pallas_call :985): both
  directions of the cross block from one S per head, row softmax for
  0 -> 1 and column softmax for 1 -> 0, on ``csrc/bidir_cross.cu``.
- ``reference_attention`` (:1012): the naive fp32 oracle, for tests.

Each wrapper launches its kernel on a CUDA tensor and runs its plain
PyTorch version (``*_plain``) on a CPU tensor; an unsupported shape raises
the JAX package's ``ValueError`` on either. Rounding follows the Pallas
kernels' points; with ``stat_dtype`` bf16 every ``_quant`` of the reference
is a round trip through bf16.

One deliberate departure: in ``bidirectional_cross_attention`` a direction
whose kv side has length 0 gives 0 rows, as ``fused_mha`` and the layer
stack do. The Pallas kernel gives the mean of the padded values in fp32
and NaN in bf16 there (ROADMAP queue 3).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from lightglue_tpu_torch.kernels import _build
from lightglue_tpu_torch.kernels.layer_stack import (_KC, _WARPS, _check_same, _is_bf16, _quant,
                                                     _stream, apply_rotary, fill_row_groups,
                                                     mma_smem)

DEFAULT_BLOCK_Q = 1024
DEFAULT_BLOCK_K = 1024
HEAD_DIM = 64  # the kernels' head width
_NEG_INF = -1e30
_FMA_ROWS = 16        # csrc/flash_attn.cu: the fp32 kernel's rows per block
_SMS = 132            # streaming multiprocessors of the H100
_STREAM_STAGES = 2    # chunk buffers of a streamed tile (csrc: one copy in flight)


class FlashPlan(NamedTuple):
    """Launch of the bf16 ``flash_attn.cu`` kernel for one shape."""

    row_groups: int  # 16-row groups per block: 4, 2 or 1
    col_split: int   # warps of a row group that split each chunk's keys
    stages: int      # K and V chunk buffers: the tile's chunks (resident) or 2 (streamed)
    blocks: int      # blocks of the launch
    smem: int        # dynamic shared memory per block, bytes


def flash_plan(batch: int, heads: int, nq: int, block_k: int) -> FlashPlan:
    """The bf16 kernel's launch for one shape.

    Rows: ``layer_stack.fill_row_groups``, the most 16-row groups per block
    (4, 2, 1) that still give 256 blocks, else 1; the block's four warps
    split each 64-key chunk's columns ``4 / row_groups`` ways. Large blocks
    read K and V fewer times through L2; short stripes (the ring step's 512
    rows) need small ones to fill the card. Buffers: where the launch is
    one wave (a block per SM) and the whole ``block_k`` tile fits, it stays
    resident (K and V copied once, read by both passes); else chunks stream
    through ``_STREAM_STAGES`` buffers."""
    groups = fill_row_groups(batch, heads, nq)
    blocks = batch * heads * -(-nq // (16 * groups))
    chunks = -(-block_k // _KC)
    stages = min(chunks, _STREAM_STAGES)
    if blocks <= _SMS and mma_smem(groups, chunks) <= _build.MAX_DYNAMIC_SMEM:
        stages = chunks
    return FlashPlan(groups, _WARPS // groups, stages, blocks, mma_smem(groups, stages))


def _flash_launch(name: str, dtype, batch: int, heads: int, nq: int, block_k: int):
    """(row_groups, stages) to pass to ``flash_attn.cu``; raises where the
    block would not fit in shared memory (the fp32 kernel keeps a
    16 x block_k slab of S)."""
    if dtype == torch.bfloat16:
        plan = flash_plan(batch, heads, nq, block_k)
        smem, what = plan.smem, f"a {plan.row_groups * 16}-row block"
        args = (plan.row_groups, plan.stages)
    else:
        smem = 4 * (_FMA_ROWS * HEAD_DIM + _KC * (HEAD_DIM + 1) + _FMA_ROWS * block_k
                    + 3 * _FMA_ROWS)
        what, args = f"a {block_k}-column S slab", (1, 1)
    if smem > _build.MAX_DYNAMIC_SMEM:
        raise ValueError(f"{name}: {what} exceeds shared memory")
    return args


def _blocks(nq: int, nk: int, block_q: int, block_k: int):
    block_q, block_k = min(block_q, nq), min(block_k, nk)
    if nq % block_q or nk % block_k:
        raise ValueError(f"seq ({nq}, {nk}) not divisible by blocks ({block_q}, {block_k})")
    return block_q, block_k


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, H*D) -> (B, H, N, D)."""
    b, n, e = t.shape
    return t.reshape(b, n, num_heads, e // num_heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """(B, H, N, D) -> (B, N, H*D)."""
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def _merge_tiles(qh, kh, vh, m, l, acc, kv_len, col0, *, scale, stat_dtype, block_k):
    """The Pallas tile loop (attention.py:123-176, :366-399) from carries
    (m, l, acc) over (B, H, N, D) heads: per KV tile s = quant(q.k * scale),
    columns whose global id ``col0 + j`` is past kv_len at -1e30; m, p, the
    correction, l and acc each rounded once per tile; a tile that starts at
    or past kv_len leaves the carries as they are. ``kv_len`` is a
    (B, 1, 1, 1) tensor or None (unmasked). Returns fp32 carries."""
    nk = kh.shape[2]
    qf = qh.float()
    for j in range(nk // block_k):
        cols = slice(j * block_k, (j + 1) * block_k)
        s = _quant((qf @ kh[:, :, cols].float().transpose(-1, -2)) * scale, stat_dtype)
        if kv_len is not None:
            col = col0 + j * block_k + torch.arange(block_k, device=qh.device)
            s = torch.where(col < kv_len, s, _NEG_INF)
        m_new = _quant(torch.maximum(m, s.amax(dim=-1, keepdim=True)), stat_dtype)
        p = _quant(torch.exp(s - m_new), stat_dtype)
        corr = _quant(torch.exp(m - m_new), stat_dtype)
        l_new = _quant(l * corr + p.sum(dim=-1, keepdim=True), stat_dtype)
        pv = p.to(vh.dtype).float() @ vh[:, :, cols].float()
        acc_new = _quant(acc * corr + pv, stat_dtype)
        if kv_len is None:
            m, l, acc = m_new, l_new, acc_new
        else:
            live = col0 + j * block_k < kv_len
            m, l, acc = (torch.where(live, new, old) for new, old in
                         ((m_new, m), (l_new, l), (acc_new, acc)))
    return m, l, acc


def _split_lengths(lengths, dev):
    """(B, 2) [q_len, kv_len] -> two (B, 1, 1, 1) int64 tensors."""
    lens = lengths.to(dev, torch.int64)
    return lens[:, 0].view(-1, 1, 1, 1), lens[:, 1].view(-1, 1, 1, 1)


def _online_softmax(qh, kh, vh, lengths, *, scale, stat_dtype, block_k):
    """The whole Pallas body (attention.py:123-184): the tile loop from
    m = -1e30, l = acc = 0, then acc / l (l == 0 divides by 1) with rows
    past q_len 0. Returns fp32."""
    b, h, nq, d = qh.shape
    dev = qh.device
    q_len = kv_len = None
    if lengths is not None:
        q_len, kv_len = _split_lengths(lengths, dev)
    m, l, acc = _merge_tiles(
        qh, kh, vh, torch.full((b, h, nq, 1), _NEG_INF, device=dev),
        torch.zeros((b, h, nq, 1), device=dev), torch.zeros((b, h, nq, d), device=dev),
        kv_len, 0, scale=scale, stat_dtype=stat_dtype, block_k=block_k)
    out = acc / torch.where(l == 0.0, 1.0, l)
    if lengths is not None:
        rows = torch.arange(nq, device=dev).view(1, 1, -1, 1)
        out = torch.where(rows < q_len, out, 0.0)
    return out


def _card_checks(name, dtype, out_dtype, stat_dtype, head_dim, tensors):
    _check_same(name, dtype, *tensors)
    for t in tensors:
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: operands need unit column stride")
    if out_dtype not in (None, dtype):
        raise NotImplementedError(
            f"{name}: output dtype differs from the operands (mixed-precision rung on the "
            "card is queued)")
    if stat_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"{name}: stat dtype {stat_dtype}")
    if head_dim != HEAD_DIM:
        raise NotImplementedError(f"{name}: head dim {head_dim}, the kernel takes {HEAD_DIM}")


def _bidir_smem_check(n: int) -> None:
    """csrc/bidir_cross.cu keeps a 16 x N slab of S in shared memory."""
    smem = 4 * (16 * HEAD_DIM + 64 * (HEAD_DIM + 1) + 16 * n + 16)
    if smem > _build.MAX_DYNAMIC_SMEM:
        raise ValueError(f"bidirectional_cross_attention: a {n}-column S slab exceeds "
                         "shared memory")


def _lengths_arg(lengths, bsz: int, dev):
    if lengths is None:
        return None
    lengths = lengths.to(dev, torch.int32).contiguous()
    if lengths.shape != (bsz, 2):
        raise ValueError(f"lengths must be (B, 2) [q_len, kv_len], got {tuple(lengths.shape)}")
    return lengths


# ---------------------------------------------------------------------------
# fused_mha: (B, N, H*D), optional RoPE
# ---------------------------------------------------------------------------


def _fused_mha_shapes(q, k, v, freqs, num_heads, block_q, block_k):
    batch, nq, feat = q.shape
    nk = k.shape[1]
    if k.shape != (batch, nk, feat) or v.shape != k.shape:
        raise ValueError(f"fused_mha: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    _, block_k = _blocks(nq, nk, block_q, block_k)
    if freqs is not None and (freqs.shape[2] != nk or nq != nk):
        raise ValueError("rope requires freqs rows == kv rows (self-attention)")
    return batch, nq, nk, feat // num_heads, block_k


def fused_mha_plain(q, k, v, freqs=None, lengths=None, *, num_heads: int,
                    scale: Optional[float] = None, stat_dtype=torch.float32, out_dtype=None,
                    block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K):
    """``fused_mha`` in plain PyTorch, on any device."""
    _, _, _, head_dim, block_k = _fused_mha_shapes(q, k, v, freqs, num_heads, block_q, block_k)
    qh, kh, vh = (_heads(t, num_heads) for t in (q, k, v))
    if freqs is not None:  # the freqs cast to the operand type (attention.py:575-582)
        qh, kh = apply_rotary(freqs, qh), apply_rotary(freqs, kh)
    out = _online_softmax(qh, kh, vh, lengths,
                          scale=1.0 / math.sqrt(head_dim) if scale is None else scale,
                          stat_dtype=stat_dtype, block_k=block_k)
    return _merge(out).to(out_dtype or q.dtype)


def fused_mha(q, k, v, freqs=None, lengths=None, *, num_heads: int,
              scale: Optional[float] = None, stat_dtype=torch.float32, out_dtype=None,
              block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K):
    """Multi-head attention in activation layout, (B, N, H*D) in and out.

    Args:
      q: (B, Nq, H*D); k/v: (B, Nk, H*D), head-major columns. Any batch and
        row strides with unit column stride (column slices of one
        projection). On the card all three share the output dtype.
      freqs: optional (B, 2, Nk, D) fp32 [cos; sin], tiled per half: RoPE
        on q and k, self-attention only (Nq == Nk).
      lengths: optional (B, 2) int [q_len, kv_len]; KV tiles past kv_len
        are skipped and rows past q_len are 0.
      stat_dtype: bf16 rounds s, m, p, the correction, l and acc through
        bf16 at every ``block_k`` tile.
      block_q/block_k: capped at Nq/Nk; the sequences must divide them.

    Returns:
      (B, Nq, H*D) in ``out_dtype`` (default q's).
    """
    if q.device.type == "cpu":
        return fused_mha_plain(q, k, v, freqs, lengths, num_heads=num_heads, scale=scale,
                               stat_dtype=stat_dtype, out_dtype=out_dtype,
                               block_q=block_q, block_k=block_k)
    batch, nq, nk, head_dim, block_k = _fused_mha_shapes(q, k, v, freqs, num_heads,
                                                         block_q, block_k)
    _card_checks("fused_mha", q.dtype, out_dtype, stat_dtype, head_dim, (q, k, v))
    plan = _flash_launch("fused_mha", q.dtype, batch, num_heads, nq, block_k)
    if freqs is not None:
        if freqs.shape != (batch, 2, nk, HEAD_DIM):
            raise ValueError(f"fused_mha: freqs {tuple(freqs.shape)}")
        freqs = freqs.float().contiguous()
    lengths = _lengths_arg(lengths, batch, q.device)
    out = torch.empty((batch, nq, q.shape[2]), dtype=q.dtype, device=q.device)
    rot = None  # bf16 with RoPE: the kernel rotates q and k once into this scratch
    if freqs is not None and q.dtype == torch.bfloat16:
        rot = torch.empty((2, batch, nq, q.shape[2]), dtype=q.dtype, device=q.device)
    err = _build.lib().lg_fused_mha(
        q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(1),
        v.data_ptr(), v.stride(0), v.stride(1),
        None if freqs is None else freqs.data_ptr(),
        None if lengths is None else lengths.data_ptr(),
        out.data_ptr(), None if rot is None else rot.data_ptr(), batch, nq, nk, num_heads,
        1.0 / math.sqrt(head_dim) if scale is None else float(scale), block_k,
        int(stat_dtype == torch.bfloat16), *plan, _is_bf16(q), _stream(q),
    )
    _build.check(err, "fused_mha")
    fused_mha.launches += 1
    return out


fused_mha.launches = 0


# ---------------------------------------------------------------------------
# flash_attention: (B, H, N, D)
# ---------------------------------------------------------------------------


def _flash_shapes(q, k, v, block_q, block_k):
    if v.shape != k.shape:
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs {tuple(v.shape)}")
    batch, heads, nq, head_dim = q.shape
    if k.shape[:2] != (batch, heads) or k.shape[3] != head_dim:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    _, block_k = _blocks(nq, k.shape[2], block_q, block_k)
    return batch, heads, nq, k.shape[2], head_dim, block_k


def flash_attention_plain(q, k, v, lengths=None, *, scale: Optional[float] = None,
                          stat_dtype=torch.float32, out_dtype=None,
                          block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K):
    """``flash_attention`` in plain PyTorch, on any device."""
    *_, head_dim, block_k = _flash_shapes(q, k, v, block_q, block_k)
    out = _online_softmax(q, k, v, lengths,
                          scale=1.0 / math.sqrt(head_dim) if scale is None else scale,
                          stat_dtype=stat_dtype, block_k=block_k)
    return out.to(out_dtype or q.dtype)


def flash_attention(q, k, v, lengths=None, *, scale: Optional[float] = None,
                    stat_dtype=torch.float32, out_dtype=None,
                    block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K):
    """Fused scaled-dot-product attention on (B, H, N, D) heads, the generic
    entry point: ``fused_mha``'s function without RoPE in the head-split
    layout.

    Args:
      q: (B, H, Nq, D); k/v: (B, H, Nk, D), any strides with a unit last one.
      lengths: optional (B, 2) int [q_len, kv_len] (as ``fused_mha``).
      scale: defaults to 1/sqrt(D).

    Returns:
      (B, H, Nq, D) in ``out_dtype`` (default q's).
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, lengths, scale=scale, stat_dtype=stat_dtype,
                                     out_dtype=out_dtype, block_q=block_q, block_k=block_k)
    batch, heads, nq, nk, head_dim, block_k = _flash_shapes(q, k, v, block_q, block_k)
    _card_checks("flash_attention", q.dtype, out_dtype, stat_dtype, head_dim, (q, k, v))
    plan = _flash_launch("flash_attention", q.dtype, batch, heads, nq, block_k)
    lengths = _lengths_arg(lengths, batch, q.device)
    out = torch.empty((batch, heads, nq, head_dim), dtype=q.dtype, device=q.device)
    err = _build.lib().lg_flash_attention(
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
        v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
        None if lengths is None else lengths.data_ptr(),
        out.data_ptr(), batch, heads, nq, nk,
        1.0 / math.sqrt(head_dim) if scale is None else float(scale), block_k,
        int(stat_dtype == torch.bfloat16), *plan, _is_bf16(q), _stream(q),
    )
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# flash_attention_step: one KV block merged into running carries (ring step)
# ---------------------------------------------------------------------------


def _fit_block(size: int, cap: int) -> int:
    """The largest divisor of ``size`` at most ``cap`` (JAX
    ``flash_attention_step``'s ``_fit_block``): a ring stripe is N / ring
    long, so the block shrinks to fit it instead of raising."""
    b = min(cap, size)
    while size % b:
        b -= 1
    return b


def _step_shapes(q, k, v, m, l, acc, block_q, block_k):
    batch, heads, n, head_dim = q.shape
    if v.shape != k.shape or k.shape[:2] != (batch, heads) or k.shape[3] != head_dim:
        raise ValueError(f"flash_attention_step: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if m.shape != (batch, heads, n, 1) or l.shape != m.shape or acc.shape != q.shape:
        raise ValueError(f"flash_attention_step: carries m {tuple(m.shape)}, l "
                         f"{tuple(l.shape)}, acc {tuple(acc.shape)} for q {tuple(q.shape)}")
    nk = k.shape[2]
    return batch, heads, n, nk, head_dim, _fit_block(n, block_q), _fit_block(nk, block_k)


def flash_attention_step_plain(q, k, v, m, l, acc, lengths=None, row0: Optional[int] = None,
                               col0: Optional[int] = None, *, scale: Optional[float] = None,
                               stat_dtype=torch.float32, block_q: int = DEFAULT_BLOCK_Q,
                               block_k: int = DEFAULT_BLOCK_K):
    """``flash_attention_step`` in plain PyTorch, on any device."""
    *_, n, _, head_dim, block_q, block_k = _step_shapes(q, k, v, m, l, acc, block_q, block_k)
    row0, col0 = row0 or 0, col0 or 0
    scale = 1.0 / math.sqrt(head_dim) if scale is None else scale
    carries = (m.float(), l.float(), acc.float())
    q_len = kv_len = None
    if lengths is not None:
        q_len, kv_len = _split_lengths(lengths, q.device)
    new = _merge_tiles(q, k, v, *carries, kv_len, col0, scale=scale, stat_dtype=stat_dtype,
                       block_k=block_k)
    if lengths is None:  # unmasked: every stripe is active
        return new
    # a stripe of block_q rows runs only if it starts before q_len and a tile
    # of the block is live; an inactive stripe passes its carries through
    start = row0 + torch.arange(n, device=q.device) // block_q * block_q
    active = (start.view(1, 1, -1, 1) < q_len) & (kv_len > col0)
    return tuple(torch.where(active, a, b) for a, b in zip(new, carries))


def flash_attention_step(q, k, v, m, l, acc, lengths=None, row0: Optional[int] = None,
                         col0: Optional[int] = None, *, scale: Optional[float] = None,
                         stat_dtype=torch.float32, block_q: int = DEFAULT_BLOCK_Q,
                         block_k: int = DEFAULT_BLOCK_K):
    """Merge one KV block into running online-softmax carries: the local
    step of ring attention (``parallel/ring.py``).

    Args:
      q: (B, H, n, D) this position's query stripe; k/v: (B, H, nk, D) the
        KV block of this ring step. Any strides with a unit last one.
      m, l: (B, H, n, 1) fp32 running row max and row sum; acc: (B, H, n, D)
        fp32 running unnormalised output.
      lengths: optional (B, 2) int GLOBAL [q_len, kv_len].
      row0/col0: global ids of q's first row and k's first column (Python
        ints; the ring loop knows them on the host). Default 0.
      block_q/block_k: caps; each shrinks to the largest divisor of n / nk
        (so a 384 or 96 stripe runs), which sets where bf16 stats round.

    Returns:
      (m', l', acc') fp32. Finalise with acc / where(l == 0, 1, l) and the
      row mask (``parallel/ring.py``).
    """
    if q.device.type == "cpu":
        return flash_attention_step_plain(q, k, v, m, l, acc, lengths, row0, col0, scale=scale,
                                          stat_dtype=stat_dtype, block_q=block_q,
                                          block_k=block_k)
    batch, heads, n, nk, head_dim, block_q, block_k = _step_shapes(q, k, v, m, l, acc,
                                                                   block_q, block_k)
    _card_checks("flash_attention_step", q.dtype, None, stat_dtype, head_dim, (q, k, v))
    plan = _flash_launch("flash_attention_step", q.dtype, batch, heads, n, block_k)
    for t in (m, l, acc):
        if t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous():
            raise ValueError("flash_attention_step: carries must be contiguous fp32 on q's device")
    lengths = _lengths_arg(lengths, batch, q.device)
    outs = tuple(torch.empty_like(t) for t in (m, l, acc))
    err = _build.lib().lg_flash_attention_step(
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
        v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), *(t.data_ptr() for t in outs),
        None if lengths is None else lengths.data_ptr(), batch, heads, n, nk,
        int(row0 or 0), int(col0 or 0),
        1.0 / math.sqrt(head_dim) if scale is None else float(scale), block_q, block_k,
        int(stat_dtype == torch.bfloat16), *plan, _is_bf16(q), _stream(q),
    )
    _build.check(err, "flash_attention_step")
    flash_attention_step.launches += 1
    return outs


flash_attention_step.launches = 0


# ---------------------------------------------------------------------------
# bidirectional_cross_attention: both cross directions from one S
# ---------------------------------------------------------------------------


def _bidir_shapes(qk0, qk1, v0, v1, num_heads):
    batch, n0, feat = qk0.shape
    n1 = qk1.shape[1]
    if qk1.shape != (batch, n1, feat) or v0.shape != qk0.shape or v1.shape != qk1.shape:
        raise ValueError(f"bidirectional_cross_attention: qk0 {tuple(qk0.shape)}, qk1 "
                         f"{tuple(qk1.shape)}, v0 {tuple(v0.shape)}, v1 {tuple(v1.shape)}")
    return batch, n0, n1, feat // num_heads


def bidirectional_cross_attention_plain(qk0, qk1, v0, v1, lengths=None, *, num_heads: int,
                                        scale: Optional[float] = None,
                                        stat_dtype=torch.float32, out_dtype=None):
    """``bidirectional_cross_attention`` in plain PyTorch, on any device."""
    _, n0, n1, head_dim = _bidir_shapes(qk0, qk1, v0, v1, num_heads)
    scale = 1.0 / math.sqrt(head_dim) if scale is None else scale
    q0, q1, w0, w1 = (_heads(t, num_heads) for t in (qk0, qk1, v0, v1))
    dev = qk0.device
    s = _quant((q0.float() @ q1.float().transpose(-1, -2)) * scale, stat_dtype)  # (B,H,N0,N1)
    if lengths is not None:
        lens = lengths.to(dev, torch.int64)
        len0, len1 = lens[:, 0].view(-1, 1, 1, 1), lens[:, 1].view(-1, 1, 1, 1)
        s_row = torch.where(torch.arange(n1, device=dev) < len1, s, _NEG_INF)
        s_col = torch.where(torch.arange(n0, device=dev).view(-1, 1) < len0, s, _NEG_INF)
    else:
        s_row = s_col = s
    # 0 -> 1: row softmax; P.V accumulates in fp32 and is divided by l after
    m0 = _quant(s_row.amax(dim=-1, keepdim=True), stat_dtype)
    p0 = _quant(torch.exp(s_row - m0), stat_dtype)
    l0 = _quant(p0.sum(dim=-1, keepdim=True), stat_dtype)
    o0 = (p0.to(v1.dtype).float() @ w1.float()) / torch.where(l0 == 0.0, 1.0, l0)
    # 1 -> 0: column softmax; l sums P after its cast to the V type (:885-897)
    m1 = _quant(s_col.amax(dim=-2, keepdim=True), stat_dtype)
    p1 = _quant(torch.exp(s_col - m1), stat_dtype).to(v0.dtype).float()
    l1 = _quant(p1.sum(dim=-2), stat_dtype)[..., None]  # (B, H, N1, 1)
    o1 = (p1.transpose(-1, -2) @ w0.float()) / torch.where(l1 == 0.0, 1.0, l1)
    if lengths is not None:
        # padded rows are 0, and so is a direction whose kv side is empty
        rows0 = torch.arange(n0, device=dev).view(1, 1, -1, 1)
        rows1 = torch.arange(n1, device=dev).view(1, 1, -1, 1)
        o0 = torch.where((rows0 < len0) & (len1 > 0), o0, 0.0)
        o1 = torch.where((rows1 < len1) & (len0 > 0), o1, 0.0)
    out_dtype = out_dtype or qk0.dtype
    return _merge(o0).to(out_dtype), _merge(o1).to(out_dtype)


def bidirectional_cross_attention(qk0, qk1, v0, v1, lengths=None, *, num_heads: int,
                                  scale: Optional[float] = None, stat_dtype=torch.float32,
                                  out_dtype=None):
    """Both directions of LightGlue's symmetric cross-attention.

    The projection is shared, so scores(1 -> 0) == scores(0 -> 1)^T: one S
    per head, softmax along its rows for image 0's messages and along its
    columns for image 1's. No online rescaling: the whole S row is in hand
    (the kernel keeps a 16 x N slab in shared memory, N <= ~3300; the model
    calls it up to N = 1024).

    Args:
      qk0/v0: (B, N0, H*D); qk1/v1: (B, N1, H*D), unit column stride.
      lengths: optional (B, 2) int [n0, n1].

    Returns:
      (O0 (B, N0, H*D), O1 (B, N1, H*D)) in ``out_dtype`` (default qk0's).
    """
    if qk0.device.type == "cpu":
        return bidirectional_cross_attention_plain(
            qk0, qk1, v0, v1, lengths, num_heads=num_heads, scale=scale,
            stat_dtype=stat_dtype, out_dtype=out_dtype)
    batch, n0, n1, head_dim = _bidir_shapes(qk0, qk1, v0, v1, num_heads)
    _card_checks("bidirectional_cross_attention", qk0.dtype, out_dtype, stat_dtype, head_dim,
                 (qk0, qk1, v0, v1))
    _bidir_smem_check(max(n0, n1))
    lengths = _lengths_arg(lengths, batch, qk0.device)
    o0 = torch.empty(qk0.shape, dtype=qk0.dtype, device=qk0.device)
    o1 = torch.empty(qk1.shape, dtype=qk0.dtype, device=qk0.device)
    err = _build.lib().lg_bidirectional_cross(
        qk0.data_ptr(), qk0.stride(0), qk0.stride(1),
        qk1.data_ptr(), qk1.stride(0), qk1.stride(1),
        v0.data_ptr(), v0.stride(0), v0.stride(1),
        v1.data_ptr(), v1.stride(0), v1.stride(1),
        None if lengths is None else lengths.data_ptr(),
        o0.data_ptr(), o1.data_ptr(), batch, n0, n1, num_heads,
        1.0 / math.sqrt(head_dim) if scale is None else float(scale),
        int(stat_dtype == torch.bfloat16), _is_bf16(qk0), _stream(qk0),
    )
    _build.check(err, "bidirectional_cross_attention")
    bidirectional_cross_attention.launches += 1
    return o0, o1


bidirectional_cross_attention.launches = 0


# ---------------------------------------------------------------------------
# the oracle, and the two op sets of the per-block path
# ---------------------------------------------------------------------------


def reference_attention(q, k, v, lengths=None, *, scale: Optional[float] = None):
    """Naive fp32 softmax(Q.K^T * scale).V on (B, H, N, D), padded columns
    at -1e30 and padded rows 0 (attention.py:1012): the tests' oracle."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if lengths is not None:
        lens = lengths.to(q.device, torch.int64)
        cols = torch.arange(k.shape[2], device=q.device)
        s = torch.where(cols < lens[:, 1].view(-1, 1, 1, 1), s, _NEG_INF)
    out = torch.softmax(s, dim=-1) @ v.float()
    if lengths is not None:
        rows = torch.arange(q.shape[2], device=q.device).view(1, 1, -1, 1)
        out = torch.where(rows < lens[:, 0].view(-1, 1, 1, 1), out, 0.0)
    return out.to(q.dtype)


class AttentionOps(NamedTuple):
    """The attention functions the per-block path calls."""

    fused_mha: Callable
    bidirectional_cross_attention: Callable


KERNEL_OPS = AttentionOps(fused_mha, bidirectional_cross_attention)
PLAIN_OPS = AttentionOps(fused_mha_plain, bidirectional_cross_attention_plain)
