"""Attention of the per-block LightGlue path on two hand-written kernels.

Counterpart of ``lightglue_tpu/kernels/attention.py``:

- ``fused_mha`` (:687, pallas_call :766) and ``flash_attention`` (:197,
  pallas_call :264): the online softmax over ``block_k`` KV tiles, in the
  (B, N, H*D) activation layout with optional half-split RoPE and in the
  (B, H, N, D) layout without. Both run ``csrc/flash_attn.cu``, one
  design addressed by strides, at the launch plan of ``flash_plan`` (with
  RoPE, q and k rotated once into a scratch first): both operand types on
  Hopper's warpgroup MMA (``wgmma``) fed by TMA rings, which need 16 B
  bases and strides (the wrappers raise on others), fp32 operands in
  3xTF32 (each operand split into two TF32 parts, three products a
  product).
- ``flash_attention_step`` (:422, pallas_call :507): the same tile loop
  from running (m, l, acc) carries over one KV block at global offsets,
  carries out, the local step of ring attention; the STEP instantiation of
  the same kernel.
- ``bidirectional_cross_attention`` (:925, pallas_call :985): both
  directions of the cross block from one S per head, row softmax for
  0 -> 1 and column softmax for 1 -> 0, in one launch of
  ``csrc/bidir_cross.cu`` at the plan of ``bidir_plan``: the layer stack's
  attention tile on ``wgmma`` fed by TMA (``csrc/attention_tile.cuh``),
  bf16 operands in bf16, fp32 operands in 3xTF32; 16 B bases and strides
  (the wrapper raises on others).
- ``reference_attention`` (:1012): the naive fp32 oracle, for tests.

Each wrapper launches its kernel on a CUDA tensor and runs its plain
PyTorch version (``*_plain``) on a CPU tensor; both are the implementations
of the wrapper's operator in the ``lightglue_tpu_torch`` namespace
(``_build.define_op``), which ``torch.export`` records. An unsupported
shape raises the JAX package's ``ValueError`` on either. Rounding follows the Pallas
kernels' points; with ``stat_dtype`` bf16 every ``_quant`` of the reference
is a round trip through bf16. On the card the output takes the operands'
type, or fp32 beside bf16 operands (the MIXED rung: bf16 operands, fp32
statistics, an fp32 output); ``flash_attention_step`` always gives fp32
carries.

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
from lightglue_tpu_torch.kernels.layer_stack import (_ATT_CLUSTER_SMS, _ATT_SPLIT, MAX_SEQ,
                                                     _check_same, _quant, _stream, apply_rotary,
                                                     attention_mode, tf32_split,
                                                     wgmma_attention_smem,
                                                     wgmma_tf32_attention_smem)

DEFAULT_BLOCK_Q = 1024
DEFAULT_BLOCK_K = 1024
HEAD_DIM = 64  # the kernels' head width
_NEG_INF = -1e30
_SMS = 132            # streaming multiprocessors of the H100
# csrc/flash_attn.cu: consumer warpgroups a block, ring slots a warpgroup
# (bf16, fp32), the longest block_k whose s pass 1 keeps (bf16), keys of an
# fp32 ring slot
_FLASH_WGS, _FLASH_STAGES, _FLASH_MAX_STORED_K = 4, 2, 1024
_FLASH_F32_STAGES, _FLASH_PIECE = 1, 32


class FlashPlan(NamedTuple):
    """Launch of a ``flash_attn.cu`` kernel for one shape."""

    row_groups: int  # 16-row groups per block: 4, one 64-row tile
    col_split: int   # consumer warpgroups splitting each tile's chunks
    stages: int      # ring slots of a consumer warpgroup
    blocks: int      # blocks of the launch
    smem: int        # dynamic shared memory per block, bytes
    cluster: bool    # a cluster of two blocks a tile (else one block)
    store: bool      # bf16: pass 1 keeps its rounded s for pass 2 (else pass 2 recomputes S)
    kernel: str      # the kernel the launch runs


def flash_split(heads: int, nq: int) -> int:
    """Consumer warpgroups that split a 64-row tile's chunks: 8 where one batch entry's tiles, two blocks each, fit the card's
    SMs, else 4 (2048 rows at four heads already give 128 tiles). It reads
    one entry's shape, never the batch: the split orders a row's fp32 sums
    (csrc/flash_attn.cu:flash_split)."""
    return 8 if 2 * heads * -(-nq // 64) <= _SMS else 4


def flash_wgmma_smem(store: bool, cluster: bool, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of a block of either kernel
    (csrc/flash_attn.cu:Smem). bf16: Q (64 x 64 bf16); each consumer
    warpgroup's region, its ring of two slots (K, then V with ``store``; K
    and V in one slot without) and its chunks' s of a tile of up to 1024
    keys (``store``), where its P.V partial goes after pass 2, or room for
    that partial (64 x 64 fp32). fp32: Q and its lo copy (64 x 64 fp32
    each); each region one slot of a 32-key piece of K and of V, then K's
    lo copy and V's piece transposed, hi and lo (32 x 64 fp32 each), where
    the P.V partial goes. Then the block's rows of acc and l (fp32); the
    warpgroups' partial row max and sum p; the block's row max, each row's
    correction and max; the barriers; 1 KB to align the tiles to 1024 B. A
    ``cluster`` of two blocks holds half the stored chunks and half the
    rows a block."""
    ways = 2 if cluster else 1
    if dtype == torch.float32:
        piece, stages = 4 * _FLASH_PIECE * HEAD_DIM, _FLASH_F32_STAGES
        q, region = 2 * 4 * 64 * HEAD_DIM, stages * 2 * piece + 3 * piece
    else:
        tile, stages = 2 * 64 * HEAD_DIM, _FLASH_STAGES
        kept = _FLASH_MAX_STORED_K // 64 // (_FLASH_WGS * ways)  # stored chunks of a warpgroup
        q, region = tile, (stages * (tile if store else 2 * tile)
                           + (kept * tile if store else 4 * 64 * HEAD_DIM))
    return (q + region * _FLASH_WGS + 4 * 64 // ways * (HEAD_DIM + 1)
            + 2 * 4 * _FLASH_WGS * 64 + 3 * 4 * 64 + 8 * (1 + 2 * _FLASH_WGS * stages) + 1024)


def flash_plan(batch: int, heads: int, nq: int, block_k: int, dtype=torch.bfloat16,
               stat_dtype=None) -> FlashPlan:
    """The kernel's launch for one shape, ``dtype`` operands at
    ``stat_dtype`` statistics (default: ``dtype``)
    (csrc/flash_attn.cu:lg_flash_plan): a 64-row tile of a head per block
    or cluster, ``flash_split`` consumer warpgroups taking each ``block_k``
    tile's 64-key chunks in turn, fed by TMA rings.

    bf16 operands: ``flash_wgmma_kernel``, rings of two slots. A split of 8
    runs as a cluster of two blocks (four consumers each) while the
    launch's blocks fit the card's SMs, else as one block whose warpgroups
    run two consumers each: the same sums either way, so the batch picks
    only the form. At bf16 statistics and ``block_k`` <= 1024 pass 1 keeps
    its rounded s in shared memory and pass 2 reads it back instead of
    recomputing S. fp32 operands: ``flash_tf32_wgmma_kernel`` (3xTF32),
    rings of one slot of a 32-key piece; a split of 8 is always a cluster
    of two blocks, and pass 2 always recomputes S (its shared memory does
    not grow with ``block_k``)."""
    split = flash_split(heads, nq)
    tiles = batch * heads * -(-nq // 64)
    if dtype == torch.float32:
        cluster = split == 8
        return FlashPlan(4, split, _FLASH_F32_STAGES, tiles * (2 if cluster else 1),
                         flash_wgmma_smem(False, cluster, dtype), cluster, False,
                         "flash_tf32_wgmma_kernel")
    cluster = split == 8 and 2 * tiles <= _SMS
    store = (stat_dtype or dtype) == torch.bfloat16 and block_k <= _FLASH_MAX_STORED_K
    return FlashPlan(4, split, _FLASH_STAGES, tiles * (2 if cluster else 1),
                     flash_wgmma_smem(store, cluster), cluster, store, "flash_wgmma_kernel")


def _flash_launch(name: str, dtype, batch: int, heads: int, nq: int, block_k: int,
                  stat_dtype=None):
    """(row_groups, col_split, stages) to pass to ``flash_attn.cu``; raises
    where the block would not fit in shared memory."""
    plan = flash_plan(batch, heads, nq, block_k, dtype, stat_dtype)
    if plan.smem > _build.MAX_DYNAMIC_SMEM:
        raise ValueError(f"{name}: a {plan.row_groups * 16}-row block exceeds shared memory")
    return plan.row_groups, plan.col_split, plan.stages


def _check_tma_rows(name: str, *tensors) -> None:
    """Raise where TMA cannot address an operand of the flash kernels: a
    16 B base, a row stride (the next-to-last) of a multiple of 16 B, and
    so every other stride but the last, where its dimension is not 1."""
    for t in tensors:
        strides = [s for i, (s, n) in enumerate(zip(t.stride()[:-1], t.shape[:-1]))
                   if n > 1 or i == t.dim() - 2]
        if t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in strides):
            raise ValueError(f"{name}: an operand TMA cannot address (base {t.data_ptr():#x}, "
                             f"strides {t.stride()}): 16 B bases and row, head and batch "
                             "strides")


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


def _merge_tiles(qh, kh, vh, m, l, acc, kv_len, col0, *, scale, stat_dtype, block_k,
                 taps: Optional[list] = None):
    """The Pallas tile loop (attention.py:123-176, :366-399) from carries
    (m, l, acc) over (B, H, N, D) heads: per KV tile s = quant(q.k * scale),
    columns whose global id ``col0 + j`` is past kv_len at -1e30; m, p, the
    correction, l and acc each rounded once per tile; a tile that starts at
    or past kv_len leaves the carries as they are. ``kv_len`` is a
    (B, 1, 1, 1) tensor or None (unmasked). Returns fp32 carries. ``taps``:
    a list that gets, per tile, the magnitudes the rounded carries are built
    from (``m`` m', ``lc`` l * c, ``ps`` sum p, ``l`` l', ``ac`` |acc| * c,
    ``pv`` |P| . |V|, ``acc`` |acc'|), for an error bound in ulps."""
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
        live = None if kv_len is None else col0 + j * block_k < kv_len
        if taps is not None:  # a tile that is not live rounds nothing
            taps.append({name: x if live is None else torch.where(live, x, 0.0) for name, x in (
                ("m", m_new.abs()), ("lc", l * corr), ("ps", p.sum(dim=-1, keepdim=True)),
                ("l", l_new), ("ac", acc.abs() * corr),
                ("pv", p.abs() @ vh[:, :, cols].float().abs()), ("acc", acc_new.abs()))})
        if live is None:
            m, l, acc = m_new, l_new, acc_new
        else:
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


def _card_checks(name, dtype, out_dtype, stat_dtype, head_dim, tensors) -> int:
    """Raises on what the kernels do not take; returns the C entry's mode
    (``layer_stack.attention_mode``)."""
    _check_same(name, dtype, *tensors)
    for t in tensors:
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: operands need unit column stride")
    mode = attention_mode(name, dtype, out_dtype)
    if stat_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"{name}: stat dtype {stat_dtype}")
    if head_dim != HEAD_DIM:
        raise NotImplementedError(f"{name}: head dim {head_dim}, the kernel takes {HEAD_DIM}")
    return mode


class BidirPlan(NamedTuple):
    """Launch of ``csrc/bidir_cross.cu`` for one shape."""

    row_groups: int  # 16-row groups of a tile: 4, a warpgroup's 64 rows
    col_split: int   # consumers (of a cluster) that split each row's chunks
    blocks: int      # blocks of the launch: both directions' tiles
    smem: int        # dynamic shared memory per block, bytes
    cluster: bool    # a cluster of two blocks a tile (else one block)
    store: bool      # bf16: pass 1 keeps its rounded s for pass 2 (else pass 2 recomputes S)
    kernel: str      # the kernel the launch runs


def bidir_plan(batch: int, heads: int, n0: int, n1: int, dtype=torch.bfloat16,
               stat_dtype=None) -> BidirPlan:
    """The bidirectional kernel's launch for one shape, ``dtype`` operands
    at ``stat_dtype`` statistics (default: ``dtype``)
    (csrc/bidir_cross.cu:lg_bidir_plan): one grid of both directions'
    64-row tiles, the layer stack's attention tile on each.

    bf16 operands: ``bidir_wgmma_kernel``, eight consumers splitting each
    row's 64-key chunks, a cluster of two blocks a tile while the launch's
    blocks fit the card's 132 SMs, else one block whose warpgroups run two
    consumers each (the same sums: the batch picks only the form); at bf16
    statistics pass 1 keeps its rounded s while both sides have at most
    1024 rows, else pass 2 recomputes S (``wgmma_attention_smem``: shared
    memory does not grow with N, so any N fits). fp32 operands:
    ``bidir_tf32_wgmma_kernel`` (3xTF32), ``tf32_split`` over both
    directions' tiles of one pair, a split of 8 as a cluster of two blocks,
    4 as one block, at every batch (``wgmma_tf32_attention_smem``)."""
    tiles = -(-n0 // 64) - (-n1 // 64)  # a head's tiles of both directions
    if dtype == torch.float32:
        split = tf32_split(heads, n0, n1)
        cluster = split == 8
        return BidirPlan(4, split, batch * heads * tiles * (2 if cluster else 1),
                         wgmma_tf32_attention_smem(), cluster, False, "bidir_tf32_wgmma_kernel")
    cluster = 2 * batch * heads * tiles <= _ATT_CLUSTER_SMS
    store = (stat_dtype or dtype) == torch.bfloat16 and max(n0, n1) <= MAX_SEQ
    return BidirPlan(4, _ATT_SPLIT, batch * heads * tiles * (2 if cluster else 1),
                     wgmma_attention_smem(store, cluster), cluster, store, "bidir_wgmma_kernel")


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
        projection), in one dtype.
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
    return _build.run(_FUSED_MHA, _fused_mha_cpu, _fused_mha_cuda, q, k, v, freqs, lengths,
                      num_heads, _scale_arg(scale), stat_dtype, out_dtype, block_q, block_k)


def _scale_arg(scale) -> Optional[float]:
    return None if scale is None else float(scale)


def _fused_mha_cpu(q, k, v, freqs, lengths, num_heads, scale, stat_dtype, out_dtype, block_q,
                   block_k):
    return fused_mha_plain(q, k, v, freqs, lengths, num_heads=num_heads, scale=scale,
                           stat_dtype=stat_dtype, out_dtype=out_dtype, block_q=block_q,
                           block_k=block_k)


def _fused_mha_fake(q, k, v, freqs, lengths, num_heads, scale, stat_dtype, out_dtype, block_q,
                    block_k):
    return q.new_empty(q.shape, dtype=out_dtype or q.dtype)


def _fused_mha_cuda(q, k, v, freqs, lengths, num_heads, scale, stat_dtype, out_dtype, block_q,
                    block_k):
    """``fused_mha``'s CUDA implementation: checks, then one launch."""
    batch, nq, nk, head_dim, block_k = _fused_mha_shapes(q, k, v, freqs, num_heads,
                                                         block_q, block_k)
    mode = _card_checks("fused_mha", q.dtype, out_dtype, stat_dtype, head_dim, (q, k, v))
    _check_tma_rows("fused_mha", q, k, v)  # both kernels read them through TMA
    plan = _flash_launch("fused_mha", q.dtype, batch, num_heads, nq, block_k, stat_dtype)
    if freqs is not None:
        if freqs.shape != (batch, 2, nk, HEAD_DIM):
            raise ValueError(f"fused_mha: freqs {tuple(freqs.shape)}")
        freqs = freqs.float().contiguous()
    lengths = _lengths_arg(lengths, batch, q.device)
    out = torch.empty((batch, nq, q.shape[2]), dtype=out_dtype or q.dtype, device=q.device)
    rot = None  # with RoPE: the kernel rotates q and k once into this scratch
    if freqs is not None:
        rot = torch.empty((2, batch, nq, q.shape[2]), dtype=q.dtype, device=q.device)
    err = _build.lib().lg_fused_mha(
        q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(1),
        v.data_ptr(), v.stride(0), v.stride(1),
        None if freqs is None else freqs.data_ptr(),
        None if lengths is None else lengths.data_ptr(),
        out.data_ptr(), None if rot is None else rot.data_ptr(), batch, nq, nk, num_heads,
        1.0 / math.sqrt(head_dim) if scale is None else float(scale), block_k,
        int(stat_dtype == torch.bfloat16), *plan, mode, _stream(q),
    )
    _build.check(err, "fused_mha")
    fused_mha.launches += 1
    return out


_FUSED_MHA = _build.define_op(
    "fused_mha(Tensor q, Tensor k, Tensor v, Tensor? freqs, Tensor? lengths, int num_heads, "
    "float? scale, ScalarType stat_dtype, ScalarType? out_dtype, int block_q, int block_k) "
    "-> Tensor",
    cpu=_fused_mha_cpu, cuda=_fused_mha_cuda, fake=_fused_mha_fake)
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
    return _build.run(_FLASH, _flash_attention_cpu, _flash_attention_cuda, q, k, v, lengths,
                      _scale_arg(scale), stat_dtype, out_dtype, block_q, block_k)


def _flash_attention_cpu(q, k, v, lengths, scale, stat_dtype, out_dtype, block_q, block_k):
    return flash_attention_plain(q, k, v, lengths, scale=scale, stat_dtype=stat_dtype,
                                 out_dtype=out_dtype, block_q=block_q, block_k=block_k)


def _flash_attention_fake(q, k, v, lengths, scale, stat_dtype, out_dtype, block_q, block_k):
    return q.new_empty(q.shape, dtype=out_dtype or q.dtype)


def _flash_attention_cuda(q, k, v, lengths, scale, stat_dtype, out_dtype, block_q, block_k):
    """``flash_attention``'s CUDA implementation: checks, then one launch."""
    batch, heads, nq, nk, head_dim, block_k = _flash_shapes(q, k, v, block_q, block_k)
    mode = _card_checks("flash_attention", q.dtype, out_dtype, stat_dtype, head_dim, (q, k, v))
    _check_tma_rows("flash_attention", q, k, v)  # both kernels read them through TMA
    plan = _flash_launch("flash_attention", q.dtype, batch, heads, nq, block_k, stat_dtype)
    lengths = _lengths_arg(lengths, batch, q.device)
    out = torch.empty((batch, heads, nq, head_dim), dtype=out_dtype or q.dtype, device=q.device)
    err = _build.lib().lg_flash_attention(
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
        v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
        None if lengths is None else lengths.data_ptr(),
        out.data_ptr(), batch, heads, nq, nk,
        1.0 / math.sqrt(head_dim) if scale is None else float(scale), block_k,
        int(stat_dtype == torch.bfloat16), *plan, mode, _stream(q),
    )
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


_FLASH = _build.define_op(
    "flash_attention(Tensor q, Tensor k, Tensor v, Tensor? lengths, float? scale, "
    "ScalarType stat_dtype, ScalarType? out_dtype, int block_q, int block_k) -> Tensor",
    cpu=_flash_attention_cpu, cuda=_flash_attention_cuda, fake=_flash_attention_fake)
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
    return _build.run(_STEP, _step_cpu, _step_cuda, q, k, v, m, l, acc, lengths,
                      None if row0 is None else int(row0), None if col0 is None else int(col0),
                      _scale_arg(scale), stat_dtype, block_q, block_k)


def _step_cpu(q, k, v, m, l, acc, lengths, row0, col0, scale, stat_dtype, block_q, block_k):
    return flash_attention_step_plain(q, k, v, m, l, acc, lengths, row0, col0, scale=scale,
                                      stat_dtype=stat_dtype, block_q=block_q, block_k=block_k)


def _step_fake(q, k, v, m, l, acc, lengths, row0, col0, scale, stat_dtype, block_q, block_k):
    return tuple(t.new_empty(t.shape, dtype=torch.float32) for t in (m, l, acc))


def _step_cuda(q, k, v, m, l, acc, lengths, row0, col0, scale, stat_dtype, block_q, block_k):
    """``flash_attention_step``'s CUDA implementation: checks, then one
    launch."""
    batch, heads, n, nk, head_dim, block_q, block_k = _step_shapes(q, k, v, m, l, acc,
                                                                   block_q, block_k)
    mode = _card_checks("flash_attention_step", q.dtype, None, stat_dtype, head_dim, (q, k, v))
    _check_tma_rows("flash_attention_step", q, k, v)  # both kernels read them through TMA
    plan = _flash_launch("flash_attention_step", q.dtype, batch, heads, n, block_k, stat_dtype)
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
        int(stat_dtype == torch.bfloat16), *plan, mode, _stream(q),
    )
    _build.check(err, "flash_attention_step")
    flash_attention_step.launches += 1
    return outs


_STEP = _build.define_op(
    "flash_attention_step(Tensor q, Tensor k, Tensor v, Tensor m, Tensor l, Tensor acc, "
    "Tensor? lengths, int? row0, int? col0, float? scale, ScalarType stat_dtype, int block_q, "
    "int block_k) -> (Tensor, Tensor, Tensor)",
    cpu=_step_cpu, cuda=_step_cuda, fake=_step_fake)
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
    columns for image 1's. No online rescaling: one softmax over the whole
    row. The kernel takes it in two passes on Hopper's warpgroup MMA (bf16
    operands in bf16, fp32 ones in 3xTF32), both directions in one grid at
    ``bidir_plan``'s launch; the keys stream through shared memory, so any N
    fits. The model calls it up to N = 1024.

    Args:
      qk0/v0: (B, N0, H*D); qk1/v1: (B, N1, H*D), unit column stride (column
        slices of the [qk | v] projection). On the card TMA reads them: 16 B
        bases and batch and row strides, else a ``ValueError`` (the element
        loads of the mma.sync kernels for other rows are gone).
      lengths: optional (B, 2) int [n0, n1].

    Returns:
      (O0 (B, N0, H*D), O1 (B, N1, H*D)) in ``out_dtype`` (default qk0's).
    """
    return _build.run(_BIDIR, _bidir_cpu, _bidir_cuda, qk0, qk1, v0, v1, lengths, num_heads,
                      _scale_arg(scale), stat_dtype, out_dtype)


def _bidir_cpu(qk0, qk1, v0, v1, lengths, num_heads, scale, stat_dtype, out_dtype):
    return bidirectional_cross_attention_plain(qk0, qk1, v0, v1, lengths, num_heads=num_heads,
                                               scale=scale, stat_dtype=stat_dtype,
                                               out_dtype=out_dtype)


def _bidir_fake(qk0, qk1, v0, v1, lengths, num_heads, scale, stat_dtype, out_dtype):
    dt = out_dtype or qk0.dtype
    return qk0.new_empty(qk0.shape, dtype=dt), qk0.new_empty(qk1.shape, dtype=dt)


def _bidir_cuda(qk0, qk1, v0, v1, lengths, num_heads, scale, stat_dtype, out_dtype):
    """``bidirectional_cross_attention``'s CUDA implementation: checks, then
    one launch."""
    batch, n0, n1, head_dim = _bidir_shapes(qk0, qk1, v0, v1, num_heads)
    mode = _card_checks("bidirectional_cross_attention", qk0.dtype, out_dtype, stat_dtype,
                        head_dim, (qk0, qk1, v0, v1))
    _check_tma_rows("bidirectional_cross_attention", qk0, qk1, v0, v1)  # both kernels: TMA
    lengths = _lengths_arg(lengths, batch, qk0.device)
    o0 = torch.empty(qk0.shape, dtype=out_dtype or qk0.dtype, device=qk0.device)
    o1 = torch.empty(qk1.shape, dtype=out_dtype or qk0.dtype, device=qk0.device)
    err = _build.lib().lg_bidirectional_cross(
        qk0.data_ptr(), qk0.stride(0), qk0.stride(1),
        qk1.data_ptr(), qk1.stride(0), qk1.stride(1),
        v0.data_ptr(), v0.stride(0), v0.stride(1),
        v1.data_ptr(), v1.stride(0), v1.stride(1),
        None if lengths is None else lengths.data_ptr(),
        o0.data_ptr(), o1.data_ptr(), batch, n0, n1, num_heads,
        1.0 / math.sqrt(head_dim) if scale is None else float(scale),
        int(stat_dtype == torch.bfloat16), mode, _stream(qk0),
    )
    _build.check(err, "bidirectional_cross_attention")
    bidirectional_cross_attention.launches += 1
    return o0, o1


_BIDIR = _build.define_op(
    "bidirectional_cross_attention(Tensor qk0, Tensor qk1, Tensor v0, Tensor v1, "
    "Tensor? lengths, int num_heads, float? scale, ScalarType stat_dtype, "
    "ScalarType? out_dtype) -> (Tensor, Tensor)",
    cpu=_bidir_cpu, cuda=_bidir_cuda, fake=_bidir_fake)
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
