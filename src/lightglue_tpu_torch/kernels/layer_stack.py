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
  path's shapes (a 1024-row product moves 1.2-2.6 MB). bf16 products run a
  pipelined ``mma.sync`` GEMM (64-deep K chunks in a 3-buffer ``cp.async``
  ring, fp32 sums in registers) at the tile ``linear_plan`` gives: at least
  256 blocks at 1024 rows, tiles of at most 64 rows so none straddles two
  pairs. The epilogue is JAX ``_linear``'s: round to the activation type T,
  add the bias in T, add the residual in T. The GEMM takes fp32 activations
  (MIXED, rounded to bf16 as they are staged) and int8 weights with a
  per-channel scale (INT8, dequantized as they are staged); W8A8
  (``LGTPU_W8A8=1`` on the INT8 rung) quantizes each activation row first
  (``row_quant``) and multiplies int8 by int8 on the tensor cores, on the
  weight's K-major copy ``w_t``, at ``s8_plan``'s block.
- ``attention`` (``csrc/attention.cu``): masked self-attention with RoPE and
  both cross-attention directions (one launch each), one softmax over the
  whole row (N <= 1024). Bound by the tensor cores (1.07 GFLOP per call at
  B = 1, H = 4, N = 1024). Both operand types run ``flash_attn.cu``'s
  design on Hopper's warpgroup MMA (``csrc/hopper.cuh``) at one tile of Nk
  keys: two passes (row max, then p, sum p and P.V), consumers splitting
  each 64-row tile's chunks as ``attention_plan`` gives; RoPE first, once,
  into a scratch. It keeps the stack's contract where
  the flash kernel's differs: acc is never rounded (P.V / l in fp32, one
  cast to T), the row max is clamped at -5e29 when masked, dead columns
  are -1e30 in every chunk under keep masks, keep and liveness operands
  stay.
- ``ln_gelu`` (``csrc/ln_gelu.cu``): the FFN's LayerNorm + GELU, 32 lanes
  a row reading 16-byte vectors (``ln_gelu_plan``), launched as a
  programmatic dependent of ffn1;
- ``adaptive_decide`` (``csrc/adaptive.cu``, adaptive stack only): after
  each layer, the early-exit and pruning decision of every live pair, one
  launch whose blocks each take a slice of one pair's rows
  (``decide_plan``) and meet in a per-device scratch.

fp32 operands (the FP32 rung) run on the tensor cores in 3xTF32 (each
operand split into two TF32 parts, three products a product; one TF32
product would miss the rung's 1e-4 gate), both on Hopper's warpgroup MMA:
``linear`` as the transposed product Y^T = W^T . X^T (a tf32 operand in
shared memory is read K-major only, and the weights are stored (K, N)) at
``linear_plan``'s fp32 tile, ``attention`` in the bf16 kernel's shape with
fp32 pieces of 32 keys, Q and K K-major as TMA writes them, P from the S
accumulator as register A and V transposed by the consumers
(``attention_plan``, ``tf32_split``, ``wgmma_tf32_attention_smem``).

Every rung of the precision ladder runs on the card (``_LINEAR_MODES`` and
``_ATTENTION_MODES`` list the operand types each kernel takes):

- FP32: fp32 everywhere;
- BF16: bf16 activations, operands and statistics;
- MIXED: fp32 activations, residuals, LayerNorm and statistics, bf16
  products; attention takes bf16 operands and gives fp32 (its direction-1
  launch sums p after its cast to bf16, as the reference's shared-S column
  softmax does);
- INT8: the BF16 stack with int8 weights and fp32 per-channel scales,
  biases and LayerNorm (the quantized tree is not cast); with
  ``LGTPU_W8A8=1`` the projections are W8A8 (``_w8a8_default``).

The adaptive stack carries a per-pair exit register (B,) fp32 and, under
width pruning, (B, N) fp32 keep masks, both on the device. The three layer
kernels take the register and the global layer index (``Live``) and skip
retired pairs; attention takes the keep masks in place of the lengths. The
layer loop reads nothing back to the host.

Each wrapper launches its kernel on a CUDA tensor and runs its plain PyTorch
version (``*_plain``) on a CPU tensor; both are the implementations of the
wrapper's operator in the ``lightglue_tpu_torch`` namespace
(``_build.define_op``; ``Live`` goes in flattened, as the exit register and
the layer index), which ``torch.export`` records. ``transformer_stack_plain`` and
``transformer_stack_adaptive_plain`` run the same loops on the plain
versions on any device. Rounding follows the JAX kernel's points exactly
(see each kernel's header).
"""

from __future__ import annotations

import math
import os
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from lightglue_tpu_torch import quant
from lightglue_tpu_torch.kernels import _build

MAX_SEQ = 1024  # the JAX kernel's VMEM gate, kept as the port's contract
HEAD_DIM = 64   # the attention kernel's head width
_NEG_INF = -1e30
_DEAD = _NEG_INF * 0.5  # all-masked-row clamp (layer_stack.py:276-292)

# csrc/linear.cu: the wgmma GEMM's (BF16, MIXED, INT8) K chunk, ring slots,
# tile columns in order of preference and the blocks one pair's tile rule
# aims for (one per SM); the fp32 (3xTF32) wgmma GEMM's ring slots (its
# chunk is as deep, its tile rows follow the same rule)
_WG_BK, _WG_STAGES, _WG_TILE_N, _WG_FILL = 64, 4, (64, 32), 128
# csrc/linear.cu: the fp32 GEMM's ring slots while its launch fits the SMs
# (one block an SM), else (two an SM)
_TF_DEEP, _TF_SHALLOW, _TF_SMS = 4, 2, 132
# csrc/attention_tile.cuh (attention.cu's and bidir_cross.cu's kernels): the
# bf16 tile's consumers splitting each row's chunks, consumer warpgroups a
# block, ring slots per warpgroup, the SMs that clusters of two blocks a
# tile must fit (else one block a tile); the fp32 tile's keys a ring slot
# holds
_ATT_SPLIT, _ATT_WGS, _ATT_STAGES, _ATT_CLUSTER_SMS = 8, 4, 2, 132
_ATT_PIECE_KEYS = 32
# csrc/linear.cu, W8A8: the s8 GEMM's warp tiles of a block (along M, along
# N; 32 x 32 outputs each) in order of preference, the blocks its plan aims
# for (about one per SM), the widest K it takes, the warps of a block
_S8_TILES, _S8_MIN_BLOCKS, _S8_MAX_K, _S8_WARPS = ((2, 2), (1, 2), (1, 1)), 128, 512, 8


def wgmma_attention_smem(store: bool = True, cluster: bool = True) -> int:
    """Dynamic shared memory of a block of the bf16 attention tile
    (csrc/attention_tile.cuh:Smem; attention.cu's and bidir_cross.cu's bf16
    kernels): Q (64 x 64 bf16); each warpgroup's region,
    its ring of two slots (K, then V, with ``store``: bf16 stats, pass 2
    reading pass 1's s; K and V in one slot without) and its chunks' s
    (``store``), or room for a 64 x 64 fp32 partial (one block a tile,
    without ``store``); the warpgroups' partial row max and sum p; the
    block's row max; the barriers; 1 KB to align the tiles to 1024 B. A
    warpgroup runs one consumer in a ``cluster`` of two blocks, two without."""
    tile = 2 * 64 * HEAD_DIM
    virt = _ATT_SPLIT // (_ATT_WGS * (2 if cluster else 1))
    kept = MAX_SEQ // 64 // _ATT_SPLIT * virt  # stored chunks of a warpgroup
    extra = kept * tile if store else (4 * 64 * HEAD_DIM if virt > 1 else 0)
    region = _ATT_STAGES * (tile if store else 2 * tile) + extra
    return (tile + region * _ATT_WGS + 2 * 4 * _ATT_WGS * 64 + 4 * 64
            + 8 * (1 + 2 * _ATT_WGS * _ATT_STAGES) + 1024)


def tf32_split(heads: int, nq: int, nq2: int = 0) -> int:
    """Consumers splitting each 64-row tile's chunks in the fp32 attention
    tile (csrc/attention_tile.cuh:tf32_split): 8 where one pair's tiles, two
    blocks each, fit the card's SMs (then always a cluster of two blocks a
    tile), else 4 (one block a tile). ``nq2``: the rows of a second
    direction in the same grid (the bidirectional kernel). One pair's shape
    sets it, never the batch, which only adds blocks: a row's fp32 sums run
    in one order at any batch."""
    return 8 if 2 * heads * (-(-nq // 64) - (-nq2 // 64)) <= _ATT_CLUSTER_SMS else 4


def wgmma_tf32_attention_smem() -> int:
    """Dynamic shared memory of a block of the fp32 attention tile
    (csrc/attention_tile.cuh:TfSmem; attention.cu's and bidir_cross.cu's
    fp32 kernels), the same in either form: Q (64 x 64 fp32)
    and its lo copy; each warpgroup's region, its one ring slot (a 32-key
    piece of K and of V), K's lo copy, V's piece transposed as hi and lo
    (32 x 64 fp32 each; the P.V partial goes over these three); the
    warpgroups' partial row max and sum p; the block's row max; the
    barriers; 1 KB to align the tiles to 1024 B."""
    tile, piece = 4 * 64 * HEAD_DIM, 4 * _ATT_PIECE_KEYS * HEAD_DIM
    region = 2 * piece + 3 * piece
    return (2 * tile + region * _ATT_WGS + 2 * 4 * _ATT_WGS * 64 + 4 * 64
            + 8 * (1 + 2 * _ATT_WGS) + 1024)


class AttentionPlan(NamedTuple):
    """Launch of ``csrc/attention.cu`` for one shape."""

    row_groups: int  # 16-row groups of a tile: 4, a warpgroup's 64 rows
    col_split: int   # consumer warpgroups (of a cluster) that split each row's keys
    blocks: int      # blocks of the launch
    smem: int        # dynamic shared memory per block, bytes
    kernel: str      # the kernel the launch runs


def attention_plan(batch: int, heads: int, nq: int, nk: int, dtype=torch.bfloat16,
                   stat_dtype=None) -> AttentionPlan:
    """The stack attention's launch in either operand type
    (csrc/attention.cu:lg_attention_plan). bf16 operands (the BF16, MIXED
    and INT8 rungs): ``attention_wgmma_kernel``, eight consumers splitting
    each row's 64-key chunks (chunk j to consumer j % 8) at every shape and
    batch, fed by TMA rings of two slots (``wgmma_attention_smem``; at bf16
    ``stat_dtype``, the default, pass 2 reads pass 1's s from shared
    memory): a cluster of two blocks of four consumer warpgroups per 64
    query rows of a head while the launch's blocks fit the card's 132 SMs
    (one pair of 1024: 128 blocks), else one block whose warpgroups run two
    consumers each; both add the same values in the same order, so a pair's
    rows are the same in either. fp32 operands:
    ``attention_tf32_wgmma_kernel``, the same shape in 3xTF32, each tile's
    chunks split ``tf32_split`` ways from one pair's shape, a split of 8 as
    a cluster of two blocks, 4 as one block, at every batch, fed by 32-key
    pieces (``wgmma_tf32_attention_smem``). Shared
    memory does not grow with Nk. Raises past the contract's N <= 1024."""
    if nk > MAX_SEQ:
        raise ValueError(f"attention: {nk} keys exceed the layer stack's {MAX_SEQ}")
    if dtype != torch.float32:
        store = (stat_dtype or dtype) == torch.bfloat16
        tiles = batch * heads * -(-nq // 64)
        cluster = 2 * tiles <= _ATT_CLUSTER_SMS
        return AttentionPlan(4, _ATT_SPLIT, tiles * (2 if cluster else 1),
                             wgmma_attention_smem(store, cluster), "attention_wgmma_kernel")
    split = tf32_split(heads, nq)
    return AttentionPlan(4, split, batch * heads * -(-nq // 64) * (2 if split == 8 else 1),
                         wgmma_tf32_attention_smem(), "attention_tf32_wgmma_kernel")


class LinearPlan(NamedTuple):
    """Launch of ``csrc/linear.cu``'s GEMM for one shape."""

    bm: int      # tile rows (a divisor of 64: a tile never straddles two pairs)
    bn: int      # tile columns
    bk: int      # K depth of a staged chunk
    chunks: int  # K chunks a block runs through
    stages: int  # chunk slots of the TMA ring
    blocks: int  # blocks of the launch
    smem: int    # dynamic shared memory per block, bytes
    kernel: str  # the kernel the launch runs


def linear_plan(m: int, n: int, k: int, dtype=torch.bfloat16, weight_dtype=None, *,
                rows: Optional[int] = None) -> LinearPlan:
    """The GEMM's launch for an (m, k) x (k, n) product of ``dtype``
    activations and ``weight_dtype`` weights (default: ``dtype``): the
    modes of ``_LINEAR_MODES`` (csrc/linear.cu:lg_linear_plan).

    BF16 (bf16 by bf16), MIXED (fp32 by bf16) and INT8 (bf16 by int8):
    ``linear_wgmma_kernel``, 64-row tiles of 64 columns where one pair's
    ``rows`` (default ``m``) still give 128 blocks, else 32 (wg_tile_n: the
    batch never changes a tile), K in 64-deep TMA chunks through a ring of
    four slots (an A chunk and a W chunk each, with the bf16 copy of MIXED's
    fp32 A or of INT8's dequantized W: csrc/linear.cu:WgSlot). FP32:
    ``linear_tf32_wgmma_kernel``, the transposed product on wgmma in
    3xTF32: tiles of 64 output columns by 64 rows where one pair's rows
    still give 128 blocks, else 32 rows (tf_tile_rows), K in 64-deep TMA
    chunks through a ring of four slots while the launch's blocks fit the
    card's 132 SMs, else two (tf_stages; a slot: X's chunk, its lo copy and
    W's chunk, all fp32: csrc/linear.cu:TfSlot)."""
    weight_dtype = weight_dtype or dtype
    pair = -(-(rows or m) // 64)
    bn = next((t for t in _WG_TILE_N if pair * (n // t) >= _WG_FILL), _WG_TILE_N[-1])
    if (dtype, weight_dtype) != (torch.float32, torch.float32):
        # a slot: A as TMA writes it (and fp32 A's bf16 copy), W as TMA writes
        # it (and int8 W's dequantized bf16 copy)
        a_bytes = 64 * _WG_BK * (4 + 2 if dtype == torch.float32 else 2)
        w_bytes = _WG_BK * bn * (1 + 2 if weight_dtype == torch.int8 else 2)
        smem = _WG_STAGES * (a_bytes + w_bytes + 16) + 1024
        return LinearPlan(64, bn, _WG_BK, -(-k // _WG_BK), _WG_STAGES, -(-m // 64) * (n // bn),
                          smem, "linear_wgmma_kernel")
    bm = bn  # the rows of an fp32 tile (64 output columns): the bf16 rule, roles swapped
    blocks = -(-m // bm) * (n // 64)
    stages = _TF_DEEP if blocks <= _TF_SMS else _TF_SHALLOW
    smem = stages * (2 * 4 * bm * _WG_BK + 4 * _WG_BK * 64 + 16) + 1024
    return LinearPlan(bm, 64, _WG_BK, -(-k // _WG_BK), stages, blocks, smem,
                      "linear_tf32_wgmma_kernel")


class S8Plan(NamedTuple):
    """Launch of ``csrc/linear.cu``'s W8A8 GEMM (``linear_s8_kernel``) for
    one shape."""

    bm: int       # tile rows: 32 per warp tile along M (a divisor of 64)
    bn: int       # tile columns: 32 per warp tile along N
    k_split: int  # ways the block's 8 warps split the k32 steps
    blocks: int   # blocks of the launch
    smem: int     # dynamic shared memory per block, bytes


def s8_plan(m: int, n: int, k: int) -> S8Plan:
    """The s8 GEMM's block for an (m, k) x (k, n) product: 8 warps over 2 x 2
    warp tiles (64 x 64 outputs) where that gives 128 blocks, else 1 x 2 (32
    x 64), else 1 x 1, the other warps splitting K (csrc/linear.cu:s8_plan);
    its shared memory the int32 sums at a row pitch of bn + 4, A and W^T rows
    staged whole at a pitch of K rounded up to 32, plus 16 bytes, the bf16
    residual tile, the fp32 scale and bias of the tile's columns
    (csrc/linear.cu:s8_smem)."""
    for wm, wn in _S8_TILES:
        blocks = -(-m // (32 * wm)) * (n // (32 * wn))
        if blocks >= _S8_MIN_BLOCKS:
            break
    bm, bn, pitch = 32 * wm, 32 * wn, -(-k // 32) * 32 + 16
    smem = 4 * bm * (bn + 4) + (bm + bn) * pitch + 2 * bm * bn + 8 * bn
    return S8Plan(bm, bn, _S8_WARPS // (wm * wn), blocks, smem)


class Live(NamedTuple):
    """Liveness operand of the layer kernels: pair b runs global layer
    ``layer`` iff ``exit[b] > layer`` (the Pallas kernel's pl.when(live))."""

    exit: torch.Tensor  # (B,) fp32 exit register
    layer: int          # global layer index


def _live(exit: Optional[torch.Tensor], layer: int) -> Optional[Live]:
    """The liveness operand from an operator's flattened arguments."""
    return None if exit is None else Live(exit, layer)


def _flat_live(live: Optional[Live]):
    """``Live`` as an operator takes it: (exit register or None, layer)."""
    return (None, 0) if live is None else (live.exit, live.layer)


def _live_args(live: Optional[Live], rows_per_pair: int):
    if live is None:
        return None, 0, 1
    if live.exit.dtype != torch.float32 or not live.exit.is_contiguous():
        raise ValueError("exit register must be contiguous fp32")
    return live.exit.data_ptr(), live.layer, rows_per_pair


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_tma(name: str, *operands) -> None:
    """Raise where TMA cannot address an operand: each (tensor or None, row
    width in elements) must start on 16 B with rows of a multiple of 16 B
    (bf16: a multiple of 8 elements)."""
    for t, width in operands:
        if t is not None and (t.data_ptr() % 16 or (width * t.element_size()) % 16):
            raise ValueError(f"{name}: an operand TMA cannot address (base {t.data_ptr():#x}, "
                             f"rows of {width} {t.dtype}): 16 B bases and rows")


def _check_same(name: str, dtype, *tensors) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"{name}: dtype {dtype} (fp32 and bf16 only)")
    for t in tensors:
        if t is not None and (t.dtype != dtype or t.device != tensors[0].device):
            raise NotImplementedError(
                f"{name}: these operands share dtype {dtype} and a device; got "
                f"{t.dtype} on {t.device}"
            )


_F32, _BF16, _I8 = torch.float32, torch.bfloat16, torch.int8

# (operand, output) types -> the mode of lg_attention, lg_fused_mha,
# lg_flash_attention and lg_bidirectional_cross: fp32 (3xTF32), bf16, and
# bf16 operands with an fp32 output (MIXED)
_ATTENTION_MODES = {(_F32, _F32): 0, (_BF16, _BF16): 1, (_BF16, _F32): 2}


def attention_mode(name: str, dtype, out_dtype) -> int:
    """The attention kernels' mode for ``dtype`` operands and an
    ``out_dtype`` output (None: the operands'); raises for a pair no kernel
    takes."""
    mode = _ATTENTION_MODES.get((dtype, out_dtype or dtype))
    if mode is None:
        raise NotImplementedError(f"{name}: {dtype} operands with a {out_dtype} output")
    return mode


def _w8a8_default() -> bool:
    """The INT8 rung's W8A8 mode: off unless ``LGTPU_W8A8`` is set to a value
    other than "" and "0", the switch of the JAX package's ``_w8a8_default``
    (layer_stack.py:72-82). It acts on the two stacks only (the per-block
    route and ``forward_ring`` stay weight-only, as in JAX), and is read at
    every stack call."""
    return os.environ.get("LGTPU_W8A8", "0") not in ("", "0")


# ---------------------------------------------------------------------------
# linear
# ---------------------------------------------------------------------------

# (activations, weight, bias, output) types -> csrc/linear.cu:lg_linear's mode
_LINEAR_MODES = {
    (_F32, _F32, _F32, _F32): 0,      # FP32, the 3xTF32 GEMM
    (_BF16, _BF16, _BF16, _BF16): 1,  # BF16
    (_F32, _BF16, _F32, _F32): 2,     # MIXED: fp32 activations, bf16 products
    (_F32, _BF16, _F32, _BF16): 3,    # MIXED, the qkv and qk_v projections (bf16 out)
    (_BF16, _I8, _F32, _BF16): 4,     # INT8 weight-only
}


def row_quant_plain(a, a2=None):
    """``row_quant`` in plain PyTorch: JAX ``_aquant`` (:339-346) over each
    row of [a | a2]."""
    x = (a if a2 is None else torch.cat([a, a2], dim=-1)).float()
    sa = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / sa), -127.0, 127.0).to(torch.int8)
    return q, sa[..., 0]


def _row_quant_cuda(a, a2):
    """``row_quant``'s CUDA implementation: checks, then one launch."""
    k1 = a.shape[-1]
    k = k1 + (0 if a2 is None else a2.shape[-1])
    for t in (a, a2):
        if t is not None and (t.dtype != _BF16 or not t.is_contiguous()):
            raise NotImplementedError("row_quant: contiguous bf16 rows")
    if k > _S8_MAX_K or k % 16 or (a2 is not None and a2.shape[:-1] != a.shape[:-1]):
        raise ValueError(f"row_quant: rows of {k} (<= 512, x16), operands {a.shape} "
                         f"{None if a2 is None else a2.shape}")
    q = torch.empty((*a.shape[:-1], k), dtype=_I8, device=a.device)
    sa = torch.empty(a.shape[:-1], dtype=_F32, device=a.device)
    err = _build.lib().lg_row_quant(a.data_ptr(), None if a2 is None else a2.data_ptr(), k1, k,
                                    a.numel() // k1, q.data_ptr(), sa.data_ptr(), _stream(a))
    _build.check(err, "row_quant")
    row_quant.launches += 1
    return q, sa


def _row_quant_fake(a, a2):
    k = a.shape[-1] + (0 if a2 is None else a2.shape[-1])
    return (a.new_empty((*a.shape[:-1], k), dtype=_I8),
            a.new_empty(a.shape[:-1], dtype=_F32))


_ROW_QUANT = _build.define_op("row_quant(Tensor a, Tensor? a2) -> (Tensor, Tensor)",
                              cpu=row_quant_plain, cuda=_row_quant_cuda, fake=_row_quant_fake)


def row_quant(a, a2=None):
    """W8A8's activation quantization of each row of [a | a2] (bf16, K <= 512
    in all, K % 16 == 0): sa = max(amax, 1e-6) * (1/127), q = clip(rint(v /
    sa), -127, 127). Returns (q (..., K) int8, sa (...,) fp32)."""
    return _build.run(_ROW_QUANT, row_quant_plain, _row_quant_cuda, a, a2)


row_quant.launches = 0


def linear_plain(a, w, b, a2=None, residual=None, live: Optional[Live] = None, *,
                 scale=None, out_dtype=None, w8a8: bool = False, w_t=None):
    """[a | a2] @ w + b (+ residual): fp32 accumulation of w-dtype operands,
    cast to a's dtype, bias added in a's dtype, residual added in a's dtype,
    one cast to ``out_dtype``. int8 ``w`` with ``scale``: the product takes
    ``quant.dequantize`` (JAX ``_take_linear`` :245-249, the weights the
    INT8 GEMM stages), or with ``w8a8`` the int8 rows of
    ``row_quant_plain`` (JAX ``_linear``'s q8 branch :368-372: the exact
    integer sum times sa times scale, rounded to bf16). With ``live`` and a
    residual, a retired pair's rows are the residual. ``w_t``, the kernel's
    K-major copy of ``w``, is not read."""
    x = a if a2 is None else torch.cat([a, a2], dim=-1)
    if w8a8:  # every partial sum is an integer below 2^24: exact in fp32
        q, sa = row_quant_plain(a, a2)
        acc = q.float() @ w.float()
        y = ((acc * sa[..., None]) * scale.float()).to(a.dtype) + b.to(a.dtype)
    else:
        if scale is not None:
            w = quant.dequantize({"w_q": w, "scale": scale})
        y = (x.to(w.dtype).float() @ w.float()).to(a.dtype) + b.to(a.dtype)
    if residual is not None:
        new = y + residual
        y = new if live is None else torch.where((live.exit > live.layer).view(-1, 1, 1), new,
                                                 residual)
    return y.to(out_dtype or a.dtype)


def linear(a, w, b, a2=None, residual=None, live: Optional[Live] = None, *,
           scale=None, out_dtype=None, w8a8: bool = False, w_t=None):
    """Y = [a | a2] @ w + b (+ residual) over the last dim.

    Args:
      a: (..., K1) activations; a2: optional (..., K - K1) second operand
        (the concat is never materialised); w: (K, N); b: (N,);
        residual: optional (..., N) in a's dtype. On the card the types are
        one row of ``_LINEAR_MODES``.
      scale: (N,) fp32 per-channel scale of an int8 ``w`` (INT8); with
        ``w8a8`` the activation rows are quantized by ``row_quant`` (its own
        launch) and multiplied as int8 (bf16 activations, fp32 bias) by the
        s8 GEMM, which reads ``w_t``: ``w`` K-major, (N, K) int8 contiguous
        (the INT8 tree's ``w_t``, runtime/weights.py:params_from_numpy).
      out_dtype: Y's type (default a's); MIXED's bf16 output takes no
        residual.
      live: optional liveness operand; then ``a`` is (B, N, K1) and a
        retired pair's rows are skipped (unwritten) or, with a residual,
        copied from it.
    """
    return _build.run(_LINEAR, _linear_cpu, _linear_cuda, a, w, b, a2, residual,
                      *_flat_live(live), scale, out_dtype, bool(w8a8), w_t)


def _linear_cpu(a, w, b, a2, residual, live_exit, live_layer, scale, out_dtype, w8a8, w_t):
    return linear_plain(a, w, b, a2, residual, _live(live_exit, live_layer), scale=scale,
                        out_dtype=out_dtype, w8a8=w8a8, w_t=w_t)


def _linear_fake(a, w, b, a2, residual, live_exit, live_layer, scale, out_dtype, w8a8, w_t):
    return a.new_empty((*a.shape[:-1], w.shape[1]), dtype=out_dtype or a.dtype)


def _linear_cuda(a, w, b, a2, residual, live_exit, live_layer, scale, out_dtype, w8a8, w_t):
    """``linear``'s CUDA implementation: checks, then one GEMM launch (W8A8:
    ``row_quant``'s launch, then the s8 GEMM's), counted once."""
    live = _live(live_exit, live_layer)
    out_dtype = out_dtype or a.dtype
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
    if (w.dtype == _I8) != (scale is not None) or (
            scale is not None and (scale.shape != (n,) or scale.dtype != _F32)):
        raise ValueError("linear: int8 weights, and only they, take an (N,) fp32 scale")
    for t in (a, a2, w, b, residual, scale):
        if t is not None and not t.is_contiguous():
            raise ValueError("linear: operands must be contiguous")
    rows = a.shape[1] if a.dim() == 3 else m
    if live is not None and (a.dim() != 3 or rows % 64 or live.exit.shape != (a.shape[0],)):
        raise ValueError(f"linear: liveness needs (B, N % 64 == 0, K) rows, got {a.shape}")
    types = (a.dtype, w.dtype, b.dtype, out_dtype)
    mode = _LINEAR_MODES.get(types)
    if w8a8:
        if types != (_BF16, _I8, _F32, _BF16) or k > _S8_MAX_K:
            raise NotImplementedError(f"linear: W8A8 takes bf16 rows of K <= 512, int8 weights "
                                      f"and an fp32 bias; got {types}, K={k}")
        if (w_t is None or w_t.dtype != _I8 or w_t.shape != (n, k) or not w_t.is_contiguous()
                or w_t.device != w.device):
            raise ValueError(f"linear: W8A8 takes w_t, w K-major ({n}, {k}) int8 contiguous")
    elif mode is None or (mode == 3 and residual is not None):
        raise NotImplementedError(f"linear: operand types {types} (the card takes "
                                  f"{list(_LINEAR_MODES)})")
    if any(t is not None and (t.dtype != a.dtype or t.device != a.device) for t in (a2, residual)):
        raise NotImplementedError("linear: a2 and the residual share a's dtype and device")
    if not w8a8:  # both wgmma GEMMs read a, a2 and w through TMA
        _check_tma("linear", (a, k1), (a2, k - k1), (w, n))
    y = torch.empty((*lead, n), dtype=out_dtype, device=a.device)
    if w8a8:
        q, sa = row_quant(a, a2)
        linear_s8(q, sa, w_t, scale, b, residual, y, live, rows)
    else:
        exit_ptr, layer, _ = _live_args(live, rows)
        err = _build.lib().lg_linear(
            a.data_ptr(), None if a2 is None else a2.data_ptr(), k1, w.data_ptr(),
            None if scale is None else scale.data_ptr(), b.data_ptr(),
            None if residual is None else residual.data_ptr(), y.data_ptr(),
            m, n, k, exit_ptr, layer, rows, mode, _stream(a),
        )
        _build.check(err, "linear")
    linear.launches += 1
    return y


def linear_s8(q, sa, w_t, scale, b, residual, y, live: Optional[Live], rows: int) -> None:
    """W8A8's GEMM, the launch ``linear`` makes after ``row_quant``: y =
    round((float(q . w) * sa) * scale) + round(b) (+ residual) into ``y``,
    with the weight given K-major (``w_t`` (N, K)) at ``s8_plan``'s block;
    ``linear`` counts it."""
    m, k = q.numel() // q.shape[-1], q.shape[-1]
    err = _build.lib().lg_linear_s8(q.data_ptr(), sa.data_ptr(), w_t.data_ptr(),
                                    scale.data_ptr(), b.data_ptr(),
                                    None if residual is None else residual.data_ptr(),
                                    y.data_ptr(), m, w_t.shape[0], k, *_live_args(live, rows),
                                    _stream(q))
    _build.check(err, "linear")


_LINEAR = _build.define_op(
    "linear(Tensor a, Tensor w, Tensor b, Tensor? a2, Tensor? residual, Tensor? live_exit, "
    "int live_layer, Tensor? scale, ScalarType? out_dtype, bool w8a8, Tensor? w_t) -> Tensor",
    cpu=_linear_cpu, cuda=_linear_cuda, fake=_linear_fake)
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
                    live: Optional[Live] = None, dir1: bool = False):
    """Masked multi-head attention with the reference's rounding points.

    q: (B, Nq, H*D), k/v: (B, Nk, H*D) in the operand dtype; freqs:
    (B, 2, N, D) fp32 or None; len_q/len_kv: (B,) ints or None;
    keep_q/keep_kv: (B, Nq)/(B, Nk) fp32 0/1 keep masks, which replace the
    lengths. The fp32 result is cast once to ``out_dtype`` (default: the
    operand dtype). ``dir1``: l sums p after its cast to the operand dtype
    (the reference's shared-S direction 1, layer_stack.py:543-549).
    ``live`` changes nothing here: a retired pair's rows are computed,
    where the kernel leaves them unwritten."""
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
    l = _quant((p.to(dt).float() if dir1 else p).sum(dim=-1, keepdim=True), stat_dtype)
    o = (p.to(dt).float() @ vh.float()) / torch.where(l == 0.0, 1.0, l)
    if keep:
        o = o * keep_q.view(bsz, 1, nq, 1)
    elif masked:
        rows = torch.arange(nq, device=q.device)[:, None]
        o = torch.where(rows < len_q.view(-1, 1, 1, 1), o, 0.0)
    return o.transpose(1, 2).reshape(bsz, nq, e).to(out_dtype or dt)


def attention(q, k, v, freqs, len_q, len_kv, num_heads, stat_dtype,
              out_dtype=None, keep_q=None, keep_kv=None,
              live: Optional[Live] = None, dir1: bool = False):
    """Multi-head attention over (B, N, H*64) rows, heads in column blocks.

    q, k, v may be column slices of a wider projection (any batch and row
    stride, unit column stride). ``freqs`` (B, 2, N, 64) turns on half-split
    RoPE for q and k (self-attention, Nq == Nk); ``len_q``/``len_kv`` (B,)
    mask padded rows/columns (both or neither). ``keep_q``/``keep_kv``
    (B, Nq)/(B, Nk) fp32 0/1 (both or neither) mask by width pruning's keep
    vectors instead: kv columns < 0.5 are masked and output rows are scaled
    by their keep. ``live`` skips retired pairs (their rows stay unwritten).
    ``dir1``: the cross block's direction 1, whose row sum takes p after
    its cast to the operand dtype (the same at bf16 stats; at MIXED the
    reference's rule). Returns (B, Nq, H*64) in ``out_dtype``: on the card
    the operand dtype, or fp32 beside bf16 operands (MIXED). On the card
    Nk <= 1024 (``attention_plan``); with RoPE, q and k are rotated once
    into a scratch of their type first, and the pair of launches counts as
    one."""
    return _build.run(_ATTENTION, _attention_cpu, _attention_cuda, q, k, v, freqs, len_q,
                      len_kv, num_heads, stat_dtype, out_dtype, keep_q, keep_kv,
                      *_flat_live(live), bool(dir1))


def _attention_cpu(q, k, v, freqs, len_q, len_kv, num_heads, stat_dtype, out_dtype, keep_q,
                   keep_kv, live_exit, live_layer, dir1):
    return attention_plain(q, k, v, freqs, len_q, len_kv, num_heads, stat_dtype, out_dtype,
                           keep_q, keep_kv, _live(live_exit, live_layer), dir1)


def _attention_fake(q, k, v, freqs, len_q, len_kv, num_heads, stat_dtype, out_dtype, keep_q,
                    keep_kv, live_exit, live_layer, dir1):
    return q.new_empty(q.shape, dtype=out_dtype or q.dtype)


def _attention_cuda(q, k, v, freqs, len_q, len_kv, num_heads, stat_dtype, out_dtype, keep_q,
                    keep_kv, live_exit, live_layer, dir1):
    """``attention``'s CUDA implementation: checks, then (with RoPE, after
    ``lg_rope_qk``'s launch) one launch, counted once."""
    live = _live(live_exit, live_layer)
    _check_same("attention", q.dtype, q, k, v)
    mode = attention_mode("attention", q.dtype, out_dtype)
    bsz, nq, e = q.shape
    nk = k.shape[1]
    if e != num_heads * HEAD_DIM or k.shape[-1] != e or v.shape[:2] != k.shape[:2]:
        raise ValueError(f"attention: head dim must be {HEAD_DIM}: {q.shape} {k.shape}")
    if k.shape[0] != bsz or v.shape[-1] != e:
        raise ValueError(f"attention: shapes {q.shape} {k.shape} {v.shape}")
    if min(t.stride(-1) for t in (q, k, v)) != 1 or max(t.stride(-1) for t in (q, k, v)) != 1:
        raise ValueError("attention: q/k/v need unit column stride")
    attention_plan(bsz, num_heads, nq, nk, q.dtype, stat_dtype)  # raises where it cannot run
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
    unit = 16 // q.element_size()  # both kernels read q, k and v through TMA
    for t in (q, k, v):
        if t.data_ptr() % 16 or t.stride(1) % unit or (bsz > 1 and t.stride(0) % unit):
            raise ValueError(f"attention: an operand TMA cannot address (base "
                             f"{t.data_ptr():#x}, strides {t.stride()}): 16 B bases "
                             "and row and batch strides")
    out = torch.empty((bsz, nq, e), dtype=out_dtype or q.dtype, device=q.device)
    if freqs is not None:
        # RoPE once per row into a scratch (2, B, N, E), which the kernel reads
        rot = torch.empty((2, bsz, nq, e), dtype=q.dtype, device=q.device)
        err = _build.lib().lg_rope_qk(q.data_ptr(), q.stride(0), q.stride(1),
                                      k.data_ptr(), k.stride(0), k.stride(1),
                                      freqs.data_ptr(), rot.data_ptr(), bsz, nq, num_heads,
                                      mode, _stream(q))
        _build.check(err, "attention (RoPE)")
        q, k = rot[0], rot[1]
    err = _build.lib().lg_attention(
        q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(1),
        v.data_ptr(), v.stride(0), v.stride(1),
        None if len_q is None else len_q.data_ptr(),
        None if len_kv is None else len_kv.data_ptr(),
        None if keep_q is None else keep_q.data_ptr(),
        None if keep_kv is None else keep_kv.data_ptr(),
        *_live_args(live, nq)[:2],
        out.data_ptr(), bsz, nq, nk, num_heads, 1.0 / math.sqrt(HEAD_DIM),
        int(stat_dtype == torch.bfloat16), mode, int(dir1), _stream(q),
    )
    _build.check(err, "attention")
    attention.launches += 1
    return out


_ATTENTION = _build.define_op(
    "attention(Tensor q, Tensor k, Tensor v, Tensor? freqs, Tensor? len_q, Tensor? len_kv, "
    "int num_heads, ScalarType stat_dtype, ScalarType? out_dtype, Tensor? keep_q, "
    "Tensor? keep_kv, Tensor? live_exit, int live_layer, bool dir1) -> Tensor",
    cpu=_attention_cpu, cuda=_attention_cuda, fake=_attention_fake)
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


# (rows, gamma and beta) types -> csrc/ln_gelu.cu:lg_ln_gelu's mode; INT8
# keeps LayerNorm in fp32 beside bf16 rows
_LN_MODES = {(_F32, _F32): 0, (_BF16, _BF16): 1, (_BF16, _F32): 2}
LN_MAX_C = 512    # the widest row
LN_ROW_LANES = 32  # lanes of a row
LN_THREADS = 128   # threads of a block


class LnPlan(NamedTuple):
    row_lanes: int  # lanes of a warp per row
    vectors: int    # 16-byte vectors of the row per lane
    columns: int    # columns of a vector
    threads: int    # threads of a block


def ln_gelu_plan(dtype) -> LnPlan:
    """``ln_gelu``'s lane map for ``dtype`` rows (csrc/ln_gelu.cu, which
    ``lg_ln_gelu_plan`` reports): lane l of a row takes the vectors l,
    l + row_lanes, ..., vector j holding columns j * columns .. + columns - 1
    (those below C; a row whose C is not a multiple of ``columns`` is read
    by element on the same map)."""
    columns = 16 // torch.empty((), dtype=dtype).element_size()
    return LnPlan(LN_ROW_LANES, LN_MAX_C // (columns * LN_ROW_LANES), columns, LN_THREADS)


def ln_gelu(h, g, b, live: Optional[Live] = None):
    """GELU(LayerNorm(h) * g + b) over the last dim (<= 512), fp32 math,
    result in h's dtype; g and b in h's dtype or fp32 (``_LN_MODES``). With
    ``live``, h is (B, N, C) and a retired pair's rows stay unwritten."""
    return _build.run(_LN_GELU, _ln_gelu_cpu, _ln_gelu_cuda, h, g, b, *_flat_live(live))


def _ln_gelu_cpu(h, g, b, live_exit, live_layer):
    return ln_gelu_plain(h, g, b, _live(live_exit, live_layer))


def _ln_gelu_fake(h, g, b, live_exit, live_layer):
    return h.new_empty(h.shape)


def _ln_gelu_cuda(h, g, b, live_exit, live_layer):
    """``ln_gelu``'s CUDA implementation: checks, then one launch."""
    live = _live(live_exit, live_layer)
    _check_same("ln_gelu", g.dtype, g, b)
    mode = _LN_MODES.get((h.dtype, g.dtype))
    if mode is None or h.device != g.device:
        raise NotImplementedError(f"ln_gelu: {h.dtype} rows with {g.dtype} gamma and beta")
    c = h.shape[-1]
    if c > LN_MAX_C or g.shape != (c,) or b.shape != (c,):
        raise ValueError(f"ln_gelu: width {c} (<= 512), gamma/beta {g.shape}")
    if not (h.is_contiguous() and g.is_contiguous() and b.is_contiguous()):
        raise ValueError("ln_gelu: operands must be contiguous")
    if live is not None and (h.dim() != 3 or live.exit.shape != (h.shape[0],)):
        raise ValueError(f"ln_gelu: liveness needs (B, N, C) rows, got {h.shape}")
    y = torch.empty_like(h)
    err = _build.lib().lg_ln_gelu(
        h.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
        h.numel() // c, c, *_live_args(live, h.shape[1] if h.dim() == 3 else 1),
        mode, _stream(h),
    )
    _build.check(err, "ln_gelu")
    ln_gelu.launches += 1
    return y


_LN_GELU = _build.define_op(
    "ln_gelu(Tensor h, Tensor g, Tensor b, Tensor? live_exit, int live_layer) -> Tensor",
    cpu=_ln_gelu_cpu, cuda=_ln_gelu_cuda, fake=_ln_gelu_fake)
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


# (rows, heads) types -> csrc/adaptive.cu:lg_adaptive_decide's mode; MIXED
# rounds fp32 rows to the bf16 heads' type
_DECIDE_MODES = {(_F32, _F32): 0, (_BF16, _BF16): 1, (_F32, _BF16): 2}
# csrc/adaptive.cu: threads of a block, the blocks a launch aims for, a
# block's row copies at most (bytes)
_DECIDE_THREADS, _DECIDE_FILL, _DECIDE_MAX_SMEM = 256, 256, 48 * 1024


class DecidePlan(NamedTuple):
    """Launch of ``csrc/adaptive.cu`` for one shape."""

    rows: int     # rows of one pair a block takes (a row per warp at least)
    threads: int
    blocks: int   # blocks of the launch: blocks per pair x B
    smem: int     # dynamic shared memory per block: its rows, bytes


def decide_plan(bsz: int, n0: int, n1: int, e: int, itemsize: int) -> DecidePlan:
    """The decision's launch (csrc/adaptive.cu:decide_rows, which
    ``lg_decide_plan`` reports): rows per block the largest of 32, 16 and 8
    whose grid has ``_DECIDE_FILL`` blocks, else 8. Raises where a block's
    rows of ``itemsize``-byte values exceed its shared memory."""
    rows = n0 + n1
    r = next((r for r in (32, 16) if bsz * -(-rows // r) >= _DECIDE_FILL), 8)
    plan = DecidePlan(r, _DECIDE_THREADS, bsz * -(-rows // r), r * e * itemsize)
    if plan.smem > _DECIDE_MAX_SMEM:
        raise ValueError(f"adaptive_decide: {plan.smem} B of rows a block, E={e}")
    return plan


# device -> (counters (pairs, 4) int32, flags (pairs * 2 * MAX_SEQ,) uint8):
# the blocks of a pair meet there; zeroed once, and the kernel leaves the
# counters zeroed, so a replayed CUDA graph starts clean. The launches of a
# device share it, so they run one after another (one stream). A grown
# scratch keeps the old one alive: a captured graph may still use it.
_DECIDE_SCRATCH: dict = {}
_RETIRED_SCRATCH: list = []


def _decide_scratch(device: torch.device, pairs: int):
    have = _DECIDE_SCRATCH.get(device)
    if have is not None and have[0].shape[0] >= pairs:
        return have
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("adaptive_decide: run one call at this batch size outside CUDA "
                           "graph capture first (it allocates the decision's scratch)")
    if have is not None:
        _RETIRED_SCRATCH.append(have)
    pairs = max(pairs, 8, 2 * (have[0].shape[0] if have is not None else 0))
    scratch = (torch.zeros((pairs, 4), dtype=torch.int32, device=device),
               torch.zeros(pairs * 2 * MAX_SEQ, dtype=torch.uint8, device=device))
    _DECIDE_SCRATCH[device] = scratch
    return scratch


def adaptive_decide(x0, x1, w_tok, b_tok, exit, *, layer: int, n_layers: int,
                    depth_confidence: float, lengths0=None, lengths1=None,
                    w_match=None, b_match=None, width_confidence: float = -1.0,
                    keep0=None, keep1=None) -> None:
    """Early-exit and pruning decision of every live pair after global layer
    ``layer`` of an ``n_layers`` stack; updates ``exit`` and the keep masks
    IN PLACE (they are the stack's device-resident state).

    Args:
      x0/x1: (B, N0, E) / (B, N1, E) activations after the layer.
      w_tok: (E,) token-confidence head in the attention operand dtype
        (x's, or bf16 beside fp32 x at MIXED: x is rounded to it);
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
    _build.run(_DECIDE, _adaptive_decide_cpu, _adaptive_decide_cuda, x0, x1, w_tok, b_tok, exit,
               int(layer), int(n_layers), float(depth_confidence), lengths0, lengths1, w_match,
               b_match, float(width_confidence), keep0, keep1)


def _adaptive_decide_cpu(x0, x1, w_tok, b_tok, exit, layer, n_layers, depth_confidence,
                         lengths0, lengths1, w_match, b_match, width_confidence, keep0, keep1):
    adaptive_decide_plain(x0, x1, w_tok, b_tok, exit, layer=layer, n_layers=n_layers,
                          depth_confidence=depth_confidence, lengths0=lengths0,
                          lengths1=lengths1, w_match=w_match, b_match=b_match,
                          width_confidence=width_confidence, keep0=keep0, keep1=keep1)


def _adaptive_decide_fake(x0, x1, w_tok, b_tok, exit, layer, n_layers, depth_confidence,
                          lengths0, lengths1, w_match, b_match, width_confidence, keep0, keep1):
    return None


def _adaptive_decide_cuda(x0, x1, w_tok, b_tok, exit, layer, n_layers, depth_confidence,
                          lengths0, lengths1, w_match, b_match, width_confidence, keep0, keep1):
    """``adaptive_decide``'s CUDA implementation: checks, then one launch
    that updates ``exit`` and the keep masks in place."""
    _check_same("adaptive_decide", x0.dtype, x0, x1)
    _check_same("adaptive_decide", w_tok.dtype, w_tok, w_match)
    mode = _DECIDE_MODES.get((x0.dtype, w_tok.dtype))
    if mode is None or x0.device != w_tok.device:
        raise NotImplementedError(f"adaptive_decide: {x0.dtype} rows with {w_tok.dtype} heads")
    _decide_checks(x0, x1, w_tok, b_tok, exit, lengths0, lengths1, w_match, b_match,
                   keep0, keep1)
    bsz, n0, e = x0.shape
    n1 = x1.shape[1]
    if n0 > MAX_SEQ or n1 > MAX_SEQ or not (x0.is_contiguous() and x1.is_contiguous()):
        raise ValueError(f"adaptive_decide: contiguous rows, N <= {MAX_SEQ}: {n0} {n1}")
    if (e * x0.element_size()) % 16 or x0.data_ptr() % 16 or x1.data_ptr() % 16:
        raise ValueError(f"adaptive_decide: rows are copied 16 B at a time: E={e} {x0.dtype}")
    decide_plan(bsz, n0, n1, e, x0.element_size())  # raises where the launch cannot run
    if lengths0 is not None:
        lengths0 = lengths0.to(torch.int32).contiguous()
        lengths1 = lengths1.to(torch.int32).contiguous()
    width = keep0 is not None
    counters, flags = _decide_scratch(x0.device, bsz)
    err = _build.lib().lg_adaptive_decide(
        x0.data_ptr(), x1.data_ptr(), bsz, n0, n1, e,
        w_tok.data_ptr(), b_tok.data_ptr(), token_logit_threshold(layer, n_layers),
        w_match.data_ptr() if width else None, b_match.data_ptr() if width else None,
        _logit(1.0 - width_confidence) if width else 0.0,
        None if lengths0 is None else lengths0.data_ptr(),
        None if lengths1 is None else lengths1.data_ptr(),
        keep0.data_ptr() if width else None, keep1.data_ptr() if width else None,
        exit.data_ptr(), layer, n_layers, depth_confidence, mode, counters.data_ptr(),
        flags.data_ptr(), _stream(x0),
    )
    _build.check(err, "adaptive_decide")
    adaptive_decide.launches += 1


# exit and the keep masks are the stack's device state, updated in place
_DECIDE = _build.define_op(
    "adaptive_decide(Tensor x0, Tensor x1, Tensor w_tok, Tensor b_tok, Tensor(a!) exit, "
    "int layer, int n_layers, float depth_confidence, Tensor? lengths0, Tensor? lengths1, "
    "Tensor? w_match, Tensor? b_match, float width_confidence, Tensor(b!)? keep0, "
    "Tensor(c!)? keep1) -> ()",
    cpu=_adaptive_decide_cpu, cuda=_adaptive_decide_cuda, fake=_adaptive_decide_fake)
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
    e = d0.shape[-1]
    n_layers = layers["self_attn"]["ln_g"].shape[0]
    attn_dtype = attn_dtype or d0.dtype
    lens = (None, None) if lengths0 is None else (lengths0, lengths1)
    keep = (None, None) if adaptive is None or adaptive.keep is None else adaptive.keep
    freqs = (freqs0.float(), freqs1.float())
    quantized = "w_q" in layers["self_attn"]["qkv"]
    w8a8 = quantized and _w8a8_default()

    def operands(block):  # name -> (weights, scales, biases, K-major int8 weights), cast once
        return {name: (p["w_q"], p["scale"], p["b"], p.get("w_t") if w8a8 else None)
                if quantized
                else (p["w"].to(attn_dtype), None, p["b"], None)
                for name, p in block.items() if isinstance(p, dict)}

    sp, cp = layers["self_attn"], layers["cross_attn"]
    sw, cw = operands(sp), operands(cp)

    def lin(ws, name, l, x, a2=None, residual=None, out_dtype=None):
        w, scale, b, w_t = ws[name]
        return ops.linear(x, w[l], b[l], a2=a2, residual=residual, live=live,
                          scale=None if scale is None else scale[l], out_dtype=out_dtype,
                          w8a8=w8a8, w_t=None if w_t is None else w_t[l])

    def ffn(p, ws, l, x, message):
        h = lin(ws, "ffn1", l, x, a2=message)
        act = ops.ln_gelu(h, p["ln_g"][l], p["ln_b"][l], live=live)
        return lin(ws, "ffn2", l, act, residual=x)

    def attend(q, k, v, f, i, j):  # rows of image i attend to image j
        return ops.attention(q, k, v, f, lens[i], lens[j], num_heads, stat_dtype, d0.dtype,
                             keep_q=keep[i], keep_kv=keep[j], live=live, dir1=i == 1 and j == 0)

    x = [d0, d1]
    for l in range(n_layers):
        live = None if adaptive is None else adaptive.live(l)
        for i in (0, 1):  # self block, per image (the buckets may differ)
            # (B, N, 3E) = [q | k | v], in the attention operand dtype
            qkv = lin(sw, "qkv", l, x[i], out_dtype=attn_dtype)
            ctx = attend(qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:], freqs[i], i, i)
            x[i] = ffn(sp, sw, l, x[i], lin(sw, "out", l, ctx))
        # (B, N, 2E) = [qk | v]
        qk_v = [lin(cw, "qk_v", l, x[i], out_dtype=attn_dtype) for i in (0, 1)]
        qk = [t[..., :e] for t in qk_v]
        v = [t[..., e:] for t in qk_v]
        msgs = (attend(qk[0], qk[1], v[1], None, 0, 1),
                attend(qk[1], qk[0], v[0], None, 1, 0))
        x = [ffn(cp, cw, l, x[i], lin(cw, "out", l, msgs[i])) for i in (0, 1)]
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
