"""SuperPoint's conv2 pair in one kernel: conv2a -> conv2b -> 2x2 max-pool.

Counterpart of ``lightglue_tpu/kernels/conv_chain.py:conv2_chain`` (wrapper
:140, pallas_call :180, body :51-134): conv2a (bias, ReLU, rounded to x's
dtype, zero outside the image), conv2b (bias, optional ReLU) and the pool in
one call, so conv2a's output stays on chip. On the TPU it lost its A/B to
the two-call chain and the model never calls it (its docstring :24-28);
neither does the port's SuperPoint, which runs ``conv.conv3x3`` twice. It
is a tested variant.

On a CUDA tensor ``conv2_chain`` launches ``csrc/conv_chain.cu`` once (see
its header for the designs and what bounds them), both operand dtypes on the
tensor cores over 16x16 output tiles whose 18x18 conv2a tile stays in
shared memory: bf16 operands with persistent blocks, both layers' weights
resident and one buffer that holds a tile's input and then its bf16 conv2a
tile; fp32 operands in 3xTF32 (each operand split into two TF32 values,
three ``mma.sync`` products per step), K streamed in 8-channel chunks of
conv2a's then conv2b's weights, the conv2a tile in fp32. ``chain_plan``
mirrors the launch. On a CPU tensor it runs ``conv2_chain_plain``: two
``conv3x3_plain`` calls with the intermediate cast to x's dtype. Both are
the implementations of the operator ``lightglue_tpu_torch::conv2_chain``
(``_build.define_op``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lightglue_tpu_torch.kernels import _build
from lightglue_tpu_torch.kernels.conv import conv3x3_plain

CHANNELS = 64
# csrc/conv_chain.cu: the conv2b output tile side (pre-pool), the threads of
# a block (8 warps), and the fp32 kernel's pitches: a K chunk's input
# channels and the pixel pitch of its input tile (floats), the split
# weights' row ((hi, lo) pairs) and conv2a's tile pixel (floats)
CHAIN_TILE = 16
CHAIN_THREADS = 256
CHAIN_K_CHUNK = 8
CHAIN_PITCH_IN = CHAIN_K_CHUNK + 4
CHAIN_PAIR_PITCH = CHANNELS + 4
CHAIN_PITCH_MID = CHANNELS + 4
# bf16: mma.cuh's LD pitch (64 channels + 8)
CHAIN_LD = CHANNELS + 8


class ChainPlan(NamedTuple):
    tile: int     # conv2b output tile side, pre-pool
    threads: int
    tiles: int    # output tiles (the bf16 kernel's persistent blocks walk them)
    smem: int     # dynamic shared memory, bytes


def chain_plan(b: int, h: int, w: int, dtype=torch.bfloat16) -> ChainPlan:
    """A ``conv2_chain`` launch with ``dtype`` operands, as ``lg_chain_plan``
    reports it. Both kernels tile conv2b's output 16x16, so conv2a runs
    over an 18x18 tile from a 20x20 input tile. bf16 (``chain_mma_kernel``):
    both layers' nine taps of weights and one 20x20 activation buffer at the
    LD pitch. fp32 (``chain_tf32x3_kernel``): conv2a's 18x18 tile in fp32 at a
    68-float pitch, a two-stage ring of raw chunks (the input tile's 8
    channels at a 12-float pitch and their nine taps of weights), and one
    buffer of a chunk's weights split into (hi, lo) pairs at a 68-pair
    pitch."""
    t = CHAIN_TILE
    tiles = b * -(-h // t) * -(-w // t)
    side_a, side_x = t + 2, t + 4
    if dtype == torch.float32:
        stage = side_x * side_x * CHAIN_PITCH_IN + 9 * CHAIN_K_CHUNK * CHANNELS
        smem = (4 * (side_a * side_a * CHAIN_PITCH_MID + 2 * stage)
                + 8 * 9 * CHAIN_K_CHUNK * CHAIN_PAIR_PITCH)
    else:
        smem = 2 * (2 * 9 * CHANNELS + side_x * side_x) * CHAIN_LD
    return ChainPlan(t, CHAIN_THREADS, tiles, smem)


def conv2_chain_plain(x, wa, ba, wb, bb, *, relu: bool = True, out_dtype=None):
    """Plain PyTorch version: conv2a (ReLU) in x's dtype, then conv2b and
    the pool (TF32 off on a card, as ``conv3x3_plain``)."""
    mid = conv3x3_plain(x, wa, ba)
    return conv3x3_plain(mid, wb, bb, True, relu=relu, out_dtype=out_dtype)


def _conv2_chain_cuda(x: torch.Tensor, wa: torch.Tensor, ba: torch.Tensor, wb: torch.Tensor,
                      bb: torch.Tensor, relu: bool, out_dtype) -> torch.Tensor:
    """The operator's CUDA implementation: checks, then one launch."""
    bsz, h, wd, c = x.shape
    out_dtype = out_dtype or x.dtype
    if c != CHANNELS or any(tuple(w.shape) != (3, 3, c, c) for w in (wa, wb)):
        raise ValueError(f"conv2_chain takes 64 channels, got {x.shape} {wa.shape} {wb.shape}")
    for t in (x.dtype, out_dtype):
        if t not in (torch.float32, torch.bfloat16) or wa.dtype != x.dtype or wb.dtype != x.dtype:
            raise ValueError(f"conv2_chain dtypes: x {x.dtype}, w {wa.dtype}/{wb.dtype}, "
                             f"out {out_dtype}")
    if ba.shape != (c,) or bb.shape != (c,):
        raise ValueError("conv2_chain biases must be (64,)")
    if h % 2 or wd % 2:
        raise ValueError(f"conv2_chain pools: H and W must be even, got {h}x{wd}")
    ba, bb = ba.float(), bb.float()
    operands = (x, wa, ba, wb, bb)
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("conv2_chain operands must be contiguous")
    if any(t.device != x.device for t in operands):
        raise ValueError("conv2_chain operands must share a device")
    y = torch.empty((bsz, h // 2, wd // 2, c), dtype=out_dtype, device=x.device)
    err = _build.lib().lg_conv2_chain(
        *(t.data_ptr() for t in operands), y.data_ptr(), bsz, h, wd, int(relu),
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "conv2_chain")
    conv2_chain.launches += 1
    return y


def _conv2_chain_cpu(x, wa, ba, wb, bb, relu, out_dtype):
    return conv2_chain_plain(x, wa, ba, wb, bb, relu=relu, out_dtype=out_dtype)


def _conv2_chain_fake(x, wa, ba, wb, bb, relu, out_dtype):
    bsz, h, wd, c = x.shape
    return x.new_empty((bsz, h // 2, wd // 2, c), dtype=out_dtype or x.dtype)


_OP = _build.define_op(
    "conv2_chain(Tensor x, Tensor wa, Tensor ba, Tensor wb, Tensor bb, bool relu, "
    "ScalarType? out_dtype) -> Tensor",
    cpu=_conv2_chain_cpu, cuda=_conv2_chain_cuda, fake=_conv2_chain_fake)


def conv2_chain(x: torch.Tensor, wa: torch.Tensor, ba: torch.Tensor, wb: torch.Tensor,
                bb: torch.Tensor, *, relu: bool = True, out_dtype=None) -> torch.Tensor:
    """conv2a (ReLU) -> conv2b [ReLU] -> 2x2 max-pool, NHWC, one launch.

    Args:
      x: (B, H, W, 64) fp32 or bf16, contiguous; H and W even.
      wa/wb: (3, 3, 64, 64) HWIO in x's dtype; ba/bb: (64,), applied in fp32.
      out_dtype: fp32 or bf16 (default x's dtype).
    Returns (B, H/2, W/2, 64).
    """
    return _build.run(_OP, _conv2_chain_cpu, _conv2_chain_cuda, x, wa, ba, wb, bb, bool(relu),
                      out_dtype)


conv2_chain.launches = 0
