"""Fused SAME 3x3 conv + bias [+ ReLU] [+ 2x2 max-pool], NHWC.

Counterpart of two Pallas functions of ``lightglue_tpu/kernels/conv.py``,
both ``conv3x3`` here:

- ``conv3x3_paired`` (wrapper :356, pallas_call :458), which runs
  SuperPoint's conv1b (+pool), conv2a and conv2b (+pool): 64 -> 64 with
  ReLU, the model's calls. The TPU kernel's paired/offset column layouts
  exist only to fill the MXU; the contract kept is the output of
  ``lightglue_tpu/models/superpoint.py:_relu_conv``: fp32 accumulation,
  fp32 bias, ReLU, the optional pool, then the cast to the activation dtype.
- ``conv3x3`` (wrapper :182, pallas_call :222): the same function for any
  C_in and C_out that are multiples of 8, ReLU optional, any output dtype;
  ``supports`` is its gate (:258-268). Neither package routes SuperPoint
  through it (its C >= 128 convs are plain ``F.conv2d`` here, XLA there); it
  is a tested variant.

On a CUDA tensor ``conv3x3`` launches ``csrc/conv3x3.cu`` (see its header for
the designs and what bounds them). Every call runs an implicit GEMM on the
tensor cores (``mma.sync``, fp32 sums, the bias/ReLU/pool epilogue in fp32
and one cast). With bf16 operands: the model's 64 -> 64 ReLU calls with the
input tile and all nine taps' weights resident in shared memory, every other
shape and option with K streamed in 16-channel chunks over a tile that
``conv_plan`` sizes. With fp32 operands, in 3xTF32 (each operand split into
two TF32 values, three products per step, about fp32's precision): the
model's 64 -> 64 ReLU calls (the MIXED and FP32 rungs) on Hopper's
warpgroup MMA, 16x16 tiles with the weights split per K chunk into K-major
planes and the activations taken as register A (``model_conv_plan``),
every other call on ``mma.sync`` with K streamed in 8-channel chunks over
12x16 tiles (``conv_plan``). On a CPU tensor it runs ``conv3x3_plain``.
Both are the implementations of the operator ``lightglue_tpu_torch::conv3x3``
(``_build.define_op``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from lightglue_tpu_torch.kernels import _build

# csrc/conv3x3.cu's generic launches: output tile width and channels,
# input channels per K chunk (bf16 and fp32 operands), ring stages, the
# blocks the bf16 launch aims for (two per SM), and the fp32 kernel's tile
# rows and pitches: a chunk's input pixel (floats) and its split weights'
# row ((hi, lo) pairs)
CONV_TILE_W = 16
CONV_TILE_N = 64
CONV_K_CHUNK = 16
CONV_K_CHUNK_FP32 = 8
CONV_STAGES = 2
CONV_FILL = 264
CONV_ROWS_FP32 = 12
CONV_PITCH_FP32 = CONV_K_CHUNK_FP32 + 4
CONV_PAIR_PITCH = CONV_TILE_N + 4


class ConvPlan(NamedTuple):
    rows: int     # output rows of a block's tile (16 pixels x 64 channels)
    threads: int  # a warp per 2 rows
    blocks: int
    smem: int     # dynamic shared memory, bytes


def conv_plan(b: int, h: int, w: int, cout: int, dtype=torch.bfloat16) -> ConvPlan:
    """A generic conv's launch with ``dtype`` operands, as ``lg_conv_tile``
    reports it. bf16 (csrc/conv3x3.cu:conv_rows): rows the largest of 16, 8
    and 4 whose grid has CONV_FILL blocks, else 4; each ring stage holds the
    haloed (rows + 2) x 18 tile's 16 channels at a 24-element pitch and
    their nine taps' weights at a 72-element pitch. fp32 (3xTF32):
    CONV_ROWS_FP32 rows; each raw stage holds the tile's 8 channels at a
    12-float pitch and their nine taps' weights for 64 channels, beside one
    buffer of the chunk's weights split into (hi, lo) pairs at a 68-pair
    pitch."""
    per_row = b * -(-w // CONV_TILE_W) * -(-cout // CONV_TILE_N)
    halo = lambda rows: (rows + 2) * (CONV_TILE_W + 2)  # noqa: E731
    if dtype == torch.float32:
        rows = CONV_ROWS_FP32
        stage = halo(rows) * CONV_PITCH_FP32 + 9 * CONV_K_CHUNK_FP32 * CONV_TILE_N
        smem = 4 * CONV_STAGES * stage + 8 * 9 * CONV_K_CHUNK_FP32 * CONV_PAIR_PITCH
    else:
        rows = next((r for r in (16, 8) if per_row * -(-h // r) >= CONV_FILL), 4)
        stage = halo(rows) * (CONV_K_CHUNK + 8) + 9 * CONV_K_CHUNK * (CONV_TILE_N + 8)
        smem = 2 * CONV_STAGES * stage
    return ConvPlan(rows, rows // 2 * 32, per_row * -(-h // rows), smem)


# csrc/conv3x3.cu's model fp32 conv (conv3x3_tf32_wgmma_kernel): the output
# tile side and its threads (two warpgroups)
CONV_MODEL_TILE = 16
CONV_MODEL_THREADS = 256


def model_conv_plan(b: int, h: int, w: int) -> ConvPlan:
    """The launch of the model's fp32 64 -> 64 ReLU conv
    (``conv3x3_tf32_wgmma_kernel``), as ``lg_conv_model_tile`` reports it:
    one block of two warpgroups per 16x16 output tile of one image (a tile
    never spans two images, so an image's result does not depend on its
    batch); its shared memory two raw stages of a K chunk (the haloed 18x18
    tile's 8 channels at 8 floats a pixel, their 9 x 8 x 64 weights) and the
    chunk's weights split into hi and lo planes (three 64 x 32 halves each),
    1 KB to align the planes to 1024 B: two blocks an SM."""
    side = CONV_MODEL_TILE
    stage = (side + 2) ** 2 * CONV_K_CHUNK_FP32 + 9 * CONV_K_CHUNK_FP32 * CONV_TILE_N
    plane = 3 * CONV_TILE_N * 32
    smem = 4 * (2 * plane + CONV_STAGES * stage) + 1024
    return ConvPlan(side, CONV_MODEL_THREADS, b * -(-h // side) * -(-w // side), smem)


def _pick_rows(h: int) -> int:
    """The JAX kernel's strip height (conv.py:162-175), for ``supports``."""
    for rows in (32, 16, 8, 4, 2):
        if h % rows == 0:
            return rows
    return h


def supports(h: int, w: int, cin: int, cout: int, act_dtype) -> bool:
    """The JAX ``conv3x3`` gate (conv.py:258-268), kept as the port's
    contract: W, C_in and C_out multiples of 8, H even, and the TPU kernel's
    two input strips under 40 MB."""
    if w % 8 or cin % 8 or cout % 8:
        return False
    if h < 2 or h % 2:
        return False
    itemsize = torch.empty((), dtype=act_dtype).element_size()
    strip = 2 * (_pick_rows(h) + 2) * (w + 2) * max(cin, 128) * itemsize
    return strip < 40 * 1024 * 1024


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, pool: bool = False, *,
                  relu: bool = True, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version: (B, H, W, C_in) x HWIO (3, 3, C_in, C_out), the
    weights cast to x's dtype, + fp32 bias.

    The product runs on fp32 copies of the operands, so on a card it needs
    TF32 off to be exact (``precision.precision_scope`` does that)."""
    xf = x.float().permute(0, 3, 1, 2)
    wf = w.to(x.dtype).float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    out = F.conv2d(xf, wf, padding=1) + b.float()[None, :, None, None]
    if relu:
        out = F.relu(out)
    if pool:
        out = F.max_pool2d(out, 2)
    return out.permute(0, 2, 3, 1).to(out_dtype or x.dtype).contiguous()


def _conv3x3_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, pool: bool, relu: bool,
                  out_dtype) -> torch.Tensor:
    """The operator's CUDA implementation: checks, then one launch."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    out_dtype = out_dtype or x.dtype
    if cin % 8 or cout % 8 or tuple(w.shape) != (3, 3, cin, cout):
        raise ValueError(f"conv3x3 takes C_in and C_out multiples of 8, got {x.shape} {w.shape}")
    for t in (x.dtype, out_dtype):
        if t not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
            raise ValueError(f"conv3x3 dtypes: x {x.dtype}, w {w.dtype}, out {out_dtype}")
    if b.shape != (cout,):
        raise ValueError(f"conv3x3 bias must be ({cout},), got {tuple(b.shape)}")
    if pool and (h % 2 or wd % 2):
        raise ValueError(f"pooled conv3x3 needs even H and W, got {h}x{wd}")
    b = b.float()
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv3x3 operands must be contiguous")
    if not (x.device == w.device == b.device):
        raise ValueError("conv3x3 operands must share a device")
    oh, ow = (h // 2, wd // 2) if pool else (h, wd)
    y = torch.empty((bsz, oh, ow, cout), dtype=out_dtype, device=x.device)
    err = _build.lib().lg_conv3x3(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, h, wd, cin, cout,
        int(pool), int(relu), int(x.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "conv3x3")
    conv3x3.launches += 1
    return y


def _conv3x3_cpu(x, w, b, pool, relu, out_dtype):
    return conv3x3_plain(x, w, b, pool, relu=relu, out_dtype=out_dtype)


def _conv3x3_fake(x, w, b, pool, relu, out_dtype):
    bsz, h, wd, _ = x.shape
    oh, ow = (h // 2, wd // 2) if pool else (h, wd)
    return x.new_empty((bsz, oh, ow, w.shape[-1]), dtype=out_dtype or x.dtype)


_OP = _build.define_op(
    "conv3x3(Tensor x, Tensor w, Tensor b, bool pool, bool relu, ScalarType? out_dtype) -> Tensor",
    cpu=_conv3x3_cpu, cuda=_conv3x3_cuda, fake=_conv3x3_fake)


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, pool: bool = False, *,
            relu: bool = True, out_dtype=None) -> torch.Tensor:
    """SAME 3x3 conv + bias [+ ReLU] [+ 2x2 max-pool] on NHWC activations.

    Args:
      x: (B, H, W, C_in) fp32 or bf16, contiguous; H and W even when ``pool``.
      w: (3, 3, C_in, C_out) HWIO in x's dtype; C_in, C_out multiples of 8.
      b: (C_out,), applied in fp32.
      out_dtype: fp32 or bf16 (default x's dtype).
    Returns (B, H, W, C_out), or (B, H/2, W/2, C_out) with ``pool``.
    """
    return _build.run(_OP, _conv3x3_cpu, _conv3x3_cuda, x, w, b, bool(pool), bool(relu),
                      out_dtype)


conv3x3.launches = 0
