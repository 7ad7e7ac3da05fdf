"""SuperPoint's conv2 pair in one kernel: conv2a -> conv2b -> 2x2 max-pool.

Counterpart of ``lightglue_tpu/kernels/conv_chain.py:conv2_chain`` (wrapper
:140, pallas_call :180, body :51-134): conv2a (bias, ReLU, rounded to x's
dtype, zero outside the image), conv2b (bias, optional ReLU) and the pool in
one call, so conv2a's output stays on chip. On the TPU it lost its A/B to
the two-call chain and the model never calls it (its docstring :24-28);
neither does the port's SuperPoint, which runs ``conv.conv3x3`` twice. It
is a tested variant.

On a CUDA tensor ``conv2_chain`` launches ``csrc/conv_chain.cu`` once (see
its header for the designs and what bounds them): bf16 operands on the
tensor cores, persistent blocks with both layers' weights resident and one
buffer that holds a 16x16 output tile's input and then its bf16 conv2a
tile; fp32 operands on the FMA units. On a CPU tensor it runs
``conv2_chain_plain``: two ``conv3x3_plain`` calls with the intermediate
cast to x's dtype.
"""

from __future__ import annotations

import torch

from lightglue_tpu_torch.kernels import _build
from lightglue_tpu_torch.kernels.conv import conv3x3_plain

CHANNELS = 64


def conv2_chain_plain(x, wa, ba, wb, bb, *, relu: bool = True, out_dtype=None):
    """Plain PyTorch version: conv2a (ReLU) in x's dtype, then conv2b and
    the pool (TF32 off on a card, as ``conv3x3_plain``)."""
    mid = conv3x3_plain(x, wa, ba)
    return conv3x3_plain(mid, wb, bb, True, relu=relu, out_dtype=out_dtype)


def conv2_chain(x: torch.Tensor, wa: torch.Tensor, ba: torch.Tensor, wb: torch.Tensor,
                bb: torch.Tensor, *, relu: bool = True, out_dtype=None) -> torch.Tensor:
    """conv2a (ReLU) -> conv2b [ReLU] -> 2x2 max-pool, NHWC, one launch.

    Args:
      x: (B, H, W, 64) fp32 or bf16, contiguous; H and W even.
      wa/wb: (3, 3, 64, 64) HWIO in x's dtype; ba/bb: (64,), applied in fp32.
      out_dtype: fp32 or bf16 (default x's dtype).
    Returns (B, H/2, W/2, 64).
    """
    if x.device.type == "cpu":
        return conv2_chain_plain(x, wa, ba, wb, bb, relu=relu, out_dtype=out_dtype)
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


conv2_chain.launches = 0
