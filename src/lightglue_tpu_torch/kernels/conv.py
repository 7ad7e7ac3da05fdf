"""Fused SAME 3x3 conv (64 -> 64) + bias + ReLU [+ 2x2 max-pool], NHWC.

Counterpart of ``lightglue_tpu/kernels/conv.py:conv3x3_paired`` (wrapper
:356, pallas_call :458), which runs SuperPoint's conv1b (+pool), conv2a and
conv2b (+pool). The TPU kernel's paired/offset column layouts exist only to
fill the MXU; the contract kept is the output of
``lightglue_tpu/models/superpoint.py:_relu_conv``: fp32 accumulation, fp32
bias, ReLU, the optional pool, then the cast to the activation dtype.

On a CUDA tensor ``conv3x3`` launches ``csrc/conv3x3.cu`` (see its header for
the design and what bounds it); on a CPU tensor it runs ``conv3x3_plain``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lightglue_tpu_torch.kernels import _build

CHANNELS = 64


def conv3x3_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, pool: bool
) -> torch.Tensor:
    """Plain PyTorch version: (B, H, W, 64) x HWIO (3, 3, 64, 64) + fp32 bias.

    The product runs on fp32 copies of the operands, so on a card it needs
    TF32 off to be exact (``precision.precision_scope`` does that)."""
    xf = x.float().permute(0, 3, 1, 2)
    wf = w.float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    out = F.relu(F.conv2d(xf, wf, padding=1) + b.float()[None, :, None, None])
    if pool:
        out = F.max_pool2d(out, 2)
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv3x3(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, pool: bool = False
) -> torch.Tensor:
    """SAME 3x3 conv + bias + ReLU [+ 2x2 max-pool] on NHWC activations.

    Args:
      x: (B, H, W, 64) fp32 or bf16, contiguous; H and W even when ``pool``.
      w: (3, 3, 64, 64) HWIO in x's dtype.
      b: (64,) fp32.
    Returns (B, H, W, 64), or (B, H/2, W/2, 64) with ``pool``, in x's dtype.
    """
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, pool)
    bsz, h, wd, c = x.shape
    if c != CHANNELS or tuple(w.shape) != (3, 3, CHANNELS, CHANNELS):
        raise ValueError(f"conv3x3 takes 64 -> 64 channels, got {x.shape} {w.shape}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise ValueError(f"conv3x3 dtypes: x {x.dtype}, w {w.dtype}")
    if b.dtype != torch.float32 or b.shape != (CHANNELS,):
        raise ValueError("conv3x3 bias must be (64,) fp32")
    if pool and (h % 2 or wd % 2):
        raise ValueError(f"pooled conv3x3 needs even H and W, got {h}x{wd}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv3x3 operands must be contiguous")
    if not (x.device == w.device == b.device):
        raise ValueError("conv3x3 operands must share a device")
    oh, ow = (h // 2, wd // 2) if pool else (h, wd)
    y = torch.empty((bsz, oh, ow, CHANNELS), dtype=x.dtype, device=x.device)
    err = _build.lib().lg_conv3x3(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        bsz, h, wd, int(pool), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "conv3x3")
    conv3x3.launches += 1
    return y


conv3x3.launches = 0
