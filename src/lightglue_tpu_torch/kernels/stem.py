"""SuperPoint's conv1a: the fp32 tap stem (SAME 3x3, 1 -> 64 channels, +
bias, ReLU), NHWC.

Counterpart of ``lightglue_tpu/models/superpoint.py:_relu_conv1a_shift``
(:56). That is not a Pallas function: the JAX package leaves it to XLA,
which fuses its nine shifted broadcast products into one loop. On a CUDA
tensor ``relu_conv1a_shift`` launches ``csrc/stem.cu``, that one loop (see
its header for the design and what bounds it); on a CPU tensor it runs
``relu_conv1a_shift_plain``, with which the kernel agrees bit for bit. Both
are the implementations of the operator
``lightglue_tpu_torch::relu_conv1a_shift`` (``_build.define_op``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lightglue_tpu_torch.kernels import _build

C_OUT = 64  # conv1a's output channels, the kernel's fixed width


def relu_conv1a_shift_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: 9 shifted broadcast products summed in fp32,
    each product and each add rounded, in tap order; + bias, ReLU, one cast
    to x's dtype."""
    bsz, h, wd, _ = x.shape
    xp = F.pad(x[..., 0].float(), (1, 1, 1, 1))
    wf = w.float()  # (3, 3, 1, C)
    acc = torch.zeros((bsz, h, wd, wf.shape[-1]), dtype=torch.float32, device=x.device)
    for di in range(3):
        for dj in range(3):
            acc += xp[:, di:di + h, dj:dj + wd, None] * wf[di, dj, 0]
    return F.relu(acc + b).to(x.dtype)


def _relu_conv1a_shift_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The operator's CUDA implementation: checks, then one launch."""
    if x.dim() != 4 or x.shape[-1] != 1:
        raise ValueError(f"relu_conv1a_shift takes a (B, H, W, 1) image, got {tuple(x.shape)}")
    bsz, h, wd, _ = x.shape
    if h % 8 or wd % 8:
        raise ValueError(f"relu_conv1a_shift needs H, W multiples of 8, got {h}x{wd}")
    if tuple(w.shape) != (3, 3, 1, C_OUT) or tuple(b.shape) != (C_OUT,):
        raise ValueError(f"relu_conv1a_shift weights: w {tuple(w.shape)}, b {tuple(b.shape)}; "
                         f"want (3, 3, 1, {C_OUT}) and ({C_OUT},)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"relu_conv1a_shift takes a bf16 or fp32 image, got {x.dtype}")
    if not (x.device == w.device == b.device):
        raise ValueError("relu_conv1a_shift operands must share a device")
    x = x.contiguous()
    wf, bf = w.float().contiguous(), b.float().contiguous()
    y = torch.empty((bsz, h, wd, C_OUT), dtype=x.dtype, device=x.device)
    err = _build.lib().lg_relu_conv1a_shift(
        x.data_ptr(), wf.data_ptr(), bf.data_ptr(), y.data_ptr(), bsz, h, wd,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "relu_conv1a_shift")
    relu_conv1a_shift.launches += 1
    return y


def _relu_conv1a_shift_fake(x, w, b):
    return x.new_empty((*x.shape[:3], C_OUT))


_OP = _build.define_op("relu_conv1a_shift(Tensor x, Tensor w, Tensor b) -> Tensor",
                       cpu=relu_conv1a_shift_plain, cuda=_relu_conv1a_shift_cuda,
                       fake=_relu_conv1a_shift_fake)


def relu_conv1a_shift(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """conv1a + ReLU on a grayscale image.

    Args:
      x: (B, H, W, 1) bf16 or fp32; H, W multiples of 8.
      w: (3, 3, 1, 64) HWIO, any float dtype (widened to fp32).
      b: (64,), applied in fp32.
    Returns (B, H, W, 64) in x's dtype.
    """
    return _build.run(_OP, relu_conv1a_shift_plain, _relu_conv1a_shift_cuda, x, w, b)


relu_conv1a_shift.launches = 0
