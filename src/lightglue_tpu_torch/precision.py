"""Precision ladder as torch dtypes (counterpart of lightglue_tpu/precision.py).

===========  =============================================  ===================
rung         dtypes                                         on the card
===========  =============================================  ===================
FP32         fp32 everywhere, true fp32 products            kernels in fp32
MIXED        bf16 matmul operands, fp32 stats/activations   bf16-in, fp32-out
                                                            kernels
BF16         bf16 activations and attention statistics      kernels in bf16
INT8         bf16 activations + int8 weight-only linears    int8 weights staged
             (fp32 scales, biases, LayerNorm); W8A8 with    as bf16; W8A8: s8
             ``LGTPU_W8A8=1`` (the layer stack only)        mma on row-quantized
                                                            activations
===========  =============================================  ===================

FP32 means true fp32: PyTorch runs fp32 convolutions through TF32 by default
(``torch.backends.cudnn.allow_tf32``), which keeps ~3 decimal digits, so the
FP32 rung switches TF32 off for matmuls and convolutions inside
``precision_scope`` — the analog of the JAX rung's
``matmul_precision="highest"``.
"""

from __future__ import annotations

import contextlib
import enum
from dataclasses import dataclass

import torch


class Precision(str, enum.Enum):
    """Precision rung. String-valued so configs serialize naturally."""

    FP32 = "fp32"
    MIXED = "mixed"
    BF16 = "bf16"
    INT8 = "int8"


@dataclass(frozen=True)
class DTypePolicy:
    """Resolved dtypes for one forward pass."""

    param_dtype: torch.dtype      # storage dtype of weights fed to matmuls
    act_dtype: torch.dtype        # activation dtype between layers
    attn_in_dtype: torch.dtype    # Q/K/V and projection operand dtype
    attn_stat_dtype: torch.dtype  # softmax statistics dtype
    attn_out_dtype: torch.dtype   # attention output dtype
    acc_dtype: torch.dtype        # matmul accumulation
    int8_weights: bool            # quantize linear weights to int8 + scales
    true_fp32: bool = False       # fp32 products without TF32


_POLICIES = {
    Precision.FP32: DTypePolicy(
        param_dtype=torch.float32,
        act_dtype=torch.float32,
        attn_in_dtype=torch.float32,
        attn_stat_dtype=torch.float32,
        attn_out_dtype=torch.float32,
        acc_dtype=torch.float32,
        int8_weights=False,
        true_fp32=True,
    ),
    Precision.MIXED: DTypePolicy(
        param_dtype=torch.float32,
        act_dtype=torch.float32,
        attn_in_dtype=torch.bfloat16,
        attn_stat_dtype=torch.float32,
        attn_out_dtype=torch.float32,
        acc_dtype=torch.float32,
        int8_weights=False,
    ),
    Precision.BF16: DTypePolicy(
        param_dtype=torch.bfloat16,
        act_dtype=torch.bfloat16,
        attn_in_dtype=torch.bfloat16,
        attn_stat_dtype=torch.bfloat16,
        attn_out_dtype=torch.bfloat16,
        acc_dtype=torch.float32,
        int8_weights=False,
    ),
    Precision.INT8: DTypePolicy(
        param_dtype=torch.bfloat16,
        act_dtype=torch.bfloat16,
        attn_in_dtype=torch.bfloat16,
        attn_stat_dtype=torch.bfloat16,
        attn_out_dtype=torch.bfloat16,
        acc_dtype=torch.float32,
        int8_weights=True,
    ),
}


def policy_for(precision: Precision | str) -> DTypePolicy:
    return _POLICIES[Precision(precision)]


@contextlib.contextmanager
def precision_scope(policy: DTypePolicy):
    """Switch TF32 off for matmuls and convolutions while the FP32 rung runs;
    the other rungs keep PyTorch's defaults. Restores the flags on exit."""
    if not policy.true_fp32:
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
