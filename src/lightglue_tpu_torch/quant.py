"""Int8 weight-only quantization of the LightGlue linears: counterpart of
``lightglue_tpu/quant.py`` (the INT8 rung, the analog of the reference's
TensorRT "best" engine).

Every LightGlue linear gets per-output-channel symmetric int8 weights
``w_q`` with an fp32 ``scale``; biases, LayerNorm, the positional encoding
and the matchability and token-confidence heads stay float. The numpy side
(``quantize_weight``, ``quantize_lightglue``) is the JAX module's, bit for
bit, so one float tree gives equal int8 trees in both packages.
``runtime/weights.py:params_from_numpy`` lays the int8 tree out for the
port; the layer stack's kernels dequantize while they stage the weights
(``kernels/layer_stack.py:linear``), the per-block route and the heads
through ``models/lightglue.py:_weight``.
"""

from __future__ import annotations

import numpy as np
import torch


def quantize_weight(w: np.ndarray):
    """Symmetric per-output-channel int8 quantization.

    Args:
      w: float weight (..., in, out). Only the in-features axis (-2) is
        reduced, so stacked-layer and component leading axes keep their own
        scales.

    Returns:
      dict with 'w_q' int8 and 'scale' fp32 broadcastable to w (the in axis
      kept with size 1).
    """
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=-2, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    w_q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return {"w_q": w_q, "scale": scale}


def dequantize(p, dtype=torch.bfloat16) -> torch.Tensor:
    """(w_q * scale) rounded to ``dtype``: the fp32 product of the int8
    value and its channel's scale, then one cast. ``p`` holds numpy arrays
    or tensors, with the scale broadcastable to ``w_q``."""
    w_q, scale = torch.as_tensor(p["w_q"]), torch.as_tensor(p["scale"])
    return (w_q.float() * scale.to(w_q.device).float()).to(dtype)


_QUANT_KEYS = ("qkv", "out", "ffn1", "ffn2", "qk", "v", "proj")


def quantize_lightglue(params):
    """Quantize every LightGlue linear weight to int8 (biases, LayerNorm,
    positional encoding, matchability and token-confidence heads stay float:
    they are tiny and accuracy-critical). Numpy tree in, numpy tree out."""

    def walk(tree):
        out = {}
        for key, val in tree.items():
            if key in _QUANT_KEYS and isinstance(val, dict) and "w" in val:
                q = quantize_weight(np.asarray(val["w"]))
                out[key] = {**q, "b": np.asarray(val["b"])}
            elif isinstance(val, dict):
                out[key] = walk(val)
            else:
                out[key] = val
        return out

    return walk(params)


def is_quantized(p) -> bool:
    return isinstance(p, dict) and "w_q" in p
