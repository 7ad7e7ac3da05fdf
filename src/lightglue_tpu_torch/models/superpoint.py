"""SuperPoint detector/descriptor CNN in PyTorch, NHWC at the interface.

Counterpart of ``lightglue_tpu/models/superpoint.py``: VGG-style encoder
(channels 64, 64, 128, 128, 256; three 2x2 max-pools -> stride 8), detector
head (65-channel softmax, dustbin dropped, 8x8 pixel shuffle to a
full-resolution score map, optional NMS) and descriptor head (256-d,
L2-normalised dense map).

conv1a, the reference's fp32 9-tap shift stem, runs on the hand-written
``kernels.stem.relu_conv1a_shift``; the three 64-channel convs conv1b
(+pool), conv2a and conv2b (+pool) on ``kernels.conv.conv3x3``; the
remaining convs and the heads are plain ``F.conv2d`` on channels-last
views, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from lightglue_tpu_torch.config import SuperPointConfig
from lightglue_tpu_torch.kernels import conv as conv_kernel
from lightglue_tpu_torch.kernels import stem
from lightglue_tpu_torch.kernels.nms import simple_nms
from lightglue_tpu_torch.precision import DTypePolicy, precision_scope


def _conv(p, x: torch.Tensor) -> torch.Tensor:
    """SAME conv (OIHW weights) + fp32 bias on NHWC x, result in x's dtype.

    Weights round to x's dtype as in the reference; the product runs on fp32
    copies so it accumulates in fp32 and rounds once, after the bias. A
    bf16 value is exact in TF32, so the BF16 rung loses nothing to cuDNN's
    TF32 default; the FP32 rung runs with TF32 off (precision_scope).

    Each image is convolved alone, so its result does not depend on the
    batch it came in: cuDNN picks its algorithm by the whole shape, and at
    batch 2 it picks one that sums in another order (one bf16 ulp apart in
    13 of convDa's 1.2M outputs at 480x640 on an H100), which moved the
    keypoints and matches of an image between ``extract`` of it alone and
    ``match_pair``."""
    w = p["w"].to(x.dtype).float()
    outs = [F.conv2d(xi.permute(0, 3, 1, 2).float(), w, padding=w.shape[-1] // 2)
            for xi in x.split(1)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return (out.permute(0, 2, 3, 1) + p["b"]).to(x.dtype)


def _relu_conv(p, x: torch.Tensor) -> torch.Tensor:
    return F.relu(_conv(p, x))


def _max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _kernel_conv(p, x: torch.Tensor, pool: bool) -> torch.Tensor:
    return conv_kernel.conv3x3(x.contiguous(), p["w"].to(x.dtype).contiguous(),
                               p["b"].float(), pool=pool)


def _encoder(params, x: torch.Tensor) -> torch.Tensor:
    """The shared VGG encoder, stride 8, in x's dtype."""
    x = stem.relu_conv1a_shift(x, params["conv1a"]["w"], params["conv1a"]["b"])
    x = _kernel_conv(params["conv1b"], x, pool=True)
    x = _kernel_conv(params["conv2a"], x, pool=False)
    x = _kernel_conv(params["conv2b"], x, pool=True)
    x = _relu_conv(params["conv3a"], x)
    x = _max_pool_2x2(_relu_conv(params["conv3b"], x))
    x = _relu_conv(params["conv4a"], x)
    return _relu_conv(params["conv4b"], x)


def forward(
    params,
    image: torch.Tensor,
    *,
    config: SuperPointConfig = SuperPointConfig(),
    policy: DTypePolicy,
    nms: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense forward pass.

    Args:
      params: the port's SuperPoint tree (runtime/weights.py:params_from_numpy).
      image: (B, H, W, 1) grayscale in [0, 1]; H, W multiples of 8.
      nms: apply iterative NMS to the score map. The extraction hot path
        passes False and runs NMS inside ``kernels.nms.nms_candidates``.

    Returns:
      scores: (B, H, W) fp32 detection score map, NMS'd when ``nms``.
      descriptors: (B, H/8, W/8, 256) fp32 L2-normalised dense descriptors.
    """
    with precision_scope(policy):
        x = _encoder(params, image.to(policy.act_dtype))

        # detector head: 65-ch softmax, drop the dustbin, 8x8 pixel shuffle
        cpa = _relu_conv(params["convPa"], x)
        logits = _conv(params["convPb"], cpa).float()  # (B, h, w, 65)
        probs = torch.softmax(logits, dim=-1)[..., :-1]
        b, h, w, _ = probs.shape
        scores = probs.reshape(b, h, w, 8, 8).permute(0, 1, 3, 2, 4).reshape(b, h * 8, w * 8)
        if nms:
            scores = simple_nms(scores, config.nms_radius)

        # descriptor head
        cda = _relu_conv(params["convDa"], x)
        desc = _conv(params["convDb"], cda).float()  # (B, h, w, 256)
        desc = desc * torch.rsqrt((desc * desc).sum(dim=-1, keepdim=True) + 1e-12)
    return scores, desc


def forward_raw_descriptors(
    params,
    image: torch.Tensor,
    *,
    config: SuperPointConfig = SuperPointConfig(),
    policy: DTypePolicy,
) -> torch.Tensor:
    """Dense descriptor map BEFORE L2 normalisation, (B, H/8, W/8, 256) fp32
    (JAX ``superpoint.py:118-149``): ``forward``'s encoder and convDa/convDb
    on the same kernels. ``runtime.weights.whiten_superpoint_descriptors``
    calibrates a ZCA whitening of the descriptor head on it for random-init
    (proxy) weights."""
    with precision_scope(policy):
        x = _encoder(params, image.to(policy.act_dtype))
        return _conv(params["convDb"], _relu_conv(params["convDa"], x)).float()
