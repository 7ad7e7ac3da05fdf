"""Single-source configuration for the pipeline (copy of lightglue_tpu/config.py).

The reference scatters configuration across compile-time constants
(lightglue_attention_plugin.h:19-22), dict-based model configs
(lightglue.py:293-303, superpoint.py:99-105), trtexec CLI flags (steps.txt)
and hardcoded thresholds at call sites (demo/demo_mono.cpp:175,296). Here it
is one set of frozen dataclasses resolved at jit time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

from lightglue_tpu_torch.precision import Precision


@dataclass(frozen=True)
class SuperPointConfig:
    """SuperPoint detector/descriptor (reference superpoint.py:99-105)."""

    descriptor_dim: int = 256
    nms_radius: int = 4
    detection_threshold: float = 0.0005
    remove_borders: int = 4
    max_num_keypoints: int = 1024
    channels: Tuple[int, ...] = (64, 64, 128, 128, 256)
    stride: int = 8  # total encoder downsampling (3 maxpools)


@dataclass(frozen=True)
class LightGlueConfig:
    """LightGlue matcher (reference lightglue.py:293-303)."""

    input_dim: int = 256
    descriptor_dim: int = 256
    n_layers: int = 9
    num_heads: int = 4
    filter_threshold: float = 0.1
    # -1 disables; the reference compiles these out of the exported graph but
    # upstream LightGlue enables them (depth 0.95 / width 0.99). Here they run
    # device-side under lax control flow.
    depth_confidence: float = -1.0
    width_confidence: float = -1.0
    # Bucket-ladder downshift for width pruning (-1 disables): after this
    # many layers, pairs whose surviving keypoint count fits the half-size
    # bucket are compacted and the REMAINING layers run on N/2-wide
    # executables — a lax.cond between two static shapes inside one
    # dispatch, so pruning buys real wall-clock (attention is quadratic in
    # the bucket) without a host round trip. Exact: compaction reorders
    # memory, masked-in-place == compacted, and the depth/width decisions
    # use global layer indices in both phases.
    downshift_layer: int = -1

    @property
    def head_dim(self) -> int:
        return self.descriptor_dim // self.num_heads


@dataclass(frozen=True)
class PipelineConfig:
    """End-to-end extract+match pipeline."""

    superpoint: SuperPointConfig = field(default_factory=SuperPointConfig)
    lightglue: LightGlueConfig = field(default_factory=LightGlueConfig)
    precision: Precision = Precision.BF16
    # Keypoint-count buckets: each pair is padded up to the smallest bucket
    # holding its keypoint count, and one executable is AOT-compiled per
    # bucket — the XLA analog of the reference's CUDA graph recorded at the
    # 1024-kpt max shape (demo/demo_mono.cpp:105-140, SURVEY.md §3.1).
    # 128-step granularity (the megakernel's block quantum): a 700-keypoint
    # pair dispatches to the dense 768 executable — attention cost scales
    # quadratically with the bucket, so downshifting beats running masked in
    # the 1024 bucket (chip-measured; the in-kernel masked path only
    # where-masks, golden/chip_r03). More buckets = more one-time AOT
    # compiles (runtime/aot.py persistent cache), zero steady-state cost.
    buckets: Tuple[int, ...] = (256, 384, 512, 640, 768, 896, 1024)
    match_threshold: float = 0.1  # demo_mono.cpp:296 uses 0.5; python default 0.1
    max_matches: int = 1024

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]
