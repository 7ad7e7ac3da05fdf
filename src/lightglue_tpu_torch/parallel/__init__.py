from lightglue_tpu_torch.parallel.ring import AXIS_SEQ, ring_attention, ring_attention_local
from lightglue_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_MODEL,
    lightglue_param_specs,
    make_mesh,
    make_parallel_adaptive_fn,
    make_parallel_extract_fn,
    make_parallel_match_fn,
    shard_lightglue_params,
)

__all__ = [
    "AXIS_DATA",
    "AXIS_MODEL",
    "AXIS_SEQ",
    "make_mesh",
    "lightglue_param_specs",
    "shard_lightglue_params",
    "make_parallel_adaptive_fn",
    "make_parallel_match_fn",
    "make_parallel_extract_fn",
    "ring_attention",
    "ring_attention_local",
]
