from lightglue_tpu_torch.parallel.ring import AXIS_SEQ, ring_attention, ring_attention_local

__all__ = ["AXIS_SEQ", "ring_attention", "ring_attention_local"]
