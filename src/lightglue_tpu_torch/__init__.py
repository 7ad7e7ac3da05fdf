"""PyTorch + CUDA port of lightglue_tpu for one NVIDIA H100.

Module paths and public names mirror ``lightglue_tpu``; the three Pallas
kernels on the main path (conv3x3_paired, nms_candidates, transformer_stack)
are hand-written CUDA kernels under ``csrc/``, built at first use by
``kernels/_build.py``. The package imports torch and numpy, never JAX.
"""
