#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check its kernels.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

It prints the card's name and power limit, builds the CUDA kernels of
``src/lightglue_tpu_torch/csrc`` (one nvcc per source, sm_90a, in
parallel) and checks in their SASS that the bf16 kernels of
conv3x3.cu (the model conv and the generic one) and conv_chain.cu run on
the tensor cores, that attention.cu's, bidir_cross.cu's and
flash_attn.cu's bf16 kernels and linear.cu's bf16-product GEMM (BF16,
MIXED, INT8) run on Hopper's warpgroup MMA (HGMMA in every instantiation,
no HMMA, no local-memory load or store: ``WGMMA_KERNELS``), that the fp32
kernels of flash_attn.cu, linear.cu, attention.cu and bidir_cross.cu and
the fp32 model conv run in 3xTF32 on it (HGMMA with TF32 operands on every
HGMMA line, in every instantiation, no HMMA, no local-memory load or store:
``TF32_WGMMA_KERNELS``), that the generic fp32 conv and the fp32 chain run
in 3xTF32 on the tensor cores (TF32 HMMA only; their spills logged), that
no conv3x3.cu
or conv_chain.cu kernel is left off the tensor cores (HMMA or HGMMA), and that
stem.cu's kernel has no contracted multiply-add. Then, in
order; every kernel check is in bf16 and fp32 against
the kernel's plain PyTorch version at the shapes its path gives it, every
path is driven with the launch counts set to 0 just before it and read just
after, and every kernel the JSON line lists is timed beside its bound, its
plain version and, where one exists, a PyTorch call for the same function.
A session path is driven through its first call, which captures the
session's CUDA graphs: the wrappers count each launch there twice (the
eager warm-up and the capture; ``first_call``), and a later call replays
the graphs without them, so a replay's launches are counted from
profiler traces by kernel name (``trace_launches``; the most of ``TRACES``
traces or more, since a trace can drop a call's events) and held to the
wrappers' counts per call:

1. The main path (default config: BF16, 9 layers, seed-0 random weights,
   480x640 pair): ``conv3x3`` (its 64->64 calls, timed in bf16 and in fp32
   for the MIXED and FP32 rungs, and conv1b+pool and conv2a at 360x488 for
   the edge tiles; each bf16 case also against the rounding witness and two
   wrong designs, ``conv_wrong_designs``; each fp32 case, the 3xTF32
   kernel, also against a float64 conv beside the generic 3xTF32 conv's
   error and an emulated one-TF32 conv as its wrong design,
   ``tf32_witness``),
   ``nms_candidates`` (exact; also at 360x488 and 480x600, radius 2, caps
   1 and 8, below the border value, ties across band edges: ``nms_checks``),
   ``relu_conv1a_shift`` (conv1a's stem, bit for bit in bf16 and fp32, also
   at 360x488 and 480x600: ``stem_checks``), ``linear``, ``attention`` and
   ``ln_gelu`` (each timed in bf16 and, for the FP32 rung, in fp32; the
   fp32 ffn2 ``linear`` and the fp32 self-RoPE and cross ``attention``
   at 1024, 3xTF32, also against float64 beside an emulated one-TF32
   version, ``tf32_witness``; ``attention`` also at fp32 operands with
   bf16 stats; ``ln_gelu`` also in its three modes at ragged widths, with
   a retired pair's rows unwritten and on rows where E[x^2] - mean^2 and
   Welford differ, ``ln_gelu_checks``, and timed between ffn1 and ffn2,
   ``ffn_triple_ms``) against
   their plain versions (``linear_plan`` / ``attention_plan`` /
   ``bidir_plan`` / ``decide_plan`` against the card's launch rules; each bf16 ``attention``
   case also against the rounding witness and its two wrong designs,
   ``stack_wrong_designs``); the layer stack at 9 layers;
   ``MatcherSession(device="cuda").match_pair`` with its launch counts
   (144 / 36 / 36 for linear / attention / ln_gelu; one stem, three convs,
   one NMS per SuperPoint forward on every route and rung below,
   ``SP_LAUNCHES``) and a profile that also names the ops behind the device
   time, with their shapes and callers, then the same for one extraction of
   the pair (also at MIXED in phase 6); a small FP32 pair against the port
   on the CPU.
2. The adaptive path (``depth_confidence=0.95, width_confidence=0.99``):
   ``adaptive_decide`` (masked, unmasked, width with a partly retired keep
   state, pinned and random heads; then ``decide_batch_checks``: B = 1, 2
   and 4 with live and dead pairs, N0 != N1, width-only and the last layer
   in all three operand modes, each case also replayed twice from one CUDA
   graph, which shows the kernel leaves its scratch zeroed), the
   keep-masked and liveness operands,
   ``transformer_stack_adaptive`` at 9 layers (random weights, the exit-3
   weights, the pruning weights through the downshift at layer 4), and
   ``match_pair`` in those three weight setups.
3. The per-block path: ``fused_mha``, ``bidirectional_cross_attention`` and
   ``flash_attention`` (masked, ragged, zero lengths, several KV tiles,
   block_k 1000; each bf16-operand flash case also against the rounding
   witness, ``rounding_witness``, and the timed fp32 ``flash_attention``
   and unmasked 960x960 fp32 ``bidirectional_cross_attention`` cases,
   3xTF32, against float64 (``tf32_witness``); each bf16
   bidirectional case with both
   sides non-empty per direction against ``stack_wrong_designs``; the
   bidirectional kernel (``BIDIR_CASES``, also at 80 keys, pad keys past
   Nk, and at 1280x1088, s recomputed at bf16 stats) also at fp32 operands
   with bf16 stats, and timed beside two SDPA calls, ``two_sdpa_ms``, and
   two launches of the stack attention, ``two_attention_ms``), the
   per-block ``transformer_layers`` at 9 layers, and ``match_pair`` in the
   2048-keypoint config (``SuperPointConfig(max_num_keypoints=2048)``, a
   2048 bucket) and the pad-to-64 config (``buckets=range(64, 1025, 64)``,
   960 cap), mixed buckets (2048x1024, 960x64) and a two-pair
   ``match_batch``.
4. The sequence split: ``flash_attention_step`` (kv boundary inside the
   block, a block past kv_len and a stripe past q_len passing through
   exactly, 128-row and 120-row stripes, kv_len 0, blocks fitted to
   384-row stripes, unmasked; fp32 and bf16 stats, each case at three
   seeds of the phase's own generator, bf16-stats carries held per element
   to the ulps of the plain step's rounded intermediates,
   ``step_ulp_units``; the witness on the finalised rows; the bf16 and fp32
   steps timed), ``ring_attention`` on ``[cuda:0] * P``
   for P = 2, 4, 8 against ``reference_attention`` and the plain step, and
   ``forward_ring`` on ``[cuda:0] * 4`` at full width (9 layers, E=256,
   H=4, stripes of 512) on the 2048-keypoint extractions of the pair, then
   ``filter_matches``: BF16 against the same loop on the plain step, with
   its launch counts, graph and eager times and a profile; FP32 against
   ``forward`` and its match set.
5. The conv variants that no path runs: the generic ``conv3x3`` at
   SuperPoint's C >= 128 layer shapes and at edge shapes (C_in 24 ->
   C_out 40 without ReLU, a 488-wide map with the pool), each also into
   the other output dtype, and ``conv2_chain`` at the conv2 shape and the
   360x488 edge's, ReLU on and off, into either output dtype, against its
   plain version and the two-launch ``conv3x3`` chain; every bf16-operand
   case against the rounding witness (by magnitude where the output is
   fp32) and its two wrong designs (``conv_wrong_designs``,
   ``chain_wrong_designs``); every fp32 -> fp32 generic conv and chain
   case (3xTF32) against float64 beside an emulated one-TF32 conv or
   chain; both timed in bf16 and fp32 (cuDNN with TF32 off), the chain
   beside the two-launch chain. ``conv_plan`` and ``chain_plan`` (both
   operand dtypes) are held to the card's ``lg_conv_tile`` and
   ``lg_chain_plan`` in phase 1.
6. The MIXED and INT8 rungs (INT8's W8A8 mode with ``LGTPU_W8A8=1``):
   ``linear`` at MIXED (fp32 activations, bf16 products; 1e-4), INT8
   weight-only (bit for bit against ``linear`` on the dequantized weight)
   and W8A8 with ``row_quant`` (q, sa and y exact; also at 999 rows with
   crafted rows: .5 ties, all-zero, one-hot, ffn1's amax in either operand;
   and with a retired pair, with and without a residual: ``w8a8_edge_checks``;
   the s8 GEMM on the K-major ``w_t``); ``attention`` at MIXED in both
   cross directions, masked, keep-masked and under liveness, with the
   magnitude witness (``magnitude_witness``, ``mixed_wrong_designs``);
   ``ln_gelu`` with fp32 gamma/beta; ``adaptive_decide`` with fp32 x and
   bf16 heads (in phase 2); ``fused_mha``, ``flash_attention`` and
   ``bidirectional_cross_attention`` at MIXED; the stacks at 9 layers per
   rung and the adaptive stack at MIXED and INT8; ``match_pair`` (and a
   two-pair ``match_batch``) at MIXED and INT8 on every route (W8A8 at
   fixed depth) against the same session on the plain versions
   (``plain_lightglue``); ``forward_ring`` at INT8. The FP32 rung's
   ``match_pair`` on every route, against the same session on the plain
   versions, gives the launch counts of its rows.
   The SASS check above also requires IMMA in every W8A8 GEMM, and no
   local-memory load or store in it (no spill).
7. The session's per-bucket CUDA graphs (``session_graph_checks``): on
   every configuration of PERF.md's table (each route and rung above but
   the ring), ``match_pair`` and a two-pair ``match_batch`` replayed from
   the session's graphs against the same session's eager bodies
   (``eager_session``): every returned array equal bit for bit, the traced
   replay's launches per wrapper equal to the eager call's counts, a later
   call leaving the first call's arrays as they were; ms per pair as graphs
   and eager and the graph call's device busy share; ``warmup``'s keys on
   the default config; the device memory a session holds after
   ``warmup(pairs="all")`` at the default and 2048-keypoint buckets. Then,
   on each of those sessions (``batch_invariance``), four distinct pairs at
   one (bucket0, bucket1, full), from the graphs and from the eager bodies:
   each ``match_pair`` against its row of one ``match_batch``, and each
   pair's LightGlue output and matches alone against its row of the
   four's, every field bit for bit (a pair's result is its own, whatever
   its batch), the mutual-NN IoU and largest log-assignment difference
   printed, and at BF16 two cases the contract leaves out reported (a
   filled pair batched beside a partial one, a pair batched at a larger
   bucket than its own); a {"batch_invariance": ...} line with the phase's
   seconds. Every earlier
   phase's ``match_pair`` replays graphs too; where it swaps the kernels
   for their plain versions or spies on a call, it runs the eager bodies.
8. The entry points a user runs (``entry_point_checks``): the native host
   library built with g++ and ``preprocess_image`` against its plain
   version; the demo's per-pair function (``cli.demo_mono.match_frames``)
   at BF16, 480x640, 1024 keypoints, 9 layers on six frames under
   ``--proxy_whiten`` weights, each pair's matches against ``match_pair``
   of the same session on the same images; the bench CLI (``--all`` at
   1x1024 and at ``--batch 8``) in subprocesses; ``ContinuousBatcher`` on
   24 pairs across the ladder at batch 4, each result against the pair's
   own ``match_from_extractions``, bit for bit where the batch ran at the
   pair's own (bucket0, bucket1, full). Frame files and a render only where cv2
   or PIL imports (a line says which).
9. The parallel path (``parallel_checks``, mirroring
   ``__graft_entry__.py:dryrun_multichip`` on ``[cuda:0] * 4`` at 1024
   keypoints and 480x640): ``fused_mha`` and
   ``bidirectional_cross_attention`` at the tensor-parallel shards' local
   heads (H = 2 and 1) in bf16, MIXED and fp32 against their plain versions,
   timed beside SDPA; ``make_parallel_extract_fn`` over 2 x 2 against one
   unsharded extraction, bit for bit (proxy-whitened SuperPoint, four
   images); ``make_parallel_match_fn`` over 2 x 2, 4 x 1 and 1 x 4 at BF16,
   FP32 and INT8 on image1 = image0 against the single-device ``forward``
   (scores under 0.51 / 1e-3 / 0.51, mutual-NN sets equal with near-ties of
   the reference left out), launches per wrapper (the TP route's also from
   traces), the DP rows of the 4 x 1 mesh bit for bit the single device's
   (reported for the TP meshes), ms per
   pair of each eager step; ``make_parallel_adaptive_fn`` over 2 x 2 (exit 3
   with depth and width, depth-only ``full``, both downshift arms): equal to
   each data row's pairs alone on one device and to the batch of four, bit
   for bit (no keep flip, ``adaptive_flips``); two ranks spawned on the
   card in a gloo group (barrier, the match step at 2 x 1 and across the
   processes at 1 x 2, a sharded ``ContinuousBatcher`` in lockstep against
   a single-device one); NCCL at world size 1. It prints a
   {"parallel": ...} line before the kernels line.
10. Exported programs (``aot_checks``, ``runtime/aot.py``): on ``cuda:0``
   the extraction at 480x640 and the match step at the 1024 diagonal (BF16,
   W8A8, FP32, adaptive exit 3, the pruning downshift as its split
   directory) and at the 2048 bucket are exported with ``torch.export`` (no
   wrapper count moves); a fresh process with an empty kernel cache loads
   the BF16 program and calls it once (cold start: one build), and another
   on this process's kernel directory (no build) loads every program and
   runs it on the inputs saved here (``chip_smoke.py --aot-load``,
   ``aot_worker``: it imports nothing of the package but ``runtime.aot``):
   every output bit for bit the session's eager body on the same inputs,
   the launches per wrapper, by the wrappers' counts and from profiler
   traces by kernel name, equal to the eager call's. It prints an
   {"aot": ...} line (export s, cold and warm start, the loaded BF16 match
   step's ms a pair beside the session's graph and eager) before the
   kernels line.

It ends with a ``{"kernels": [...]}`` line (all ten Pallas functions, a
row per FP32 / MIXED / INT8 / W8A8 instantiation (the fp32 step's launches
from the FP32 ``forward_ring``) and per fp32-operand conv, and
conv1a's stem in bf16 and fp32; the chain's rows also carry the two-launch
chain's ``two_launch_ms``, the bidirectional rows the two SDPA calls'
``two_sdpa_ms`` and two stack-attention launches' ``two_attention_ms``; ``launches``, the wrappers' counts over the driven call,
which for a session path is its first call: twice the launches of each
later call) and the ``{"ok": true, ...}`` line; before them a ``{"sessions": [...]}`` line (phase 7's ms per pair
graph and eager, kernel ms, busy share) and an ``{"entry_points": ...}``
line (phase 8's readings). Any failure raises and exits non-zero; so does
a missing card or a directory without the package.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_MS = 3.35e9      # 3.35 TB/s
BF16_FLOP_PER_MS = 989e9       # dense bf16 tensor-core peak
FP32_OP_PER_MS = 67e9          # fp32 outside the tensor cores
# fp32-accurate products on the tensor cores: three TF32 products each
# (495 TFLOP/s dense); the fp32 convs' bound takes the faster of the two
TF32X3_OP_PER_MS = 495e9 / 3
N_LAYERS = 9
BUCKET = 1024
# launches of one SuperPoint forward and its extraction, on every route and rung
SP_LAUNCHES = dict(relu_conv1a_shift=1, conv3x3=3, nms_candidates=1)
# the port's kernels by the wrapper that launches them, as a profiler trace
# names them: a traced call's kernel events counted per wrapper
# (``trace_launches``). rope_kernel is left out: attention and fused_mha
# launch it before their products in some modes. A flash kernel's first
# template argument is STEP: true in flash_attention_step; false in
# fused_mha and flash_attention, which no session call launches (the
# wrappers' own counts over a session's first call show it)
KERNEL_WRAPPERS = {
    "stem_kernel": "relu_conv1a_shift",
    "conv3x3_mma_kernel": "conv3x3", "conv3x3_tf32_wgmma_kernel": "conv3x3",
    "conv3x3_igemm_kernel": "conv3x3", "conv3x3_tf32x3_generic_kernel": "conv3x3",
    "chain_mma_kernel": "conv2_chain", "chain_tf32x3_kernel": "conv2_chain",
    "nms_candidates_kernel": "nms_candidates",
    "linear_wgmma_kernel": "linear", "linear_tf32_wgmma_kernel": "linear",
    "linear_s8_kernel": "linear", "row_quant_kernel": "row_quant",
    "attention_wgmma_kernel": "attention", "attention_tf32_wgmma_kernel": "attention",
    "ln_gelu_kernel": "ln_gelu", "adaptive_decide_kernel": "adaptive_decide",
    "flash_wgmma_kernel": "fused_mha", "flash_tf32_wgmma_kernel": "fused_mha",
    "bidir_wgmma_kernel": "bidirectional_cross_attention",
    "bidir_tf32_wgmma_kernel": "bidirectional_cross_attention",
}

# stated tolerances, |kernel - plain| <= atol + rtol * |plain|
TOL = {
    # fp32: the two differ only in the order of fp32 sums
    "fp32": dict(atol=1e-4, rtol=1e-4),
    # bf16: the same rounding points, so a difference is a rounding flip
    # caused by a different fp32 sum order: one or two bf16 ulps (2^-8..2^-7)
    "bf16": dict(atol=2e-2, rtol=2e-2),
}
# whole stack, 9 layers: fp32 order effects compound a little per layer; in
# bf16 the bound is twice the per-layer envelope measured between two
# summation orders of the JAX bf16 stack at 9 layers
# (golden/bf16_layer_err_r05.txt: 0.2501 -> 0.5), plus one bf16 ulp
STACK_TOL = {"fp32": dict(atol=1e-3, rtol=1e-3), "bf16": dict(atol=0.5, rtol=2 ** -7)}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=10, inner=10):
    """Median device time of one fn() call: ``inner`` calls are captured in
    a CUDA graph, and each of ``reps`` replays is timed with CUDA events.
    Replaying a graph keeps Python's launch overhead out of the number, so
    a short kernel is timed, not the host enqueueing it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    ms = statistics.median(s.elapsed_time(e) for s, e in events) / inner
    del graph
    return ms


def host_ms(fn, reps=10):
    """Median host-clock ms of ``fn()`` ending in a synchronise, after one
    warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def eager_ms(fn, reps=10):
    """Median time of one eager fn() call between CUDA events, host launch
    overhead included (what the Python layer loop costs as it runs)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def compare(label, got, want, atol, rtol, exact=False):
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if exact:
        if not torch.equal(got, want):
            n = int((got != want).sum())
            raise AssertionError(f"{label}: {n} elements differ (exact check)")
        log(f"  {label}: exact match")
        return 0.0
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{label}: non-finite kernel output")
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    max_err = float(err.max()) if err.numel() else 0.0  # a fully pruned image has no rows
    if bool(bad.any()):
        raise AssertionError(
            f"{label}: {int(bad.sum())} elements beyond atol {atol} rtol {rtol}, "
            f"max abs err {max_err:.3e}"
        )
    log(f"  {label}: max_abs_err {max_err:.3e} (atol {atol}, rtol {rtol})")
    return max_err


# source: (its bf16-operand kernels, each on the tensor cores in every
# instantiation, the fp32-output ones included; its fp32 kernel on the FMA
# units, or None where its fp32 kernels are TF32_TENSOR_CORE_KERNELS ones)
TENSOR_CORE_KERNELS = {
    # the model's 64 -> 64 convs, and every other bf16-operand conv
    "conv3x3.cu": (("conv3x3_mma_kernel", "conv3x3_igemm_kernel"), None),
    "conv_chain.cu": (("chain_mma_kernel",), None),
}
# source: its kernels in Hopper's shape, on the warpgroup tensor-core path
# (HGMMA in every instantiation, no HMMA, and no local-memory load or store:
# nothing spilled): the stack attention's bf16 kernel (BF16 and MIXED
# outputs, keep masks), the bidirectional kernel on the same tile (both
# directions in one grid; BF16 and MIXED outputs, stored or recomputed s
# at bf16 stats, fp32 stats; clusters or one block a tile), the stack
# projections' bf16-product GEMM (BF16, MIXED's fp32 activations and INT8's
# int8 weights, both converted to bf16 in shared memory) and the flash
# kernel behind fused_mha, flash_attention and the ring step (BF16 and
# MIXED outputs, the step's carries; stored or recomputed s, clusters or
# one block a tile)
WGMMA_KERNELS = {"attention.cu": "attention_wgmma_kernel", "linear.cu": "linear_wgmma_kernel",
                 "flash_attn.cu": "flash_wgmma_kernel", "bidir_cross.cu": "bidir_wgmma_kernel"}
# source: its fp32 kernel in 3xTF32 on Hopper's warpgroup MMA, held to what
# WGMMA_KERNELS holds the bf16 kernels to, with TF32 operands on every
# HGMMA line: the stack projections' fp32 GEMM (the transposed product),
# the flash kernel's fp32 instantiations (fused_mha, flash_attention, the
# ring step at fp32 operands; clusters or one block a tile), the stack
# attention's fp32 kernel (keep masks or not, a cluster of two blocks or
# one), the bidirectional kernel's fp32 kernel on the same tile (a cluster
# or one block) and the model's fp32 64 -> 64 conv
TF32_WGMMA_KERNELS = {"linear.cu": "linear_tf32_wgmma_kernel",
                      "flash_attn.cu": "flash_tf32_wgmma_kernel",
                      "attention.cu": "attention_tf32_wgmma_kernel",
                      "bidir_cross.cu": "bidir_tf32_wgmma_kernel",
                      "conv3x3.cu": "conv3x3_tf32_wgmma_kernel"}
# source: its int8 x int8 kernel (W8A8), on the integer tensor cores (IMMA)
INT8_TENSOR_CORE_KERNELS = {"linear.cu": "linear_s8_kernel"}
# source: its fp32 kernels on the tensor cores in 3xTF32 on mma.sync (TF32
# HMMA only): the generic fp32 conv, the fp32 chain. Each one's local-memory
# loads and stores (spills) are reported beside
TF32_TENSOR_CORE_KERNELS = {"conv3x3.cu": ("conv3x3_tf32x3_generic_kernel",),
                            "conv_chain.cu": ("chain_tf32x3_kernel",)}
# names of kernels none of which may run on the FMA units alone: tensor-core
# products (HMMA, or HGMMA on wgmma) in every kernel whose name holds one
# (conv3x3.cu's and conv_chain.cu's, the only ones so named)
ALL_TENSOR_CORE_NAMES = ("conv3x3_", "chain_")
# source: a kernel whose rounding contract rounds every product and every add
NO_FMA_KERNELS = {"stem.cu": "stem_kernel"}


def tensor_core_check(build):
    """The bf16-operand instantiations of csrc/conv3x3.cu (the model conv
    and the generic one) and conv_chain.cu compute their products on the
    tensor cores (HMMA in the SASS of every one); attention.cu's,
    bidir_cross.cu's and flash_attn.cu's bf16 kernels and linear.cu's
    bf16-product GEMM (MIXED's fp32 activations and INT8's int8 weights
    converted to bf16 in shared memory) on wgmma (HGMMA in every instantiation, no HMMA,
    no local-memory load or store: ``WGMMA_KERNELS``); the fp32 kernels of
    flash_attn.cu, linear.cu, attention.cu and bidir_cross.cu and the fp32
    model conv in 3xTF32 on wgmma (the same, with TF32 operands on every
    HGMMA line: ``TF32_WGMMA_KERNELS``); linear.cu's W8A8 GEMM on the
    integer tensor cores (IMMA in every instantiation, no HMMA, no
    local-memory load or store: nothing spilled), the generic fp32 conv and
    the fp32 chain on the tensor cores in 3xTF32 on mma.sync (every HMMA of
    each ``TF32_TENSOR_CORE_KERNELS`` kernel takes TF32 operands, in every
    instantiation; their local loads and stores logged), every
    conv3x3.cu and conv_chain.cu kernel on the tensor cores (no
    FMA conv left: ``ALL_TENSOR_CORE_NAMES``), and the
    stem rounds each product and each add (no FFMA in stem.cu's kernel):
    ``cuobjdump -sass`` of the built library."""
    from lightglue_tpu_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build)], check=True, capture_output=True,
                          text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = {"HMMA": 0, "HGMMA": 0, "IMMA": 0, "FFMA": 0, "TF32": 0,
                            "HGMMA_TF32": 0, "LDL": 0, "STL": 0}
        elif name:
            for op in ("HMMA", "HGMMA", "IMMA", "FFMA", "LDL", "STL"):
                if op in line:
                    counts[name][op] += 1
            if "HMMA" in line and "TF32" in line:
                counts[name]["TF32"] += 1
            if "HGMMA" in line and "TF32" in line:
                counts[name]["HGMMA_TF32"] += 1
    for src, (bf16_kernels, fp32_kernel) in TENSOR_CORE_KERNELS.items():
        for bf16_kernel in bf16_kernels:
            mma = [c["HMMA"] for k, c in counts.items() if bf16_kernel in k]
            log(f"  {src} SASS: HMMA per {bf16_kernel} instantiation ({len(mma)}) {sorted(mma)}")
            if not mma or min(mma) == 0:
                raise AssertionError(f"{src}: a {bf16_kernel} instantiation without HMMA")
        if fp32_kernel is None:
            continue
        fma = [c["HMMA"] for k, c in counts.items() if fp32_kernel in k]
        log(f"  {src} SASS: HMMA per {fp32_kernel} instantiation ({len(fma)}) {sorted(fma)}")
        if not fma or max(fma) != 0:
            raise AssertionError(f"{src}: an fp32 kernel with HMMA")
    for src, kernel in WGMMA_KERNELS.items():
        wg = [(c["HGMMA"], c["HMMA"], c["LDL"] + c["STL"]) for k, c in counts.items()
              if kernel in k]
        log(f"  {src} SASS: (HGMMA, HMMA, local loads and stores) per {kernel} instantiation "
            f"({len(wg)}) {sorted(wg)}")
        if not wg or min(h for h, _, _ in wg) == 0 or max(m for _, m, _ in wg) != 0:
            raise AssertionError(f"{src}: a {kernel} instantiation without HGMMA, or with HMMA: "
                                 "it did not reach wgmma")
        if max(spill for _, _, spill in wg) != 0:
            raise AssertionError(f"{src}: {kernel} spills to local memory")
    for src, kernel in TF32_WGMMA_KERNELS.items():
        wg = [(c["HGMMA"], c["HGMMA_TF32"], c["HMMA"], c["LDL"] + c["STL"])
              for k, c in counts.items() if kernel in k]
        log(f"  {src} SASS: (HGMMA, TF32 HGMMA, HMMA, local loads and stores) per {kernel} "
            f"instantiation ({len(wg)}) {sorted(wg)}")
        if not wg or min(h for h, _, _, _ in wg) == 0 or any(t != h for h, t, _, _ in wg) or max(
                m for _, _, m, _ in wg) != 0:
            raise AssertionError(f"{src}: a {kernel} instantiation without HGMMA, with an HGMMA "
                                 "of other operands than TF32, or with HMMA")
        if max(spill for _, _, _, spill in wg) != 0:
            raise AssertionError(f"{src}: {kernel} spills to local memory")
    for src, kernel in INT8_TENSOR_CORE_KERNELS.items():
        imma = [(c["IMMA"], c["HMMA"], c["LDL"] + c["STL"]) for k, c in counts.items()
                if kernel in k]
        log(f"  {src} SASS: (IMMA, HMMA, local loads and stores) per W8A8 instantiation "
            f"({len(imma)}) {sorted(imma)}")
        if not imma or min(i for i, _, _ in imma) == 0 or max(h for _, h, _ in imma) != 0:
            raise AssertionError(f"{src}: a W8A8 GEMM without IMMA, or with HMMA")
        if max(s for _, _, s in imma) != 0:
            raise AssertionError(f"{src}: a W8A8 GEMM spills to local memory")
    for src, kernels in TF32_TENSOR_CORE_KERNELS.items():
        for kernel in kernels:
            tf32 = [(c["TF32"], c["HMMA"], c["LDL"] + c["STL"]) for k, c in counts.items()
                    if kernel in k]
            log(f"  {src} SASS: (TF32 HMMA, HMMA, local loads and stores) per {kernel} "
                f"instantiation ({len(tf32)}) {tf32}")
            if not tf32 or min(t for t, _, _ in tf32) == 0 or any(t != h for t, h, _ in tf32):
                raise AssertionError(f"{src}: {kernel} without TF32 HMMA, or with another HMMA")
    for name in ALL_TENSOR_CORE_NAMES:
        mma = [c["HMMA"] + c["HGMMA"] for k, c in counts.items() if name in k]
        log(f"  {name}* kernels ({len(mma)}): HMMA + HGMMA per kernel {sorted(mma)}")
        if not mma or min(mma) == 0:
            raise AssertionError(f"a {name}* kernel without HMMA or HGMMA: an FMA kernel is left")
    for src, kernel in NO_FMA_KERNELS.items():
        ffma = [c["FFMA"] for k, c in counts.items() if kernel in k]
        log(f"  {src} SASS: FFMA per instantiation ({len(ffma)}) {ffma}")
        if not ffma or max(ffma) != 0:
            raise AssertionError(f"{src}: a contracted multiply-add breaks the stem's rounding")


def rounding_witness(label, got, want, wrong):
    """The rounding-contract witness of the bf16 attention and conv kernels: ``want``
    is the kernel's plain version and each of ``wrong`` (name -> output) the
    plain version of a design that rounds at other points, on the same
    inputs. Such a design differs from ``want`` in a large share of
    elements, where a different fp32 sum order flips a rounding only here
    and there; both pass ``TOL``. Fails unless the kernel's share of
    elements that differ from ``want`` is at most a quarter of each wrong
    design's share."""
    if not wrong:
        log(f"  {label}: rounding witness skipped, block_k / 8 does not divide the keys")
        return
    k_share = float((got != want).float().mean())
    for name, alt in wrong.items():
        p_share = float((want != alt).float().mean())
        log(f"  {label}: rounding witness: kernel vs plain differ in {k_share:.5f} of elements, "
            f"plain vs {name} in {p_share:.5f} (kernel at most a quarter)")
        if k_share > p_share / 4:
            raise AssertionError(f"{label}: kernel differs from its plain version in "
                                 f"{k_share:.5f} of elements, over a quarter of {p_share:.5f} "
                                 f"({name})")


def fine_block(plain_at, block, n):
    """The flash kernels' wrong design: the plain version at a block_k 8x
    smaller (m, l and acc rounded per staged chunk instead of per tile),
    where that divides the n keys, else none."""
    fine_k = min(block, n) // 8
    if not fine_k or n % fine_k:
        return {}
    return {"plain at block_k / 8": plain_at(fine_k)}


def stack_wrong_designs(q, k, v, freqs, len_q, len_kv, num_heads):
    """The stack attention's two wrong designs on the same bf16 operands
    (``layer_stack.attention``'s arguments, bf16 stats): (a) an online
    softmax per Nk / 8 keys (``flash_attention_plain`` on the rotated heads,
    m, l and acc rounded per tile) and (b) the contract's whole-row softmax
    with acc rounded through bf16 before the division by l. Both outputs
    are (B, Nq, H*64) bf16."""
    import torch

    from lightglue_tpu_torch.kernels import attention as at
    from lightglue_tpu_torch.kernels import layer_stack as ls

    bf16 = torch.bfloat16
    bsz, nq, e = q.shape
    nk, hd = k.shape[1], e // num_heads

    def heads(t, n):
        return t.reshape(bsz, n, num_heads, hd).transpose(1, 2)

    def merge(t):
        return t.transpose(1, 2).reshape(bsz, nq, e).to(bf16)

    qh, kh, vh = heads(q, nq), heads(k, nk), heads(v, nk)
    if freqs is not None:
        qh, kh = ls.apply_rotary(freqs, qh), ls.apply_rotary(freqs, kh)
    lens = None if len_q is None else torch.stack([len_q, len_kv], dim=1)
    online = at.flash_attention_plain(qh, kh, vh, lens, stat_dtype=bf16, block_q=nq,
                                      block_k=nk // 8)
    s = ls._quant((qh.float() @ kh.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd)), bf16)
    if lens is not None:
        s = torch.where(torch.arange(nk, device=q.device) < len_kv.view(-1, 1, 1, 1), s, -1e30)
    m = ls._quant(s.amax(dim=-1, keepdim=True), bf16)
    if lens is not None:
        m = m.clamp_min(-5e29)
    p = ls._quant(torch.exp(s - m), bf16)
    l = ls._quant(p.sum(dim=-1, keepdim=True), bf16)
    rounded = ls._quant(p.to(bf16).float() @ vh.float(), bf16) / torch.where(l == 0.0, 1.0, l)
    if lens is not None:
        rows = torch.arange(nq, device=q.device).view(1, 1, -1, 1)
        rounded = torch.where(rows < len_q.view(-1, 1, 1, 1), rounded, 0.0)
    return {"(a) online softmax per Nk / 8 keys": merge(online),
            "(b) acc rounded before / l": merge(rounded)}


def conv_taps(x, w, taps=range(9), each=None):
    """The fp32 sum of a SAME 3x3 conv's nine shifted products on NHWC ``x``
    and HWIO ``w`` (cast to x's dtype), taken tap by tap in the order
    ``taps``; ``each`` is applied to the running sum after every tap."""
    import torch.nn.functional as F

    h, wd = x.shape[1:3]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.to(x.dtype).float()
    acc = None
    for t in taps:
        dy, dx = divmod(t, 3)
        term = xp[:, dy:dy + h, dx:dx + wd] @ wf[dy, dx]
        acc = term if acc is None else acc + term
        if each is not None:
            acc = each(acc)
    return acc


def conv_epilogue(acc, b, pool, relu=True, out_dtype=None):
    """superpoint.py:_relu_conv after the sum (conv.py:conv3x3's with
    ``relu``): fp32 bias, ReLU when asked, the optional 2x2 max-pool, one
    cast to ``out_dtype`` (bf16 by default)."""
    import torch
    import torch.nn.functional as F

    out = acc + b.float()
    if relu:
        out = torch.relu(out)
    if pool:
        out = F.max_pool2d(out.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    return out.to(out_dtype or torch.bfloat16)


def _round_bf16(t):
    import torch

    return t.to(torch.bfloat16).float()


def conv_wrong_designs(x, w, b, pool, relu=True, out_dtype=None):
    """A bf16 conv's two wrong designs on the same bf16 operands
    (``conv.conv3x3``'s arguments, any C_out): (a) acc rounded through bf16
    before the bias; (b) acc rounded through bf16 after every tap. Both
    outputs are (B, H', W', C_out) in ``out_dtype`` (bf16 by default)."""
    rnd = _round_bf16
    return {"(a) acc rounded before the bias":
            conv_epilogue(rnd(conv_taps(x, w)), b, pool, relu, out_dtype),
            "(b) acc rounded after every tap":
            conv_epilogue(conv_taps(x, w, each=rnd), b, pool, relu, out_dtype)}


def chain_wrong_designs(x, wa, ba, wb, bb, relu=True, out_dtype=None):
    """``conv2_chain``'s two wrong designs on the same bf16 operands: (a)
    conv2a's output kept in fp32, not rounded to bf16 before conv2b; (b)
    conv2b's acc rounded through bf16 before the bias. Both outputs are
    (B, H/2, W/2, 64) in ``out_dtype`` (bf16 by default)."""
    import torch

    mid = torch.relu(conv_taps(x, wa) + ba.float())  # conv_taps pads it with zeros
    rounded = mid.to(torch.bfloat16)
    return {"(a) conv2a kept in fp32":
            conv_epilogue(conv_taps(mid, wb), bb, True, relu, out_dtype),
            "(b) conv2b's acc rounded before the bias":
            conv_epilogue(_round_bf16(conv_taps(rounded, wb)), bb, True, relu, out_dtype)}


def tf32_round(t):
    """fp32 values rounded to TF32 as cvt.rna.tf32.f32 does on finite
    values: to nearest on the 10-bit mantissa, ties away from zero."""
    import torch

    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def conv_f64(x, w, b, pool, relu=True):
    """superpoint.py:_relu_conv (conv.py:conv3x3's with ``relu``) in
    float64 on NHWC x and HWIO w: the reference the fp32 convs' error is
    measured against."""
    import torch.nn.functional as F

    out = F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1), padding=1)
    out = out + b.double()[None, :, None, None]
    if relu:
        out = F.relu(out)
    if pool:
        out = F.max_pool2d(out, 2)
    return out.permute(0, 2, 3, 1)


def tf32_witness(label, got, f64, one, others=()):
    """A 3xTF32 kernel (the fp32 model conv, the fp32 attention kernels,
    ``linear_tf32_wgmma_kernel``) against a float64 computation of its function,
    beside an emulated one-TF32 version (operands rounded to TF32, products
    in fp32 with TF32 off) as the wrong design: the kernel's mean |kernel -
    f64| is at most a quarter of the one-TF32 version's
    (``magnitude_witness``). ``others``: (name, output) pairs whose error is
    logged beside. Returns the kernel's max |kernel - f64|."""
    errs = {name: (t.double() - f64).abs() for name, t in
            (("3xTF32 kernel", got), *others, ("one TF32", one))}
    log(f"  {label}: vs float64: " + "; ".join(
        f"{name} max {float(e.max()):.3e} mean {float(e.mean()):.3e}" for name, e in errs.items()))
    magnitude_witness(label, got.double(), f64, {"one TF32 product": one.double()})
    return float(errs["3xTF32 kernel"].max())


def conv_tf32_witness(conv_k, label, got, x, w, b, pool):
    """``tf32_witness`` of the fp32 model conv against ``conv_f64``, beside
    the generic fp32 conv's error on the same inputs (its 3xTF32 kernel,
    split by truncation, without the ReLU and pool that the epilogue then
    adds in fp32), the wrong design an emulated one-TF32 conv."""
    import torch.nn.functional as F

    generic = F.relu(conv_k.conv3x3(x, w, b, relu=False))
    if pool:
        generic = F.max_pool2d(generic.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    one = conv_k.conv3x3_plain(tf32_round(x), tf32_round(w), b, pool)
    return tf32_witness(label, got, conv_f64(x, w, b, pool), one,
                        (("generic 3xTF32 kernel", generic),))


def attention_f64(q, k, v, lengths=None, scale=None):
    """softmax(Q.K^T * scale) V in float64 on (B, H, N, D) heads, masked as
    ``reference_attention`` (columns past kv_len at -1e30, rows past q_len
    0): the function the fp32 flash kernel computes with fp32 stats."""
    import torch

    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    s = (q.double() @ k.double().transpose(-1, -2)) * scale
    if lengths is not None:
        lens = lengths.to(q.device, torch.int64)
        s = torch.where(torch.arange(k.shape[2], device=q.device) < lens[:, 1].view(-1, 1, 1, 1),
                        s, -1e30)
    out = torch.softmax(s, dim=-1) @ v.double()
    if lengths is not None:
        rows = torch.arange(q.shape[2], device=q.device).view(1, 1, -1, 1)
        out = torch.where(rows < lens[:, 0].view(-1, 1, 1, 1), out, 0.0)
    return out


def heads_of(t, heads=4):
    """(B, N, H*D) -> (B, H, N, D)."""
    b, n, e = t.shape
    return t.reshape(b, n, heads, e // heads).transpose(1, 2)


def stack_tf32_witness(ls, label, got, q, k, v, f, heads):
    """``tf32_witness`` of the fp32 stack attention (unmasked; RoPE when
    ``f`` is given, applied in fp32 as the kernel's pre-pass does) against
    ``attention_f64``, the wrong design its plain version on rotated q, k and
    v rounded to TF32."""
    if f is not None:
        q, k = (ls.apply_rotary(f, heads_of(t, heads)).transpose(1, 2).reshape(t.shape)
                for t in (q, k))
    f64 = attention_f64(heads_of(q, heads), heads_of(k, heads), heads_of(v, heads))
    one = ls.attention_plain(*map(tf32_round, (q, k, v)), None, None, None, heads, q.dtype)
    return tf32_witness(label, heads_of(got, heads), f64, heads_of(one, heads))


# the batches at which plan_checks holds the attention plans to the card's
# and to one pair's split
INVARIANCE_BATCHES = (1, 2, 4, 8)


def plan_checks(ls, at, nms_k, conv_k, cc, lib):
    """The launch plans the CPU tests hold (``layer_stack.linear_plan``,
    ``attention_plan``, ``decide_plan``, ``attention.flash_plan``,
    ``bidir_plan``, ``nms.nms_smem_bytes``, ``conv.conv_plan``,
    ``layer_stack.ln_gelu_plan``, ``conv_chain.chain_plan``) are the ones
    the card runs (csrc/linear.cu:lg_linear_plan in the FP32, BF16, MIXED
    and INT8 modes: the tile, ring and kernel, the BF16 and FP32 tiles one
    pair's at every batch; csrc/flash_attn.cu:lg_flash_plan, both kernels' split,
    form, ring slots, kept s and shared memory, the split one pair's at
    every batch; csrc/attention.cu:lg_attention_plan, both
    kernels' split, form and shared memory; csrc/bidir_cross.cu:lg_bidir_plan,
    both kernels' split, form, kept s, blocks and shared memory, also at the
    TP shards' H = 2 and 1 and past 1024 rows, the split one pair's at every
    batch and the fp32 form too;
    csrc/adaptive.cu:decide_rows,
    csrc/nms.cu:Band,
    csrc/conv3x3.cu:conv_rows and both generic kernels' shared memory,
    csrc/ln_gelu.cu's lane map, csrc/conv_chain.cu:lg_chain_plan), at every
    shape of the paths through the
    stack (128-1024 buckets) and through the bidirectional kernel (960x960,
    960x704, 960x64), at 1, 2, 4 and 8 pairs (``INVARIANCE_BATCHES``: each
    attention kernel's split of a chunk's keys is one pair's at every
    batch; a block may take more of one pair's row groups, or a cluster
    form, as the batch grows), the decision at B = 1..8 over the
    stack's buckets in both row types, at every NMS radius the kernel is
    built for (and one past it), and at the generic conv's shapes in
    phase 5 and a grid of SuperPoint-like maps and widths (the model's fp32
    conv, csrc/conv3x3.cu:lg_conv_model_tile, at those maps and 360x488)."""
    import ctypes

    out = (ctypes.c_int * 4)()
    import torch

    lin = (ctypes.c_int * 5)()
    lin_modes = ((0, torch.float32, torch.float32), (1, torch.bfloat16, torch.bfloat16),
                 (2, torch.float32, torch.bfloat16), (4, torch.bfloat16, torch.int8))
    for rows in range(128, 1025, 128):
        for b in INVARIANCE_BATCHES:
            for n in (256, 512, 768):
                for mode, dt, wdt in lin_modes:
                    lib.lg_linear_plan(b * rows, n, rows, mode, lin)
                    plan = ls.linear_plan(b * rows, n, 256, dt, wdt, rows=rows)
                    want = (plan.bm, plan.bn, plan.stages, plan.smem,
                            int(plan.kernel == "linear_wgmma_kernel"))
                    if tuple(lin) != want:
                        raise AssertionError(f"linear {b}x{rows}x{n} mode {mode}: the card's (rows, "
                                             f"columns, slots, smem, wgmma) {tuple(lin)}, "
                                             f"linear_plan's {want}")
    s8 = (ctypes.c_int * 3)()
    for m in (1, 99, 128, 256, 512, 768, 999, 1024, 2048):
        for n in (64, 256, 512, 768):
            for k in (48, 256, 512):
                lib.lg_s8_plan(m, n, k, s8)
                plan = ls.s8_plan(m, n, k)
                if tuple(s8) != (plan.bm, plan.bn, plan.smem):
                    raise AssertionError(f"linear_s8 {m}x{n}x{k}: the card's (rows, columns, "
                                         f"smem) {tuple(s8)}, s8_plan's "
                                         f"{(plan.bm, plan.bn, plan.smem)}")
    # flash_attn.cu at the per-block, generic and ring shapes (block_k 1024,
    # 1000, 64, 2048, the ring's 512, 384 and 120-row stripes, the TP
    # shards' heads), both kernels and both stat types, at batches 1, 2, 4
    # and 8: the launch is the card's, and each chunk's split one batch
    # entry's at every batch (both kernels' flash_split)
    fl = (ctypes.c_int * 7)()
    for b in INVARIANCE_BATCHES:
        for heads, nq, block_k in ((4, 2048, 1024), (4, 960, 960), (4, 1000, 1000),
                                   (4, 512, 512), (4, 384, 192), (4, 120, 120), (4, 256, 64),
                                   (4, 2048, 2048), (2, 2048, 1024), (1, 2048, 1024)):
            for mode, dt in ((0, torch.float32), (1, torch.bfloat16)):
                for sdt in (torch.bfloat16, torch.float32):
                    plan = at.flash_plan(b, heads, nq, block_k, dt, sdt)
                    lib.lg_flash_plan(b, heads, nq, block_k, mode, int(sdt == torch.bfloat16), fl)
                    want = (plan.row_groups, plan.col_split, plan.stages, plan.blocks, plan.smem,
                            int(plan.cluster), int(plan.store))
                    one = at.flash_plan(1, heads, nq, block_k, dt, sdt).col_split
                    if tuple(fl) != want or plan.col_split != one:
                        raise AssertionError(
                            f"flash B={b} H={heads} Nq={nq} block_k {block_k} {dt} {sdt} stats: "
                            f"the card's (row groups, split, stages, blocks, smem, cluster, "
                            f"store) {tuple(fl)}, flash_plan's {want}, one pair's split {one}")
    attn = (ctypes.c_int * 4)()
    for b in INVARIANCE_BATCHES:
        for mode, dt in ((0, torch.float32), (1, torch.bfloat16)):
            for nq in (128, 256, 512, 768, 896, 960, 1024):
                for sdt in {dt, torch.float32}:  # bf16 operands: bf16 stats keep s
                    plan = ls.attention_plan(b, 4, nq, 1024, dt, sdt)
                    lib.lg_attention_plan(b, 4, nq, mode, int(sdt == torch.bfloat16), attn)
                    want = (plan.row_groups, plan.col_split, plan.smem, plan.blocks)
                    if tuple(attn) != want:
                        raise AssertionError(f"attention B={b} Nq={nq} {dt} {sdt} stats: the "
                                             f"card's (row groups, split, smem, blocks) "
                                             f"{tuple(attn)}, attention_plan's {want}")
                if plan.col_split != ls.attention_plan(1, 4, nq, 1024, dt).col_split:
                    raise AssertionError(f"attention B={b} Nq={nq} {dt}: the split follows the "
                                         "batch")
            bi = (ctypes.c_int * 6)()
            for (n0, n1), heads in itertools.product(
                    ((960, 960), (960, 704), (960, 64), (1280, 1088)), (4, 2, 1)):
                for sdt in {dt, torch.float32}:
                    lib.lg_bidir_plan(b, heads, n0, n1, mode, int(sdt == torch.bfloat16), bi)
                    plan = at.bidir_plan(b, heads, n0, n1, dt, sdt)
                    one = at.bidir_plan(1, heads, n0, n1, dt, sdt)
                    want = (int(plan.kernel == "bidir_tf32_wgmma_kernel"), plan.col_split,
                            int(plan.cluster), int(plan.store), plan.blocks, plan.smem)
                    if (tuple(bi) != want or plan.col_split != one.col_split
                            or (dt == torch.float32 and plan.cluster != one.cluster)):
                        raise AssertionError(
                            f"bidirectional B={b} H={heads} {n0}x{n1} {dt} {sdt} stats: the "
                            f"card's (fp32 kernel, split, cluster, store, blocks, smem) "
                            f"{tuple(bi)}, bidir_plan's {want}, one pair's {one}")
    for b in range(1, 9):
        for n0 in (128, 256, 512, 768, 1024):
            for n1 in (128, 512, 1024):
                for size in (2, 4):
                    lib.lg_decide_plan(b, n0, n1, 256, size, out)
                    plan = ls.decide_plan(b, n0, n1, 256, size)
                    if tuple(out) != tuple(plan):
                        raise AssertionError(f"adaptive_decide B={b} {n0}x{n1} x{size}: the card's "
                                             f"{tuple(out)}, decide_plan's {tuple(plan)}")
    for r in range(nms_k.MAX_RADIUS + 2):
        want = nms_k.nms_smem_bytes(r) if r <= nms_k.MAX_RADIUS else -1
        if lib.lg_nms_smem_bytes(r) != want:
            raise AssertionError(f"nms radius {r}: the card's {lib.lg_nms_smem_bytes(r)} bytes "
                                 f"of shared memory, nms_smem_bytes' {want}")
    conv_shapes = {(2, h, w, cout) for _, h, w, _, cout, _, _ in GENERIC_CONVS + GENERIC_EDGE_CONVS}
    conv_shapes |= {(b, h, w, cout) for b in (1, 2) for h, w in ((60, 80), (120, 160), (180, 244),
                                                                   (240, 320), (480, 640))
                    for cout in (8, 40, 64, 128, 256)}
    for shape in sorted(conv_shapes):
        for fp32, dt in ((0, torch.bfloat16), (1, torch.float32)):
            lib.lg_conv_tile(*shape, fp32, out)
            if tuple(out) != tuple(conv_k.conv_plan(*shape, dt)):
                raise AssertionError(f"conv3x3 {shape} {dt}: the card's tile {tuple(out)}, "
                                     f"conv_plan's {tuple(conv_k.conv_plan(*shape, dt))}")
    for b, h, w in sorted({(b, h, w) for b, h, w, _ in conv_shapes} | {(2, 360, 488)}):
        lib.lg_conv_model_tile(b, h, w, out)  # the model's fp32 64 -> 64 conv
        if tuple(out) != tuple(conv_k.model_conv_plan(b, h, w)):
            raise AssertionError(f"model fp32 conv {b}x{h}x{w}: the card's launch {tuple(out)}, "
                                 f"model_conv_plan's {tuple(conv_k.model_conv_plan(b, h, w))}")
    for mode, dt in ((0, torch.float32), (1, torch.bfloat16), (2, torch.bfloat16)):
        lib.lg_ln_gelu_plan(mode, out)
        if tuple(out) != tuple(ls.ln_gelu_plan(dt)):
            raise AssertionError(f"ln_gelu mode {mode}: the card's lane map {tuple(out)}, "
                                 f"ln_gelu_plan's {tuple(ls.ln_gelu_plan(dt))}")
    for b, h, w in ((2, 240, 320), (2, 180, 244), (1, 240, 320)):
        for fp32, dt in ((0, torch.bfloat16), (1, torch.float32)):
            lib.lg_chain_plan(b, h, w, fp32, out)
            plan = cc.chain_plan(b, h, w, dt)
            if tuple(out) != tuple(plan) or plan.smem > 227 * 1024:
                raise AssertionError(f"conv2_chain {b}x{h}x{w} {dt}: the card's plan {tuple(out)}, "
                                     f"chain_plan's {tuple(plan)} (227 KB a block at most)")
    log("  launch plans: linear_plan (every mode), s8_plan, flash_plan, attention_plan and "
        "bidir_plan (both kernels each), decide_plan, nms_smem_bytes, conv_plan (both generic "
        "kernels), ln_gelu_plan and chain_plan (both kernels) match the card's at every path "
        "shape")


def nms_map(gen, dev, b, h, w):
    """Raw scores on a grid of 64 levels (many exact ties) with one planted
    plateau tile, every pixel tied, where the map holds it."""
    import torch

    raw = torch.floor(torch.rand(b, h, w, generator=gen, device=dev) * 64) / 4096
    raw[:, 100:108, 200:208] = 0.02
    return raw


def nms_checks(nms_k, gen, dev):
    """nms_candidates against its plain version, values and indices exactly:
    the path's 2x480x640 map, the edge bands of 360x488 and 480x600 (W not
    a multiple of the kernel's 64-column band, H not of its 32-row band),
    radius 2, caps 1 and 8, a map entirely below the border value -1 (with
    and without the border), and plateaus across the band edges (rows 32
    and 64, cols 64 and 128) on a map of four levels."""
    import torch

    ties = torch.floor(torch.rand(2, 480, 640, generator=gen, device=dev) * 4) / 16
    ties[:, 28:36, 60:68] = 0.5
    ties[:, 60:68, 124:132] = 0.5
    ties[:, 30:34, 126:130] = 0.75
    low = -2 - nms_map(gen, dev, 2, 480, 640)
    cases = [  # label, map, radius, border, cap
        ("2x480x640", nms_map(gen, dev, 2, 480, 640), 4, 4, 4),
        ("2x360x488", nms_map(gen, dev, 2, 360, 488), 4, 4, 4),
        ("2x480x600", nms_map(gen, dev, 2, 480, 600), 4, 4, 4),
        ("radius 2", nms_map(gen, dev, 2, 480, 640), 2, 4, 4),
        ("cap 1", nms_map(gen, dev, 2, 480, 640), 4, 4, 1),
        ("cap 8", nms_map(gen, dev, 2, 360, 488), 4, 4, 8),
        ("below the border value", low, 4, 4, 4),
        ("below the border value, border 0", low, 4, 0, 4),
        ("ties across band edges", ties, 4, 4, 4),
    ]
    for label, raw, radius, border, cap in cases:
        got_v, got_i = nms_k.nms_candidates(raw, radius, border, cap)
        want_v, want_i = nms_k.nms_candidates_plain(raw, radius, border, cap)
        compare(f"nms {label} values", got_v, want_v, 0, 0, exact=True)
        compare(f"nms {label} indices", got_i, want_i, 0, 0, exact=True)


def stem_checks(stem_k, gen, dev, fp32_scope, stem_e, stem_fp32_e):
    """relu_conv1a_shift against its plain version bit for bit, on a bf16
    image (BF16, INT8) and an fp32 one (MIXED, FP32), both with fp32
    weights as the session's SuperPoint tree holds them on every rung, at
    2x480x640 and at the edge tiles of 2x360x488 and 2x480x600.
    At 480x640 it times the kernel, its plain version and one cuDNN call
    for the same function on channels-last input with TF32 off (its sum
    order differs, so it is only a yardstick)."""
    import torch
    import torch.nn.functional as F

    for h, w, timed in ((480, 640, True), (360, 488, False), (480, 600, False)):
        for tag, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            x = torch.rand(2, h, w, 1, generator=gen, device=dev).to(dt)
            wt = (torch.rand(3, 3, 1, 64, generator=gen, device=dev) * 2 - 1) / 3
            b = (torch.rand(64, generator=gen, device=dev) * 2 - 1) / 4
            label = f"stem 2x{h}x{w} {tag}"
            got = stem_k.relu_conv1a_shift(x, wt, b)
            want = stem_k.relu_conv1a_shift_plain(x, wt, b)
            if got.dtype != dt or got.shape != (2, h, w, 64):
                raise AssertionError(f"{label}: {got.dtype} {tuple(got.shape)}")
            compare(label, got, want, 0, 0, exact=True)
            if not timed:
                continue
            ent = stem_e if tag == "bf16" else stem_fp32_e
            bc = b.to(dt)  # cuDNN takes the weights and bias in the input's dtype
            xc = x.permute(0, 3, 1, 2)
            wc = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last).to(dt)
            ms = cuda_ms(lambda: stem_k.relu_conv1a_shift(x, wt, b))
            plain = cuda_ms(lambda: stem_k.relu_conv1a_shift_plain(x, wt, b))
            with fp32_scope():
                lib_ms = cuda_ms(lambda: F.relu(F.conv2d(xc, wc, bc, padding=1)))
            nbytes = x.element_size() * (2 * h * w + 2 * h * w * 64) + 4 * (9 * 64 + 64)
            # 9 products and 9 adds per output, the bias and the ReLU
            ent.add(label, 1, ms, plain, lib_ms, nbytes, 2 * h * w * 64 * 20, FP32_OP_PER_MS)


# ln_gelu's checks: (rows, C) beside the path's 1024 x 512 (200: whole
# 16-byte vectors in both row types; 100: element by element in bf16)
LN_SHAPES = ((1024, 512), (1024, 200), (999, 100), (999, 512))
LN_SENTINEL = 7.0  # what a retired pair's rows must keep
LN_SEED = 15  # ln_gelu_checks' and ffn_triple_ms' own generator: later phases keep their inputs


def seeded_rand(dev, seed):
    """``rand(*shape, dtype=, uniform=)`` drawing from a generator of its own."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, dtype=torch.float32, uniform=False):
        f = torch.rand if uniform else torch.randn
        return f(*shape, generator=gen, device=dev).to(dtype)

    return rand


def ln_gelu_checks(ls, build, dev, fp32_scope):
    """``ln_gelu`` (csrc/ln_gelu.cu) against its plain version in its three
    modes (FP32; BF16; INT8's bf16 rows with fp32 gamma and beta) at
    ``LN_SHAPES``; under liveness (two pairs of 512 rows, the second retired)
    through the C entry into a buffer of ``LN_SENTINEL``, which the retired
    pair's rows must keep; and at fp32 rows with a large mean and a small
    spread (8 + m / 16, sixteen m = 1 a row, the rest 0: every sum exact,
    mean * mean rounded), where the contract's var = E[x^2] - mean^2 and
    Welford's (``F.layer_norm``) differ by more than the fp32 gate."""
    import torch
    import torch.nn.functional as F

    f32, bf16 = torch.float32, torch.bfloat16
    rand = seeded_rand(dev, LN_SEED)
    log("ln_gelu: three modes, ragged widths, liveness, the statistics contract")
    for tag, (dt, gt) in {"fp32": (f32, f32), "bf16": (bf16, bf16),
                          "int8 (bf16 rows, fp32 gamma/beta)": (bf16, f32)}.items():
        tol = TOL["fp32" if dt == f32 else "bf16"]
        for rows, c in LN_SHAPES:
            g, b = (1 + 0.3 * rand(c)).to(gt), (0.3 * rand(c)).to(gt)
            h = rand(1, rows, c, dtype=dt)
            with fp32_scope():
                compare(f"ln_gelu {tag} {rows}x{c}", ls.ln_gelu(h, g, b),
                        ls.ln_gelu_plain(h, g, b), **tol)
        n, c = 512, 512
        g, b = (1 + 0.3 * rand(c)).to(gt), (0.3 * rand(c)).to(gt)
        exit_reg = torch.tensor([N_LAYERS + 1.0, 3.0], device=dev)  # pair 1 retired at 3
        h = rand(2, n, c, dtype=dt)
        y = torch.full_like(h, LN_SENTINEL)
        build.check(build.lib().lg_ln_gelu(
            h.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), 2 * n, c, exit_reg.data_ptr(),
            5, n, ls._LN_MODES[(dt, gt)], torch.cuda.current_stream().cuda_stream), "ln_gelu")
        with fp32_scope():
            compare(f"ln_gelu {tag}, live pair at layer 5", y[:1], ls.ln_gelu_plain(h, g, b)[:1],
                    **tol)
        kept = int((y[1] == LN_SENTINEL).sum())
        log(f"  ln_gelu {tag}, retired pair: {kept} of {y[1].numel()} elements keep the sentinel")
        if kept != y[1].numel():
            raise AssertionError(f"ln_gelu {tag}: a retired pair's row was written")
    g, b = torch.ones(512, device=dev), torch.zeros(512, device=dev)
    m = torch.zeros(64, 512, device=dev)
    m.scatter_(1, rand(64, 512, uniform=True).argsort(dim=1)[:, :16], 1.0)
    h = 8 + m / 16
    with fp32_scope():
        want = ls.ln_gelu_plain(h, g, b)
        compare("ln_gelu fp32, mean 8, spread 1/64", ls.ln_gelu(h, g, b), want, **TOL["fp32"])
        welford = (F.gelu(F.layer_norm(h, (512,), g, b)) - want).abs().max()
    log(f"  Welford's statistics (F.layer_norm) differ from the contract's by {float(welford):.3e}")
    if not welford > 1e-2:
        raise AssertionError("ln_gelu: these rows do not tell E[x^2] - mean^2 from Welford")


def ffn_triple_ms(ls, dev, dt):
    """ms of ffn1 -> ln_gelu -> ffn2 of one block as the stack runs them
    (ffn1 over [x | message], ffn2 with x's residual; 1024 rows, E = 256),
    as a graph: ln_gelu's dependent launch after one GEMM and before
    another, where ``cuda_ms`` of ln_gelu alone has another ln_gelu before
    it."""
    e, rand = 256, seeded_rand(dev, LN_SEED)
    g, bb = (1 + 0.1 * rand(2 * e)).to(dt), (0.1 * rand(2 * e)).to(dt)
    w1, b1 = (rand(2 * e, 2 * e) / math.sqrt(2 * e)).to(dt), (rand(2 * e) / 32).to(dt)
    w2, b2 = (rand(2 * e, e) / math.sqrt(2 * e)).to(dt), (rand(e) / 32).to(dt)
    x, msg = rand(1, BUCKET, e, dtype=dt), rand(1, BUCKET, e, dtype=dt)

    def triple():
        h = ls.linear(x, w1, b1, a2=msg)
        return ls.linear(ls.ln_gelu(h, g, bb), w2, b2, residual=x)

    return cuda_ms(triple)


class Entry:
    """Per-kernel accumulator for the ``kernels`` JSON line: times and bounds
    summed over the kernel's launches in one main-path match_pair."""

    def __init__(self, name, source, replaces):
        self.d = dict(name=name, route="cuda", source=source, replaces=replaces,
                      launches=0, max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                      bound_ms=0.0, library_ms=None)
        self._bytes_ms = self._ops_ms = self.ops = 0.0

    def add(self, label, weight, ms, plain, lib, nbytes, ops, op_rate, per="match_pair"):
        """Record one timed case that the main path runs ``weight`` times per
        ``per`` (one match_pair, one forward_ring, one call of an entry point
        no path runs), and print its per-call line."""
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_MS, ops / op_rate
        self.d["ms"] += weight * ms
        self.d["plain_ms"] += weight * plain
        if lib is not None:
            self.d["library_ms"] = (self.d["library_ms"] or 0.0) + weight * lib
        self._bytes_ms += weight * t_bytes
        self._ops_ms += weight * t_ops
        self.ops += weight * ops
        lib_txt = "null" if lib is None else f"{lib:.4f}"
        log(f"  {label}: kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms {lib_txt} "
            f"bound_ms {max(t_bytes, t_ops):.4f} ({'bytes' if t_bytes >= t_ops else 'operations'})"
            f" x{weight} per {per}")

    def err(self, e):
        self.d["max_abs_err"] = max(self.d["max_abs_err"], e)

    def out(self):
        self.d["bound_ms"] = max(self._bytes_ms, self._ops_ms)
        self.d["bound_by"] = "bytes" if self._bytes_ms >= self._ops_ms else "operations"
        return self.d


def smooth_pair(seed, h=480, w=640, dy=20, dx=30):
    """A smoothed noise field and a shifted crop of it, (h, w, 1) in [0, 1]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    field = rng.random((h + dy + 8, w + dx + 8))
    box = np.ones(5) / 5.0
    for _ in range(2):  # two 5-tap box passes along each axis
        for axis in (0, 1):
            field = np.apply_along_axis(np.convolve, axis, field, box, mode="same")
    field = (field - field.min()) / (field.max() - field.min())
    img0 = field[:h, :w, None].astype(np.float32)
    img1 = field[dy:dy + h, dx:dx + w, None].astype(np.float32)
    return np.ascontiguousarray(img0), np.ascontiguousarray(img1)


def pinned_exit_weights(tree, exit_layer):
    """bench.py:162-180: token bias -50 before ``exit_layer`` and +50 from
    it (every token confident from there on), matchability bias +50
    (nothing is pruned), so every pair exits at ``exit_layer``."""
    import numpy as np

    tb = tree["token"]["b"]
    tree = dict(tree)
    tree["token"] = dict(tree["token"], b=np.where(
        np.arange(tb.shape[0])[:, None] >= exit_layer - 1, 50.0, -50.0).astype(np.float32))
    match = tree["assign"]["match"]
    tree["assign"] = dict(tree["assign"], match=dict(match, b=np.full_like(match["b"], 50.0)))
    return tree


def prune_weights(tree):
    """bench.py:181-201: a spread token head (normal, numpy seed 11) keeps
    the confident share under 0.95 (no early exit) and matchability bias
    -50 retires every confident token, so each layer prunes about half."""
    import numpy as np

    frng = np.random.default_rng(11)
    tree = dict(tree)
    tw = tree["token"]["w"]
    tree["token"] = dict(tree["token"], w=frng.standard_normal(tw.shape).astype(np.float32),
                         b=np.zeros_like(tree["token"]["b"]))
    match = tree["assign"]["match"]
    tree["assign"] = dict(tree["assign"], match=dict(match, b=np.full_like(match["b"], -50.0)))
    return tree


# the profiler keeps the device events whose times it places inside the
# recorded step, and its device clock can sit milliseconds off the host's:
# a call that starts at once drops its first kernels (it once dropped a
# replay's stem and three convs, about 1.3 ms of device work; once the
# whole extraction of every trace), so each call runs this long inside the
# step, and this long after the warm-up step's events
PAD_S = 0.05


def profiled(call, **config):
    """A profile of ``call``'s second of two runs: the first is its warm-up
    step, not recorded. Each run is ``PAD_S`` inside its step."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1), **config) as prof:
        for _ in range(2):
            time.sleep(PAD_S)
            call()
            torch.cuda.synchronize()
            time.sleep(PAD_S)
            prof.step()
    return prof


# traces behind each replay's launch counts: the profiler can drop kernel
# events of a recorded call, never add one (see PAD_S), so a count is the
# most any of these traces saw; a count still short of the wrappers' after
# TRACES traces takes more, up to MAX_TRACES
TRACES = 3
MAX_TRACES = 8


def device_ms(prof):
    """A profile's device time, ms (kernels and copies; the schedule's step
    annotation spans the call and is not device work)."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")) / 1e3


def traced(call, traces=1, want=None, **config):
    """``traces`` profiles of ``call`` (``profiled``): the fullest (the most
    device time) and the launches per wrapper, each the most any of them
    saw (``trace_launches``). With ``want`` (launches per wrapper), more
    traces, up to ``MAX_TRACES``, while a count is short of it; each short
    trace is logged."""
    profs, launches = [], {}

    def short(counts):
        return {k: counts.get(k, 0) for k, v in (want or {}).items() if counts.get(k, 0) < v}

    while len(profs) < traces or (short(launches) and len(profs) < MAX_TRACES):
        prof = profiled(call, **config)
        profs.append(prof)
        counts = trace_launches(prof)
        if short(counts):
            log(f"  trace {len(profs)} is short of the wrappers' counts: {short(counts)}")
        for k, v in counts.items():
            launches[k] = max(launches.get(k, 0), v)
    return max(profs, key=device_ms), launches


def trace_launches(prof):
    """Kernel launches per wrapper in a profile's recorded call, counted from
    its device events by kernel name (``KERNEL_WRAPPERS``)."""
    import re

    from torch.autograd import DeviceType

    counts = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for name, wrapper in KERNEL_WRAPPERS.items():
            m = re.search(rf"(?:^|[\s:]){name}(<[^(]*>)?\(", e.key)
            if m:
                if name.startswith("flash_") and (m.group(1) or "").startswith("<true"):
                    wrapper = "flash_attention_step"
                counts[wrapper] = counts.get(wrapper, 0) + e.count
    return counts


def first_call(counters, call):
    """``call`` as the first call of its session's keys, with every wrapper's
    launch count set to 0 just before it and read just after: (its result,
    the counts read, launches per call). That call captures its graphs:
    each body runs through the wrappers twice, eagerly (the warm-up that
    does every first-launch setup) and under capture, and the card runs
    each kernel twice (the warm-up and the graph's first replay), so every
    count is twice one call's launches."""
    for fn in counters:
        fn.launches = 0
    out = call()
    counts = {fn.__name__: fn.launches for fn in counters}
    odd = {k: v for k, v in counts.items() if v % 2}
    if odd:
        raise AssertionError(f"launch counts over a capturing call are odd: {odd}")
    return out, counts, {k: v // 2 for k, v in counts.items()}


def hold_launches(label, traced, per_call):
    """A traced replay's launches per wrapper (``trace_launches``) against
    ``per_call``, the wrappers' own counts of one call."""
    got = {k: traced.get(k, 0) for k in per_call}
    extra = {k: v for k, v in traced.items() if k not in per_call}
    log(f"  launches per wrapper in the traced replay: {got}")
    if got != per_call or extra:
        raise AssertionError(f"{label}: traced replay launches {got} (and {extra}), want "
                             f"{per_call}")


def profile_replay(label, call, pair_ms, per_call, **kw):
    """``profile_breakdown`` of a replayed call over ``TRACES`` traces or more
    (``traced``), its launches per wrapper held to ``per_call``."""
    prof = profile_breakdown(call, pair_ms, traces=TRACES, want=per_call, **kw)
    if prof is None:
        raise AssertionError(f"{label}: the trace recorded no device time, so the replay's "
                             "launches cannot be counted")
    hold_launches(label, prof[2], per_call)
    return prof


def profile_breakdown(call, pair_ms, top=12, what="match_pair", attribute=False, traces=1,
                      want=None):
    """Device time by kernel over one profiled call (a match_pair, see
    ``profiled``; the fullest of ``traces``, see ``traced``). The busy share is that device time (kernels and copies,
    overlap ignored) over ``pair_ms``, the unprofiled ms per call: the
    profiler's own overhead stretches the profiled call's wall time by a
    varying amount. With ``attribute``, also the host ops that launched the
    most device time, by input shapes, each with its innermost caller in the
    port. Returns (device busy ms, kernel ms, launches per wrapper as
    ``traced`` counts them), or None where no device time was recorded."""
    import torch
    from torch.autograd import DeviceType

    # stacks reach the op events only with the verbose experimental config
    config = dict(experimental_config=torch._C._profiler._ExperimentalConfig(verbose=True),
                  record_shapes=True, with_stack=True) if attribute else {}
    prof, launches = traced(call, traces, want, **config)
    # the schedule's step annotation spans the call: not device work
    rows = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
         and not e.key.startswith("ProfilerStep")),
        reverse=True,
    )
    if not rows:
        log("  profile: no device time recorded (device breakdown not measured)")
        return None
    busy = sum(r[0] for r in rows)
    # pageable copies wait on the host, so their device time varies from call to call
    copies = sum(r[0] for r in rows if r[2].startswith(("Memcpy", "Memset")))
    log(f"  profile of one {what}: device_busy_ms {busy:.3f} (kernels {busy - copies:.3f}, "
        f"copies {copies:.3f}), busy_share {busy / pair_ms:.3f} of the unprofiled {pair_ms:.3f} ms")
    for ms, count, key in rows[:top]:
        log(f"    {ms:8.3f} ms x{count:<4d} {key[:100]}")
    if not attribute:
        return busy, busy - copies, launches
    ops = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key, e.input_shapes, e.stack)
         for e in prof.key_averages(group_by_input_shape=True, group_by_stack_n=8)
         if e.device_type == DeviceType.CPU and e.self_device_time_total > 0
         and not e.key.startswith("ProfilerStep")),
        key=lambda r: r[0], reverse=True,
    )
    log(f"  ops behind the device time of one {what} (input shapes; innermost caller "
        "in the port):")
    for ms, count, key, shapes, stack in ops[:top]:
        caller = next((f for f in stack if "lightglue_tpu_torch" in f),
                      stack[0] if stack else "no stack recorded")
        log(f"    {ms:8.3f} ms x{count:<4d} {key} {shapes} <- {caller.split('src/')[-1]}")
    return busy, busy - copies, launches


def counted_extract(session, counters, img0, img1, label):
    """A fresh session's first session.extract of the pair (``first_call``):
    one SuperPoint forward's kernels a call (SP_LAUNCHES), nothing else."""
    import numpy as np

    ext, counts, launches = first_call(counters, lambda: session.extract(np.stack([img0, img1])))
    log(f"  launches in the {label} extraction's first call {counts}, per call {launches}")
    want = {k: SP_LAUNCHES.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"{label} extraction: launches {launches}, want {want}")
    return ext


def extract_profile(session, img0, img1, label):
    """ms per extraction of the pair (SuperPoint, NMS, top-k; median of 10
    synchronised calls) and one profiled call with the ops behind its device
    time: where SuperPoint's share of a match_pair goes."""
    import numpy as np
    import torch

    pair = np.stack([img0, img1])

    def call():
        out = session.extract(pair)
        torch.cuda.synchronize()
        return out

    call()
    times = []
    for _ in range(10):
        t = time.perf_counter()
        call()
        times.append((time.perf_counter() - t) * 1e3)
    ms = statistics.median(times)
    log(f"  extract {label}: ms per extraction of the pair median {ms:.3f} (10 repeats, min "
        f"{min(times):.3f})")
    profile_breakdown(call, ms, top=10, what=f"{label} extraction", attribute=True)


def adaptive_kernel_checks(ls, rand, freqs_for, dev, dtypes, fp32_scope, dec_ents):
    """adaptive_decide (x and heads in bf16 or fp32, and MIXED's fp32 x with
    bf16 heads), the keep-masked attention and the liveness operands
    against their plain versions at the adaptive path's shapes."""
    import torch

    e, n, heads = 256, BUCKET, 4
    i32 = dict(dtype=torch.int32, device=dev)
    log(f"adaptive_decide (per adaptive match_pair: one launch per layer, N={n})")
    gen = torch.Generator(device=dev).manual_seed(1)

    def prefix(lens):
        return [(torch.arange(n, device=dev)[None] < torch.tensor([x], **i32)).float()
                for x in lens]

    def run(fn, x0, x1, exit, keep, **kw):
        exit = exit.clone()
        keep = [k.clone() for k in keep] if keep else None
        fn(x0, x1, kw.pop("w_tok"), kw.pop("b_tok"), exit,
           keep0=keep and keep[0], keep1=keep and keep[1], **kw)
        return exit, keep

    # tag: (x dtype, heads dtype)
    variants = {**{tag: (dt, dt) for tag, dt in dtypes.items()},
                "mixed": (torch.float32, torch.bfloat16)}
    for tag, (dt, hdt) in variants.items():
        x0, x1 = rand(1, n, e, dtype=dt), rand(1, n, e, dtype=dt)
        zeros = torch.zeros(e, dtype=hdt, device=dev)
        spread = torch.randn(e, generator=gen, device=dev).to(hdt)
        w_match = ((torch.rand(e, generator=gen, device=dev) * 2 - 1) / 16).to(hdt)
        partly = prefix((n, n))  # keep state with ~30 % of the tokens retired
        for k in partly:
            k.mul_((torch.rand(k.shape, generator=gen, device=dev) > 0.3).float())
        exit1 = torch.full((1,), N_LAYERS + 1.0, device=dev)

        def bias(v):
            return torch.full((1,), v, device=dev)

        lens = dict(lengths0=torch.tensor([700], **i32), lengths1=torch.tensor([900], **i32))
        width = dict(w_match=w_match, b_match=bias(-50.0), width_confidence=0.99)
        cases = [
            # label, exit, keep, kwargs, exact
            ("masked 700/900 depth, bias +50", exit1, None,
             dict(w_tok=zeros, b_tok=bias(50.0), depth_confidence=0.95, **lens), True),
            ("unmasked depth, bias -50", exit1, None,
             dict(w_tok=zeros, b_tok=bias(-50.0), depth_confidence=0.95), True),
            ("width, partly retired, bias +50 (all retired)", exit1, partly,
             dict(w_tok=zeros, b_tok=bias(50.0), depth_confidence=2.0, **width), True),
            ("width, partly retired, bias -50 (all kept)", exit1, partly,
             dict(w_tok=zeros, b_tok=bias(-50.0), depth_confidence=0.95, **width), True),
            ("width, partly retired, random token head", exit1, partly,
             dict(w_tok=spread, b_tok=bias(0.0), depth_confidence=0.95, **width), False),
            ("masked depth, random token head", exit1, None,
             dict(w_tok=spread, b_tok=bias(0.0), depth_confidence=0.95, **lens), False),
        ]
        for label, exit, keep, kw, exact in cases:
            common = dict(layer=4, n_layers=N_LAYERS)
            with fp32_scope():
                got = run(ls.adaptive_decide, x0, x1, exit, keep, **common, **dict(kw))
                want = run(ls.adaptive_decide_plain, x0, x1, exit, keep, **common, **dict(kw))
            compare(f"{label} {tag} exit", got[0], want[0], 0, 0, exact=True)
            if keep is None:
                continue
            dec_ents[tag].err(max(float((g - w).abs().max()) for g, w in zip(got[1], want[1])))
            if exact:
                for i in (0, 1):
                    compare(f"{label} {tag} keep{i}", got[1][i], want[1][i], 0, 0, exact=True)
            else:
                flips = sum(int((g != w).sum()) for g, w in zip(got[1], want[1]))
                retired = sum(int((k - g).sum()) for k, g in zip(keep, got[1]))
                log(f"  {label} {tag}: keep boundary flips {flips} (at most 4), "
                    f"tokens retired at this layer {retired}")
                if flips > 4:
                    raise AssertionError(f"{label} {tag}: {flips} keep flips")
        # the last layer only forces the exit of live pairs; a retired pair stays
        ex2 = torch.tensor([N_LAYERS + 1.0, 3.0], device=dev)
        x0b, x1b = rand(2, n, e, dtype=dt), rand(2, n, e, dtype=dt)
        for fn, name in ((ls.adaptive_decide, "kernel"), (ls.adaptive_decide_plain, "plain")):
            got = run(fn, x0b, x1b, ex2, None, w_tok=spread, b_tok=bias(0.0),
                      layer=N_LAYERS - 1, n_layers=N_LAYERS, depth_confidence=0.95)[0]
            compare(f"last layer, B=2 one retired, {name} {tag} exit", got,
                    torch.tensor([float(N_LAYERS), 3.0], device=dev), 0, 0, exact=True)
        # timed at the adaptive main path's call: width, 1024/1024, all kept
        full_keep = prefix((n, n))
        kw = dict(w_tok=spread, b_tok=bias(0.0), depth_confidence=0.95, **width)

        def call(fn, layer, copies=False):
            """One decision on state that persists from call to call: the
            pair never stops at depth 0.95 here, and after the first call
            the keep masks hold, so every call reads the same rows and
            writes the same flags. ``copies``: on fresh copies of the state
            each call (three more launches), as the one-block design's
            time was taken."""
            state = [exit1.clone(), full_keep[0].clone(), full_keep[1].clone()]

            def run():
                ex, k0, k1 = [t.clone() for t in state] if copies else state
                fn(x0, x1, kw["w_tok"], kw["b_tok"], ex, layer=layer, n_layers=N_LAYERS,
                   depth_confidence=0.95, w_match=w_match, b_match=kw["b_match"],
                   width_confidence=0.99, keep0=k0, keep1=k1)
            return run

        plan = ls.decide_plan(1, n, n, e, x0.element_size())
        log(f"  decide_plan at B=1, {n}x{n} {tag}: {plan.blocks} blocks of {plan.rows} rows")
        for label, layer, weight in (("mid layer", 4, N_LAYERS - 1), ("last layer", N_LAYERS - 1, 1)):
            ms = cuda_ms(call(ls.adaptive_decide, layer))
            plain = cuda_ms(call(ls.adaptive_decide_plain, layer))
            log(f"  {label} {tag}: on fresh copies of the state (+3 copy launches a call): "
                f"kernel_ms {cuda_ms(call(ls.adaptive_decide, layer, copies=True)):.4f}")
            last = layer == N_LAYERS - 1
            xb = x0.element_size()
            wb = w_match.element_size()
            nbytes = 4 if last else xb * 2 * n * e + wb * 2 * e + 4 * 2 * (2 * n) + 8 + 4
            ops = 0 if last else 2 * 2 * (2 * n) * e
            # library: none, no single PyTorch call computes the decision
            dec_ents[tag].add(f"{label} width 1024x1024 {tag}", weight, ms, plain, None, nbytes,
                              ops, FP32_OP_PER_MS)

    log(f"keep-masked attention and liveness operands (N={n})")
    hd = 64
    for tag, dt in dtypes.items():
        qkv = rand(1, n, 3 * e, dtype=dt)
        q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
        f = freqs_for(1, n)
        kq, kk = prefix((900, 1000))
        kq.mul_((torch.rand(kq.shape, generator=gen, device=dev) > 0.3).float())
        kk.mul_((torch.rand(kk.shape, generator=gen, device=dev) > 0.3).float())
        retired = torch.zeros_like(kk)
        with fp32_scope():
            for label, ff, keeps in (("self rope, keep", f, (kq, kq)), ("cross, keep", None, (kq, kk)),
                                     ("cross, other image retired", None, (kq, retired))):
                got = ls.attention(q, k, v, ff, None, None, heads, dt, keep_q=keeps[0],
                                   keep_kv=keeps[1])
                want = ls.attention_plain(q, k, v, ff, None, None, heads, dt, keep_q=keeps[0],
                                          keep_kv=keeps[1])
                compare(f"{label} {tag}", got, want, **TOL[tag])
                if keeps[1] is retired and float(got.float().abs().max()) != 0.0:
                    raise AssertionError(f"{label} {tag}: rows are not exactly 0")
            # a batch of 2 whose second pair retired at layer 3, at layer 5
            live = ls.Live(torch.tensor([N_LAYERS + 1.0, 3.0], device=dev), 5)
            a, r = rand(2, n, 2 * e, dtype=dt), rand(2, n, e, dtype=dt)
            w = (rand(2 * e, e) / math.sqrt(2 * e)).to(dt)
            b = (rand(e) / math.sqrt(2 * e)).to(dt)
            got = ls.linear(a, w, b, residual=r, live=live)
            compare(f"ffn2 +res, retired pair = residual, {tag}", got[1], r[1], 0, 0, exact=True)
            compare(f"ffn2 +res, live pair, {tag}", got[:1],
                    ls.linear_plain(a, w, b, None, r, live)[:1], **TOL[tag])
            compare(f"linear, live pair, {tag}", ls.linear(a, w, b, live=live)[:1],
                    ls.linear_plain(a, w, b)[:1], **TOL[tag])
            g, bb = (1 + 0.1 * rand(2 * e)).to(dt), (0.1 * rand(2 * e)).to(dt)
            compare(f"ln_gelu, live pair, {tag}", ls.ln_gelu(a, g, bb, live=live)[:1],
                    ls.ln_gelu_plain(a, g, bb)[:1], **TOL[tag])
            q2 = rand(2, n, e, dtype=dt)
            kv2 = rand(2, n, 2 * e, dtype=dt)
            l2 = torch.tensor([n, 700], **i32)
            compare(f"attention, live pair, {tag}",
                    ls.attention(q2, kv2[..., :e], kv2[..., e:], None, l2, l2, heads, dt,
                                 live=live)[:1],
                    ls.attention_plain(q2, kv2[..., :e], kv2[..., e:], None, l2, l2, heads,
                                       dt)[:1], **TOL[tag])
        if tag == "bf16":
            for label, ff, keeps in (("self rope, keep", f, (kq, kq)), ("cross, keep", None, (kq, kk))):
                ms = cuda_ms(lambda: ls.attention(q, k, v, ff, None, None, heads, dt,
                                                  keep_q=keeps[0], keep_kv=keeps[1]))
                log(f"  {label} bf16: kernel_ms {ms:.4f} (per call; the length-masked and "
                    f"unmasked calls are timed above)")


def decide_batch_checks(ls, dev):
    """adaptive_decide exact against its plain version (exit and keep) in
    its three operand modes at B = 1, 2 and 4 on 1024 x 772 rows (N0 !=
    N1, and 1796 rows a pair, not a multiple of a block's 8 or 16: the
    pair's last block takes a partial slice), with the first pair of each
    batch of two or more dead: masked depth near the confident share,
    width with pruning (every live pair loses tokens), width-only (depth
    2.0), a stop at this layer (no pruning then) and the last layer (the
    forced exit). Each case also runs twice from one captured CUDA graph,
    the state reset between replays: both replays give the plain version's
    result, which they cannot if a launch leaves the scratch's counters or
    tickets dirty. Its inputs come from a generator of its own, so the
    phases after it see the inputs they saw before it was added."""
    import torch

    e, n0, n1, layer = 256, 1024, 772, 4
    log(f"adaptive_decide, batches: B = 1, 2, 4, {n0}x{n1} rows, three modes, graph replay x2")
    gen = torch.Generator(device=dev).manual_seed(2)
    variants = {"fp32": (torch.float32, torch.float32), "bf16": (torch.bfloat16, torch.bfloat16),
                "mixed": (torch.float32, torch.bfloat16)}
    for tag, (dt, hdt) in variants.items():
        for bsz in (1, 2, 4):
            x0, x1 = (torch.randn(bsz, n, e, generator=gen, device=dev).to(dt) for n in (n0, n1))
            # logits ~ N(0, 1.6): a fifth of the tokens are confident
            w_tok = (torch.randn(e, generator=gen, device=dev) * 0.1).to(hdt)
            w_match = (torch.randn(e, generator=gen, device=dev) * 0.1).to(hdt)
            keep = [(torch.rand(bsz, k, generator=gen, device=dev) > 0.3).float()
                    for k in (n0, n1)]
            exit0 = torch.full((bsz,), N_LAYERS + 1.0, device=dev)
            if bsz > 1:
                exit0[0] = 3.0  # retired at layer 3: untouched
            lens = dict(lengths0=torch.randint(0, n0 + 1, (bsz,), generator=gen, device=dev,
                                               dtype=torch.int32),
                        lengths1=torch.randint(0, n1 + 1, (bsz,), generator=gen, device=dev,
                                               dtype=torch.int32))
            width = dict(w_match=w_match, b_match=torch.full((1,), -50.0, device=dev),
                         width_confidence=0.99)
            cases = [  # label, layer, depth_confidence, kwargs
                ("masked depth", layer, 0.18, lens),
                ("width, pruning", layer, 0.95, width),
                ("width-only", layer, 2.0, width),
                ("stop at this layer", layer, 0.0, width),
                ("last layer", N_LAYERS - 1, 0.95, width),
            ]
            for label, g, dc, kw in cases:
                has_keep = "w_match" in kw
                b_tok = torch.zeros(1, device=dev)
                args = dict(kw, layer=g, n_layers=N_LAYERS, depth_confidence=dc)
                st_exit = exit0.clone()
                st_keep = [k.clone() for k in keep] if has_keep else [None, None]

                def reset():
                    st_exit.copy_(exit0)
                    if has_keep:
                        for k, k_init in zip(st_keep, keep):
                            k.copy_(k_init)

                def call(fn=ls.adaptive_decide):
                    fn(x0, x1, w_tok, b_tok, st_exit, keep0=st_keep[0], keep1=st_keep[1], **args)

                def state():
                    return [st_exit.clone()] + ([k.clone() for k in st_keep] if has_keep else [])

                call(ls.adaptive_decide_plain)
                want = state()
                reset()
                call()
                runs = {"eager": state()}
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    call()
                for i in range(2):
                    reset()
                    graph.replay()
                    torch.cuda.synchronize()
                    runs[f"graph replay {i + 1}"] = state()
                del graph
                for run, got in runs.items():
                    for name, gt, wt in zip(("exit", "keep0", "keep1"), got, want):
                        compare(f"B={bsz} {label} {tag} {run} {name}", gt, wt, 0, 0, exact=True)
                retired = sum(int((k - w).sum()) for k, w in zip(keep, want[1:])) if has_keep else 0
                log(f"  B={bsz} {label} {tag}: exit {want[0].tolist()}, tokens retired {retired}")
                if label == "width, pruning" and retired == 0:
                    raise AssertionError(f"B={bsz} {label} {tag}: no token retired")
                if label == "stop at this layer" and (retired or want[0].tolist() != [
                        3.0 if (i == 0 and bsz > 1) else layer + 1.0 for i in range(bsz)]):
                    raise AssertionError(f"B={bsz} {label} {tag}: exit {want[0].tolist()}, "
                                         f"{retired} retired")


def adaptive_stack_checks(ls, weights, rand, freqs_for, dev, dtypes, fp32_scope):
    """transformer_stack_adaptive against its plain version at 9 layers,
    1x1024x1024, in the three weight setups of the adaptive end-to-end run,
    and a batch of two pairs that exit at different layers."""
    import numpy as np
    import torch

    from lightglue_tpu_torch.config import LightGlueConfig
    from lightglue_tpu_torch.models.lightglue import _compact, _slice

    e, n, heads, hd, L = 256, BUCKET, 4, 64, N_LAYERS
    log(f"transformer_stack_adaptive vs plain, L={L}, 1x{n}x{n}, depth 0.95 width 0.99")
    base = weights.init_lightglue(0, LightGlueConfig(n_layers=L))
    lens = (torch.tensor([n], dtype=torch.int32, device=dev),) * 2

    def keep_flips(got, want):
        return sum(int((g != w).sum()) for g, w in zip(got, want))

    def check(label, tag, got, want, d_ref=None):
        """exit exact; keep flips counted; d' at STACK_TOL on the rows that
        both keep (a flipped token is masked out of one side's attention)."""
        compare(f"{label} {tag} exit", got[2], want[2], 0, 0, exact=True)
        flips = keep_flips(got[3:], want[3:])
        log(f"  {label} {tag}: exit {got[2].tolist()}, kept {[int(k.sum()) for k in got[3:]]}, "
            f"keep flips vs plain {flips}")
        for i in (0, 1):
            both = (got[3 + i] > 0.5) & (want[3 + i] > 0.5)
            compare(f"{label} {tag} d{i} (kept rows)", got[i][both], want[i][both],
                    **STACK_TOL[tag])
            if d_ref is not None:
                compare(f"{label} {tag} d{i} vs fixed-depth kernel stack", got[i], d_ref[i],
                        **STACK_TOL[tag])
        return flips

    for tag, dt in dtypes.items():
        d0, d1 = rand(1, n, e, dtype=dt), rand(1, n, e, dtype=dt)
        f0, f1 = freqs_for(1, n), freqs_for(1, n)
        kw = dict(num_heads=heads, head_dim=hd, stat_dtype=dt, attn_dtype=dt,
                  depth_confidence=0.95, width_confidence=0.99)
        for label, tree in (("random weights", base),
                            ("exit-3 weights", pinned_exit_weights(base, 3))):
            p = weights.params_from_numpy(tree, dev, dt)
            args = (p["layers"], p["token"], d0, d1, f0, f1, *lens, p["assign"]["match"])
            with fp32_scope():
                got = ls.transformer_stack_adaptive(*args, **kw)
                want = ls.transformer_stack_adaptive_plain(*args, **kw)
                ref = None
                if tree is base:  # nothing exits or is pruned: the fixed-depth stack
                    ref = ls.transformer_stack(p["layers"], d0, d1, f0, f1, *lens,
                                               **{k: kw[k] for k in list(kw)[:4]})
                flips = check(label, tag, got, want, ref)
            expect = L if tree is base else 3
            if int(got[2][0]) != expect or flips or int(got[3].sum() + got[4].sum()) != 2 * n:
                raise AssertionError(f"{label} {tag}: exit {got[2].tolist()} (want {expect}), "
                                     f"{flips} flips, or a token was pruned")
            if tag == "bf16":
                def stack():
                    return ls.transformer_stack_adaptive(*args, **kw)

                log(f"  {label} bf16: stack kernel_ms {cuda_ms(stack, inner=2):.4f} "
                    f"(eager: {eager_ms(stack):.4f})")
        # a batch of 2 whose pairs exit at layers 1 and 9: descriptors along
        # (against) a token head on feature 0, depth only, masked
        tree = dict(base, token=dict(
            w=np.tile(np.eye(e, 1, dtype=np.float32)[None], (L - 1, 1, 1)),
            b=np.zeros((L - 1, 1), np.float32)))
        p = weights.params_from_numpy(tree, dev, dt)
        x0, x1 = rand(2, n, e, dtype=dt), rand(2, n, e, dtype=dt)
        for x in (x0, x1):
            x[0, :, 0], x[1, :, 0] = 100.0, -100.0
        lens2 = (torch.tensor([n, 900], dtype=torch.int32, device=dev),) * 2
        args = (p["layers"], p["token"], x0, x1, freqs_for(2, n), freqs_for(2, n), *lens2)
        dkw = dict(kw, width_confidence=-1.0)
        with fp32_scope():
            got = ls.transformer_stack_adaptive(*args, **dkw)
            want = ls.transformer_stack_adaptive_plain(*args, **dkw)
        compare(f"B=2 exits 1 and {L} {tag} exit", got[2], want[2], 0, 0, exact=True)
        if got[2].tolist() != [1, L]:
            raise AssertionError(f"B=2 {tag}: exits {got[2].tolist()}, want [1, {L}]")
        for i in (0, 1):
            compare(f"B=2 exits 1 and {L} {tag} d{i}", got[i], want[i], **STACK_TOL[tag])
        # pruning weights through the downshift at layer 4, phase by phase
        ds, half = 4, n // 2
        p = weights.params_from_numpy(prune_weights(base), dev, dt)
        tok, match = p["token"], p["assign"]["match"]
        pkw = dict(kw, total_layers=L)
        args1 = (_slice(p["layers"], 0, ds), _slice(tok, 0, ds), d0, d1, f0, f1, *lens,
                 _slice(match, 0, ds))
        with fp32_scope():
            got1 = ls.transformer_stack_adaptive(*args1, **pkw)
            want1 = ls.transformer_stack_adaptive_plain(*args1, **pkw)
            flips1 = check("prune phase 1 (layers 0-3)", tag, got1, want1)
        idx = torch.arange(n, dtype=torch.int32, device=dev)[None]
        nl0, (cd0, cf0, _) = _compact(got1[3] > 0.5, got1[0], f0, idx)
        nl1, (cd1, cf1, _) = _compact(got1[4] > 0.5, got1[1], f1, idx)
        fits = bool(((nl0 <= half) & (nl1 <= half)).all())
        log(f"  prune {tag}: survivors after layer {ds}: {int(nl0[0])}/{int(nl1[0])}, "
            f"phase 2 arm {half if fits else n}")
        if not fits:
            raise AssertionError(f"prune {tag}: the half-width arm was not taken")
        args2 = (_slice(p["layers"], ds, L), _slice(tok, ds, L - 1),
                 cd0[:, :half].contiguous(), cd1[:, :half].contiguous(),
                 cf0[:, :, :half], cf1[:, :, :half], nl0, nl1, _slice(match, ds, L), got1[2])
        with fp32_scope():
            got2 = ls.transformer_stack_adaptive(*args2, layer_offset=ds, **pkw)
            want2 = ls.transformer_stack_adaptive_plain(*args2, layer_offset=ds, **pkw)
            flips2 = check(f"prune phase 2 (layers {ds}-{L - 1}, width {half})", tag, got2, want2)
        if tag == "fp32" and flips1 + flips2 > 4:
            raise AssertionError(f"prune fp32: {flips1 + flips2} keep flips (at most 4)")


def adaptive_end_to_end(ls, counters, weights, img0, img1, dec_e):
    """match_pair at 480x640, BF16, 9 layers, depth 0.95 / width 0.99, in the
    three weight setups; the random-weights run is the adaptive main path
    whose launch counts the kernels line reports for adaptive_decide."""
    import numpy as np

    from lightglue_tpu_torch.config import LightGlueConfig, PipelineConfig
    from lightglue_tpu_torch.runtime.session import MatcherSession

    counters = counters + [ls.adaptive_decide]
    widths = []
    real = ls.transformer_stack_adaptive

    def spy(layers, token, d0, *a, **kw):  # records each call's bucket
        widths.append(d0.shape[1])
        return real(layers, token, d0, *a, **kw)

    base = weights.init_lightglue(0, LightGlueConfig())
    setups = (("random weights", base, -1), ("exit-3 weights", pinned_exit_weights(base, 3), -1),
              ("prune weights, downshift 4", prune_weights(base), 4))
    for label, tree, ds in setups:
        cfg = PipelineConfig(lightglue=LightGlueConfig(depth_confidence=0.95,
                                                       width_confidence=0.99, downshift_layer=ds))
        log(f"MatcherSession(device='cuda').match_pair, adaptive, {label}, 480x640 BF16")
        session = MatcherSession(lg_params=tree, config=cfg, device="cuda")
        result, counts, launches = first_call(counters, lambda: session.match_pair(img0, img1))
        log(f"  launches in the first match_pair {counts}, per call {launches}")
        for name, count in launches.items():
            if count < 1:
                raise AssertionError(f"{label}: kernel {name} did not launch")
        bad = {k: (launches[k], v) for k, v in SP_LAUNCHES.items() if launches[k] != v}
        if bad:
            raise AssertionError(f"{label}: SuperPoint launches (got, want) {bad}")
        if label == "random weights":
            dec_e.d["launches"] = counts["adaptive_decide"]
        for key in ("scores", "match_scores", "keypoints0", "keypoints1"):
            if not np.isfinite(result[key]).all():
                raise AssertionError(f"{label}: match_pair output {key} is not finite")
        m = result["matches"]
        n0, n1 = result["num_keypoints0"], result["num_keypoints1"]
        if len(m) and (m.min() < 0 or m[:, 0].max() >= n0 or m[:, 1].max() >= n1):
            raise AssertionError(f"{label}: match indices outside the keypoints")
        ext = session.extract(np.stack([img0, img1]))
        widths.clear()
        ls.transformer_stack_adaptive = spy
        try:
            with eager_session(session):  # a graph's replay calls no Python
                out, _ = session.match_from_extractions(ext.slice(0, 1), ext.slice(1, 2))
        finally:
            ls.transformer_stack_adaptive = real
        times = []
        for _ in range(10):
            t = time.perf_counter()
            session.match_pair(img0, img1)
            times.append((time.perf_counter() - t) * 1e3)
        pair_ms = statistics.median(times)
        log(f"  keypoints {n0}/{n1} exit {int(out.exit_layer[0])} surviving "
            f"{int(out.lengths0[0])}/{int(out.lengths1[0])} stack buckets {widths} "
            f"matches {len(m)} ms_per_pair median {pair_ms:.3f} (10 repeats, min {min(times):.3f})")
        expect_exit = {"random weights": N_LAYERS, "exit-3 weights": 3}.get(label)
        if expect_exit is not None and int(out.exit_layer[0]) != expect_exit:
            raise AssertionError(f"{label}: exit {int(out.exit_layer[0])}, want {expect_exit}")
        # two phases where the bucket allows them, the second at half width
        # when every pair's survivors fit (the stack check above asserts that
        # arm on random descriptors)
        bk = [session.config.bucket_for(max(c, 1)) for c in (n0, n1)]
        if (ds > 0 and bk[0] == bk[1] and (bk[0] // 2) % 128 == 0
                and (len(widths) != 2 or widths[1] not in (bk[0], bk[0] // 2))):
            raise AssertionError(f"{label}: stack buckets {widths}, want two phases")
        profile_replay(label, lambda: session.match_pair(img0, img1), pair_ms, launches, top=8)


PB_BUCKET = 2048  # the 2048-keypoint config's cap bucket
PAD64 = 960       # the pad-to-64 config's cap bucket
# bidirectional_cross_attention's cases, in bf16 and fp32 (phase 3) and at
# MIXED (phase 6): label, B, N0, N1, lengths [n0, n1], per-pair launches,
# stats ("bf16": fp32 operands at bf16 stats only; None: the operands')
BIDIR_CASES = [
    ("960x960 unmasked", 1, PAD64, PAD64, None, N_LAYERS, None),
    ("960x960 ragged, n1 0", 2, PAD64, PAD64, [[900, 700], [960, 0]], 0, None),
    ("960x704 masked, n0 0", 2, PAD64, 704, [[950, 700], [0, 500]], 0, None),
    ("960x704 unmasked", 1, PAD64, 704, None, 0, None),
    ("960x64 masked (mixed buckets)", 1, PAD64, 64, [[955, 60]], 0, None),
    ("128x64 masked", 1, 128, 64, [[100, 50]], 0, None),
    ("200x80 unmasked (pad keys past Nk, 80 not on 64)", 1, 200, 80, None, 0, None),
    ("1280x1088 masked (past 1024 keys: s recomputed at bf16 stats)", 1, 1280, 1088,
     [[1250, 1000]], 0, None),
    ("960x704 masked, bf16 stats", 1, PAD64, 704, [[950, 650]], 0, "bf16"),
]


def bidir_yardsticks(ls, args, heads, stat_dtype, out_dtype=None, hd=64):
    """Two callables on the bidirectional kernel's operands (qk0, qk1, v0,
    v1: (B, N, H*64) column slices), each running both directions: two
    ``scaled_dot_product_attention`` calls (no one PyTorch call computes
    both; no masks), and two launches of the stack attention
    (``layer_stack.attention``, attention.cu's kernels on the same tile,
    direction 1 with ``dir1``)."""
    import torch.nn.functional as F

    def split(t):
        return t.reshape(t.shape[0], t.shape[1], heads, hd).transpose(1, 2)

    q0, q1, w0, w1 = (split(t) for t in args)
    sdpa = lambda: (F.scaled_dot_product_attention(q0, q1, w1),  # noqa: E731
                    F.scaled_dot_product_attention(q1, q0, w0))
    stack = lambda: (  # noqa: E731
        ls.attention(args[0], args[1], args[3], None, None, None, heads, stat_dtype, out_dtype),
        ls.attention(args[1], args[0], args[2], None, None, None, heads, stat_dtype, out_dtype,
                     dir1=True))
    return sdpa, stack


def pb_configs():
    """The per-block path's two configurations: upstream LightGlue's README
    setting (SuperPoint(max_num_keypoints=2048), the 128-step ladder plus a
    2048 bucket) and the reference's pad-to-64 bucketing with a 960 cap."""
    from lightglue_tpu_torch.config import PipelineConfig, SuperPointConfig

    return {
        "2048-keypoint": PipelineConfig(
            superpoint=SuperPointConfig(max_num_keypoints=PB_BUCKET),
            buckets=(256, 384, 512, 640, 768, 896, 1024, PB_BUCKET)),
        "pad-to-64": PipelineConfig(superpoint=SuperPointConfig(max_num_keypoints=PAD64),
                                    buckets=tuple(range(64, 1025, 64))),
    }


def attention_kernel_checks(at, rand, freqs_for, dev, dtypes, fp32_scope, fused_e, bidir_e,
                            flash_e, fp32_ents):
    """fused_mha, bidirectional_cross_attention and flash_attention against
    their plain versions at the per-block path's shapes, masked, ragged,
    with zero lengths and with several KV tiles; the calls of the main
    per-block runs are timed in bf16 and, for the FP32 rung, in fp32 (SDPA
    in fp32 with TF32 off beside them; the bidirectional kernel also beside
    two launches of the stack attention on the same operands)."""
    import torch
    import torch.nn.functional as F

    from lightglue_tpu_torch.kernels import layer_stack as ls

    e, heads, hd = 256, 4, 64
    i32 = dict(dtype=torch.int32, device=dev)

    def sdpa(q, k, v):  # library yardstick on (B, H, N, D) heads, no RoPE, no lengths
        def split(t):
            return t.reshape(t.shape[0], t.shape[1], heads, hd).transpose(1, 2)

        qh, kh, vh = split(q), split(k), split(v)
        return lambda: F.scaled_dot_product_attention(qh, kh, vh)

    def zero_rows(label, out, lens, kv_empty):
        """Rows past a length, and every row of an empty kv side, are 0."""
        for i, (ql, kl) in enumerate(lens):
            rows = out[i] if kl == 0 and kv_empty else out[i, ql:]
            if rows.numel() and float(rows.float().abs().max()) != 0.0:
                raise AssertionError(f"{label}: padded or empty-side rows are not exactly 0")

    log(f"fused_mha (per 2048-keypoint match_pair: 1 self + 2 cross launches per layer "
        f"x {N_LAYERS} layers)")
    fused_cases = [
        # label, B, Nq, Nk, rope, lengths, block_k, per-pair launches, stats
        # (None: the operands' dtype; fp32: bf16 operands with fp32 stats only)
        ("self rope 2x2048", 2, PB_BUCKET, PB_BUCKET, True, None, 1024, N_LAYERS, None),
        ("cross 2048x2048", 1, PB_BUCKET, PB_BUCKET, False, None, 1024, 2 * N_LAYERS, None),
        ("self rope 2x2048 ragged, kv_len 0", 2, PB_BUCKET, PB_BUCKET, True,
         [[2000, 1500], [700, 0]], 1024, 0, None),
        ("self rope 2x2048 ragged, kv_len 0, fp32 stats", 2, PB_BUCKET, PB_BUCKET, True,
         [[2000, 1500], [700, 0]], 1024, 0, "fp32"),
        ("cross 2048x1024 masked", 1, PB_BUCKET, 1024, False, [[2000, 1000]], 1024, 0, None),
        ("cross 1024x2048 masked", 1, 1024, PB_BUCKET, False, [[1000, 2000]], 1024, 0, None),
        ("self rope 2x1024 block_k 64, q_len 0", 2, 1024, 1024, True, [[1000, 900], [0, 1024]],
         64, 0, None),
        ("self rope 2x1000 block_k 1000", 2, 1000, 1000, True, None, 1000, 0, None),
        ("self rope 2x960 (pad-to-64)", 2, PAD64, PAD64, True, None, 1024, 0, None),
    ]
    for label, b, nq, nk, rope, lens, block, weight, stats in fused_cases:
        for tag, dt in dtypes.items():
            if stats and tag != "bf16":
                continue
            sdt = torch.float32 if stats == "fp32" else dt
            if rope:  # q, k, v as column slices of one qkv projection
                qkv = rand(b, nq, 3 * e, dtype=dt)
                q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
                f = freqs_for(b, nq)
            else:
                q = rand(b, nq, e, dtype=dt)
                kv = rand(b, nk, 2 * e, dtype=dt)
                k, v = kv[..., :e], kv[..., e:]
                f = None
            ln = None if lens is None else torch.tensor(lens, **i32)
            kw = dict(num_heads=heads, stat_dtype=sdt, block_q=block, block_k=block)
            with fp32_scope():
                got = at.fused_mha(q, k, v, f, ln, **kw)
                want = at.fused_mha_plain(q, k, v, f, ln, **kw)
                err = compare(f"{label} {tag}", got, want, **TOL[tag])
                if tag == "bf16":
                    rounding_witness(f"{label} {tag}", got, want, fine_block(
                        lambda bk: at.fused_mha_plain(q, k, v, f, ln, **dict(kw, block_k=bk)),
                        block, nk))
            if lens is not None:
                zero_rows(f"{label} {tag}", got, lens, True)
            ent = fused_e if tag == "bf16" else fp32_ents["fused_mha"]
            ent.err(err)
            if stats or (not weight and ("pad-to-64" not in label or tag != "bf16")):
                continue
            with fp32_scope():  # fp32 SDPA with TF32 off
                ms = cuda_ms(lambda: at.fused_mha(q, k, v, f, ln, **kw))
                plain = cuda_ms(lambda: at.fused_mha_plain(q, k, v, f, ln, **kw))
                lib_ms = cuda_ms(sdpa(q, k, v))
            nbytes = (q.element_size() * (b * nq * e + 2 * b * nk * e + b * nq * e)
                      + (4 * b * 2 * nk * hd if rope else 0))
            flops = 4 * b * heads * nq * nk * hd
            if weight:  # library: scaled_dot_product_attention, which does no RoPE
                ent.add(f"{label} {tag}", weight, ms, plain, lib_ms, nbytes, flops,
                        BF16_FLOP_PER_MS if tag == "bf16" else TF32X3_OP_PER_MS)
            else:
                log(f"  {label} bf16: kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms "
                    f"{lib_ms:.4f} bound_ms {max(nbytes / HBM_BYTES_PER_MS, flops / BF16_FLOP_PER_MS):.4f}"
                    f" x{N_LAYERS} per pad-to-64 match_pair")

    log(f"bidirectional_cross_attention (per pad-to-64 match_pair: 1 launch per layer "
        f"x {N_LAYERS} layers)")
    for label, b, n0, n1, lens, weight, stats in BIDIR_CASES:
        for tag, dt in dtypes.items():
            if stats and tag != "fp32":
                continue
            a0, a1 = rand(b, n0, 2 * e, dtype=dt), rand(b, n1, 2 * e, dtype=dt)
            args = (a0[..., :e], a1[..., :e], a0[..., e:], a1[..., e:])  # [qk | v] slices
            ln = None if lens is None else torch.tensor(lens, **i32)
            kw = dict(num_heads=heads, stat_dtype=torch.bfloat16 if stats else dt)
            with fp32_scope():
                got = at.bidirectional_cross_attention(*args, ln, **kw)
                want = at.bidirectional_cross_attention_plain(*args, ln, **kw)
                errs = [compare(f"{label} {tag} o{i}", g, w, **TOL["bf16" if stats else tag])
                        for i, (g, w) in enumerate(zip(got, want))]
                if tag == "fp32" and weight:  # 3xTF32 against float64, one TF32 the wrong design
                    q0, q1, w0, w1 = (heads_of(x, heads) for x in args)
                    one = at.bidirectional_cross_attention_plain(*map(tf32_round, args), ln, **kw)
                    tf32_witness(f"{label} {tag}", torch.cat(got, 1),
                                 torch.cat([attention_f64(q0, q1, w1),
                                            attention_f64(q1, q0, w0)], 2).transpose(1, 2)
                                 .reshape(b, n0 + n1, e), torch.cat(one, 1))
                if tag == "bf16" and all(min(x) > 0 for x in lens or [[1, 1]]):
                    # per direction: (q, k, v) = (qk0, qk1, v1) and (qk1, qk0, v0)
                    len0, len1 = (None, None) if ln is None else (ln[:, 0], ln[:, 1])
                    for i, (q, k, v, lq, lk) in enumerate(
                            ((args[0], args[1], args[3], len0, len1),
                             (args[1], args[0], args[2], len1, len0))):
                        rounding_witness(f"{label} {tag} o{i}", got[i], want[i],
                                         stack_wrong_designs(q, k, v, None, lq, lk, heads))
            if lens is not None:
                zero_rows(f"{label} {tag} o0", got[0], lens, True)
                zero_rows(f"{label} {tag} o1", got[1], [x[::-1] for x in lens], True)
            if stats:  # not the FP32 rung's row: its error is logged above
                continue
            ent = bidir_e if tag == "bf16" else fp32_ents["bidirectional_cross_attention"]
            ent.err(max(errs))
            if not weight:
                continue
            two, stack = bidir_yardsticks(ls, args, heads, kw["stat_dtype"])
            with fp32_scope():  # fp32 SDPA with TF32 off
                ms = cuda_ms(lambda: at.bidirectional_cross_attention(*args, ln, **kw))
                plain = cuda_ms(lambda: at.bidirectional_cross_attention_plain(*args, ln, **kw))
                sdpa2 = cuda_ms(two)
                stack2 = cuda_ms(stack)
            log(f"  {label} {tag}: two scaled_dot_product_attention calls (one per direction, "
                f"not one call): {sdpa2:.4f} ms; two lg_attention launches (the stack's kernel, "
                f"one per direction): {stack2:.4f} ms; the bidirectional kernel {ms:.4f} ms")
            # per pad-to-64 match_pair, beside library_ms (null: no one call)
            ent.d["two_sdpa_ms"] = weight * sdpa2
            ent.d["two_attention_ms"] = weight * stack2
            nbytes = a0.element_size() * (2 * b * (n0 + n1) * e + b * (n0 + n1) * e)
            flops = 6 * b * heads * n0 * n1 * hd  # one S and two P.V products
            # library: none, no single PyTorch call computes both directions
            ent.add(f"{label} {tag}", weight, ms, plain, None, nbytes, flops,
                    BF16_FLOP_PER_MS if tag == "bf16" else TF32X3_OP_PER_MS)

    log("flash_attention (the generic (B, H, N, D) entry point; not on the matching path)")
    flash_cases = [
        # label, B, Nq, Nk, lengths, block_k, timed
        ("2x4x2048 unmasked", 2, PB_BUCKET, PB_BUCKET, None, 1024, True),
        ("2x4x2048 ragged, q_len 0", 2, PB_BUCKET, PB_BUCKET, [[2048, 1500], [0, 2048]], 1024,
         False),
        ("2x4x256x192 block_k 64, kv_len 0", 2, 256, 192, [[256, 100], [200, 0]], 64, False),
    ]
    for label, b, nq, nk, lens, block, timed in flash_cases:
        for tag, dt in dtypes.items():
            q = rand(b, heads, nq, hd, dtype=dt)
            k, v = rand(b, heads, nk, hd, dtype=dt), rand(b, heads, nk, hd, dtype=dt)
            ln = None if lens is None else torch.tensor(lens, **i32)
            kw = dict(stat_dtype=dt, block_q=block, block_k=block)
            with fp32_scope():
                got = at.flash_attention(q, k, v, ln, **kw)
                want = at.flash_attention_plain(q, k, v, ln, **kw)
                err = compare(f"{label} {tag}", got, want, **TOL[tag])
                if tag == "bf16":
                    rounding_witness(f"{label} {tag}", got, want, fine_block(
                        lambda bk: at.flash_attention_plain(q, k, v, ln, **dict(kw, block_k=bk)),
                        block, nk))
                elif timed:  # 3xTF32 against float64, one TF32 product the wrong design
                    tf32_witness(f"{label} {tag}", got, attention_f64(q, k, v, ln),
                                 at.flash_attention_plain(*map(tf32_round, (q, k, v)), ln, **kw))
            if lens is not None:
                zero_rows(f"{label} {tag}", got.transpose(1, 2), lens, True)
            ent = flash_e if tag == "bf16" else fp32_ents["flash_attention"]
            ent.err(err)
            if not timed:
                continue
            # the entry point's own path: one call, counted from 0
            for fn in (at.fused_mha, at.bidirectional_cross_attention, at.flash_attention):
                fn.launches = 0
            at.flash_attention(q, k, v, ln, **kw)
            ent.d["launches"] = at.flash_attention.launches
            log(f"  generic entry point, one {tag} call: flash_attention launches "
                f"{at.flash_attention.launches}")
            with fp32_scope():  # fp32 SDPA with TF32 off
                ms = cuda_ms(lambda: at.flash_attention(q, k, v, ln, **kw))
                plain = cuda_ms(lambda: at.flash_attention_plain(q, k, v, ln, **kw))
                lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            nbytes = q.element_size() * (2 * b * heads * nq * hd + 2 * b * heads * nk * hd)
            flops = 4 * b * heads * nq * nk * hd
            ent.add(f"{label} {tag}", 1, ms, plain, lib_ms, nbytes, flops,
                    BF16_FLOP_PER_MS if tag == "bf16" else TF32X3_OP_PER_MS)


def per_block_stack_checks(at, weights, rand, freqs_for, dev, dtypes, fp32_scope):
    """The per-block route at 9 layers (``transformer_layers``) on the
    kernels against the same loop on their plain versions."""
    import torch

    from lightglue_tpu_torch.config import LightGlueConfig
    from lightglue_tpu_torch.models.lightglue import transformer_layers
    from lightglue_tpu_torch.precision import Precision, policy_for

    e, heads = 256, 4
    log(f"per-block transformer_layers vs plain, L={N_LAYERS}")
    lg_np = weights.init_lightglue(0, LightGlueConfig(n_layers=N_LAYERS))
    cases = [
        ("1x2048x2048 unmasked", PB_BUCKET, PB_BUCKET, None),
        ("2048x1024 lengths 2000/1000", PB_BUCKET, 1024, (2000, 1000)),
        ("960x960 unmasked", PAD64, PAD64, None),
        ("960x704 lengths 900/600", PAD64, 704, (900, 600)),
    ]
    for tag, dt in dtypes.items():
        policy = policy_for(Precision.BF16 if tag == "bf16" else Precision.FP32)
        layers = weights.params_from_numpy(lg_np, dev, dt)["layers"]
        for label, n0, n1, lens in cases:
            d0, d1 = rand(1, n0, e, dtype=dt), rand(1, n1, e, dtype=dt)
            f0, f1 = freqs_for(1, n0), freqs_for(1, n1)
            l0 = l1 = None
            if lens:
                l0 = torch.tensor([lens[0]], dtype=torch.int32, device=dev)
                l1 = torch.tensor([lens[1]], dtype=torch.int32, device=dev)

            def run(ops):
                return transformer_layers(layers, d0, d1, f0, f1, l0, l1, num_heads=heads,
                                          policy=policy, ops=ops)

            with fp32_scope():
                got, want = run(at.KERNEL_OPS), run(at.PLAIN_OPS)
                for i in (0, 1):
                    compare(f"per-block {label} {tag} d{i}", got[i], want[i], **STACK_TOL[tag])
            if tag == "bf16" and lens is None:
                log(f"  per-block {label} bf16: kernel_ms "
                    f"{cuda_ms(lambda: run(at.KERNEL_OPS), inner=1):.4f} (eager, launch overhead "
                    f"included: {eager_ms(lambda: run(at.KERNEL_OPS)):.4f}) plain_ms "
                    f"{cuda_ms(lambda: run(at.PLAIN_OPS), inner=1):.4f}")


def per_block_end_to_end(at, counters, img0, img1, fused_e, bidir_e):
    """match_pair in the per-block path's two configurations, with every
    kernel's launch count read from 0 around one call; then mixed buckets
    (2048x1024, 960x64) through match_from_extractions and a two-pair
    match_batch."""
    import numpy as np
    import torch

    from lightglue_tpu_torch.kernels import layer_stack as ls
    from lightglue_tpu_torch.runtime.session import MatcherSession

    counters = counters + [ls.adaptive_decide, at.fused_mha, at.bidirectional_cross_attention,
                           at.flash_attention]

    def expected(b0, b1):
        """Launches per forward of the routing in models/lightglue.py."""
        zero = dict(fused_mha=0, bidirectional_cross_attention=0)
        if ls.supports(None, b0, b1, torch.bfloat16):
            return zero
        self_calls = 1 if b0 == b1 else 2
        if max(b0, b1) <= 1024:
            return dict(fused_mha=self_calls * N_LAYERS, bidirectional_cross_attention=N_LAYERS)
        return dict(fused_mha=(self_calls + 2) * N_LAYERS, bidirectional_cross_attention=0)

    def check_launches(label, launches, b0, b1, extract):
        want = expected(b0, b1)
        want.update(linear=0, attention=0, ln_gelu=0, adaptive_decide=0, flash_attention=0)
        if want["fused_mha"] == 0:
            raise AssertionError(f"{label}: buckets {b0}x{b1} take the layer stack, not the "
                                 "per-block path")
        if extract:
            want.update(SP_LAUNCHES)
        bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
        if bad:
            raise AssertionError(f"{label}: launches (got, want) {bad}")

    for label, cfg in pb_configs().items():
        log(f"MatcherSession(device='cuda').match_pair, per-block, {label}, 480x640 BF16")
        session = MatcherSession(config=cfg, device="cuda")
        result, counts, launches = first_call(counters, lambda: session.match_pair(img0, img1))
        n0, n1 = result["num_keypoints0"], result["num_keypoints1"]
        bk = tuple(result["scores"].shape)
        log(f"  keypoints {n0}/{n1} buckets {bk[0]}x{bk[1]} matches {len(result['matches'])}")
        log(f"  launches in the first match_pair {counts}, per call {launches}")
        check_launches(label, launches, *bk, True)
        if label == "2048-keypoint":
            fused_e.d["launches"] = counts["fused_mha"]
        else:
            bidir_e.d["launches"] = counts["bidirectional_cross_attention"]
        for key in ("scores", "match_scores", "keypoints0", "keypoints1"):
            if not np.isfinite(result[key]).all():
                raise AssertionError(f"{label}: match_pair output {key} is not finite")
        m = result["matches"]
        if len(m) and (m.min() < 0 or m[:, 0].max() >= n0 or m[:, 1].max() >= n1):
            raise AssertionError(f"{label}: match indices outside the keypoints")
        times = []
        for _ in range(10):
            t = time.perf_counter()
            session.match_pair(img0, img1)
            times.append((time.perf_counter() - t) * 1e3)
        pair_ms = statistics.median(times)
        log(f"  ms_per_pair median {pair_ms:.3f} (10 repeats, min {min(times):.3f})")
        profile_replay(label, lambda: session.match_pair(img0, img1), pair_ms, launches, top=8)

        # mixed buckets: image 1 cut to a smaller bucket's count (a key not
        # captured yet)
        ext = session.extract(np.stack([img0, img1]))
        ext0, ext1 = ext.slice(0, 1), ext.slice(1, 2)
        cut = 1000 if label == "2048-keypoint" else 60
        ext1 = ext1._replace(count=torch.clamp(ext1.count, max=cut))
        (out, matches), counts, launches = first_call(
            counters, lambda: session.match_from_extractions(ext0, ext1))
        b0, b1 = out.scores.shape[1:]
        log(f"  mixed buckets {b0}x{b1}: launches in the first call {counts}, per call "
            f"{launches}, matches {int(matches.count[0])}")
        check_launches(f"{label} mixed", launches, b0, b1, False)
        if not torch.isfinite(out.scores).all():
            raise AssertionError(f"{label} mixed: scores not finite")
        batch = session.match_batch(np.stack([img0, img1]), np.stack([img1, img0]))
        log(f"  match_batch of 2 pairs: keypoints {[(r['num_keypoints0'], r['num_keypoints1']) for r in batch]}"
            f" matches {[len(r['matches']) for r in batch]}")
        for r in batch:
            if not np.isfinite(r["match_scores"]).all():
                raise AssertionError(f"{label}: match_batch scores not finite")


RING = 4                     # ring positions of the main ring run: stripes of 512
RING_N = PB_BUCKET           # its bucket
STEP_LAUNCHES = N_LAYERS * 4 * RING * RING  # 4 attentions per layer, ring^2 steps each


STEP_SEEDS = (0, 1, 2)  # the step phase's own generator: every case at each seed
STEP_ULPS = 2  # bf16-stats carries: flips of the reference's roundings (step_ulp_units)


def bf16_ulp(x):
    """The bf16 ulp at |x| (2^-8 at 0): 2^(floor(log2 |x|) - 7)."""
    import torch

    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - 8)


def step_ulp_units(at, q, k, v, m, l, acc, lengths, col0, stat_dtype, block_k):
    """Per element of (m', l', acc'), the sum over the plain step's tiles of
    one bf16 ulp of each rounding the reference makes on the way to it,
    taken on the plain step's own intermediates (``_merge_tiles``' taps):
    m' (a flip moves m' by its ulp); l' = quant(l c + sum p): c (which
    moves l c by about its ulp), p (sum p), l' itself, and m' (which moves c
    and every p by the factor e^ulp(m'), so l c + sum p by ulp(m') (l c +
    sum p)); acc' = quant(acc c + P.V) the same with |acc| c and |P| . |V|
    (a flip of p_j, or of s_j, moves P.V by a share of |p_j| |v_j|).
    A kernel whose fp32 sums run in another order may flip any of these
    roundings; an intermediate larger than the carry it feeds (acc c and
    P.V cancelling) makes that flip larger than the carry's own ulps, which
    a tolerance taken against the carry does not count."""
    taps = []
    q_len = kv_len = None
    if lengths is not None:
        q_len, kv_len = at._split_lengths(lengths, q.device)
    at._merge_tiles(q, k, v, m.float(), l.float(), acc.float(), kv_len, col0,
                    scale=1.0 / math.sqrt(q.shape[-1]), stat_dtype=stat_dtype, block_k=block_k,
                    taps=taps)
    um = sum(bf16_ulp(t["m"]) for t in taps)
    ul = sum(bf16_ulp(t["lc"]) + bf16_ulp(t["ps"]) + bf16_ulp(t["l"])
             + bf16_ulp(t["m"]) * (t["lc"] + t["ps"]) for t in taps)
    ua = sum(bf16_ulp(t["ac"]) + bf16_ulp(t["pv"]) + bf16_ulp(t["acc"])
             + bf16_ulp(t["m"]) * (t["ac"] + t["pv"]) for t in taps)
    return um, ul, ua


def step_kernel_checks(at, dev, fp32_scope, step_e, step_fp32_e):
    """flash_attention_step against its plain version at the ring path's
    shapes (B=1, H=4, 512-row stripes of a 2048 bucket): masked with the kv
    boundary inside the block, a block wholly past kv_len and a stripe past
    q_len (pass-through, exact), stripes of 128 rows of which some start
    past q_len, kv_len 0 from the first step's carries, 384-row blocks
    fitted to 192 (two tiles), 120-row stripes (a 960 bucket at ring 8, a
    tile that is not a multiple of 16), and unmasked; all three carries, in
    bf16 and fp32 operands with fp32 and bf16 stats, each case at the
    ``STEP_SEEDS`` of the phase's own generator. Carries with fp32 stats
    are held to ``TOL``; with bf16 stats each element to ``STEP_ULPS``
    units of ``step_ulp_units`` (the largest count seen is printed). The
    main path's calls (fp32 stats, full lengths) are timed: bf16 operands
    (the BF16 ring) and fp32 operands (the FP32 ring)."""
    import torch
    import torch.nn.functional as F

    heads, hd, n = 4, 64, RING_N // RING
    i32 = dict(dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)

    def rand(*shape, dtype=torch.float32, scale=1.0, uniform=False):
        f = torch.rand if uniform else torch.randn
        return (f(*shape, generator=gen, device=dev) * scale).to(dtype)

    log(f"flash_attention_step (per forward_ring: {STEP_LAUNCHES} launches = {N_LAYERS} layers x "
        f"4 attentions x {RING}^2 ring steps, B=1 H=4 stripes of {n}); seeds {STEP_SEEDS}")
    cases = [
        # label, n = nk, lengths, row0, col0, block cap, fresh carries, exact pass-through
        ("masked, kv boundary inside the block", n, [[RING_N, 1800]], n, 3 * n, 1024, False,
         False),
        ("block wholly past kv_len", n, [[RING_N, 1000]], n, 3 * n, 1024, False, True),
        ("stripe wholly past q_len", n, [[400, RING_N]], n, 0, 1024, False, True),
        ("128-row stripes, some past q_len", n, [[700, RING_N]], n, 2 * n, 128, False, False),
        ("kv_len 0, first step", n, [[RING_N, 0]], 0, 0, 1024, True, True),
        ("n=nk=384, blocks fitted to 192", 384, [[1000, 900]], 384, 768, 256, False, False),
        ("120-row stripes (960 keypoints at P = 8)", 120, [[960, 900]], 360, 840, 1024, False,
         False),
        ("unmasked", n, None, 0, n, 1024, False, False),
    ]

    def finalised(carries):  # acc / l in bf16, as the ring finalises a row
        _, l, acc = carries
        return (acc / torch.where(l == 0.0, 1.0, l)).to(torch.bfloat16)

    operands = {"bf16": torch.bfloat16, "fp32": torch.float32}
    worst = {}  # operands -> (ulp count, its label)
    for seed in STEP_SEEDS:
        gen.manual_seed(seed)
        for label, size, lens, row0, col0, block, fresh, exact in cases:
            for otag, odt in operands.items():
                for stag, sdt in operands.items():
                    q, k, v = (rand(1, heads, size, hd, dtype=odt) for _ in range(3))
                    if fresh:
                        m = torch.full((1, heads, size, 1), -1e30, device=dev)
                        l, acc = torch.zeros_like(m), torch.zeros(1, heads, size, hd, device=dev)
                    else:
                        m = rand(1, heads, size, 1, scale=2.0)
                        l = 1.0 + rand(1, heads, size, 1, uniform=True) * 2
                        acc = rand(1, heads, size, hd)
                    ln = None if lens is None else torch.tensor(lens, **i32)
                    args = (q, k, v, m, l, acc, ln, row0, col0)
                    kw = dict(stat_dtype=sdt, block_q=block, block_k=block)
                    name = f"seed {seed} {label} {otag} operands {stag} stats"
                    with fp32_scope():
                        got = at.flash_attention_step(*args, **kw)
                        want = at.flash_attention_step_plain(*args, **kw)
                        if stag == "fp32":
                            tag = "fp32" if otag == "fp32" else "bf16"
                            errs = [compare(f"{name} {c}", g, w, **TOL[tag])
                                    for c, g, w in zip(("m", "l", "acc"), got, want)]
                        else:
                            units = step_ulp_units(at, q, k, v, m, l, acc, ln, col0, sdt,
                                                   at._fit_block(size, block))
                            errs, counts = [], []
                            for c, g, w, u in zip(("m", "l", "acc"), got, want, units):
                                err = (g - w).abs()
                                count = float((err / u).max())
                                errs.append(float(err.max()))
                                counts.append(count)
                                if not (torch.isfinite(g).all() and count <= STEP_ULPS):
                                    raise AssertionError(
                                        f"{name} {c}: {count:.3f} units of its rounded "
                                        f"intermediates' ulps (at most {STEP_ULPS}), max abs err "
                                        f"{errs[-1]:.3e}")
                            log(f"  {name}: max abs err m {errs[0]:.3e} l {errs[1]:.3e} acc "
                                f"{errs[2]:.3e}; ulp units m {counts[0]:.3f} l {counts[1]:.3f} "
                                f"acc {counts[2]:.3f} (at most {STEP_ULPS})")
                            if max(counts) > worst.get(otag, (-1.0, ""))[0]:
                                worst[otag] = (max(counts), name)
                        if otag == "bf16":  # the witness on the finalised rows
                            rounding_witness(
                                f"{name}, acc / l", finalised(got), finalised(want),
                                fine_block(lambda bk: finalised(
                                    at.flash_attention_step_plain(*args, **dict(kw, block_k=bk))),
                                    at._fit_block(size, block), size))
                    if exact:
                        for c, g, w in zip(("m", "l", "acc"), got, (m, l, acc)):
                            compare(f"{name} {c} passes through", g, w, 0, 0, exact=True)
                    if otag == "bf16":  # the BF16 ring's carries, either stats
                        step_e.err(max(errs))
                    elif stag == "fp32":  # the FP32 ring's
                        step_fp32_e.err(max(errs))
    for otag, (count, name) in worst.items():
        log(f"  bf16-stats carries, {otag} operands: largest count {count:.3f} ulp units "
            f"({name})")
    # timed: the main path's calls, fp32 stats, full lengths
    gen.manual_seed(len(STEP_SEEDS))
    for otag, odt in operands.items():
        q, k, v = (rand(1, heads, n, hd, dtype=odt) for _ in range(3))
        m, l = rand(1, heads, n, 1), 1.0 + rand(1, heads, n, 1, uniform=True)
        acc = rand(1, heads, n, hd)
        ln = torch.tensor([[RING_N, RING_N]], **i32)
        args = (q, k, v, m, l, acc, ln, n, 2 * n)
        with fp32_scope():
            ms = cuda_ms(lambda: at.flash_attention_step(*args))
            plain = cuda_ms(lambda: at.flash_attention_step_plain(*args))
            sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        log(f"  scaled_dot_product_attention on the same 512x512 {otag} block (context; it "
            f"merges no carries): {sdpa:.4f} ms")
        # each operand read once; the three fp32 carries read and written once
        nbytes = q.element_size() * 3 * heads * n * hd + 4 * 2 * (2 * heads * n + heads * n * hd)
        flops = 4 * heads * n * n * hd
        # library: none, no single PyTorch call merges a block into carries
        ent = step_e if otag == "bf16" else step_fp32_e
        ent.add(f"step 1x4x{n}x{n} {otag}, fp32 stats", STEP_LAUNCHES, ms, plain, None, nbytes,
                flops, BF16_FLOP_PER_MS if otag == "bf16" else TF32X3_OP_PER_MS,
                per="forward_ring")


def ring_checks(at, ring, rand, dev, dtypes, fp32_scope):
    """ring_attention on [cuda:0] * P for P in 2, 4, 8 against
    reference_attention and against the same ring on the plain step:
    unmasked, masked, and a zero-length kv side."""
    import torch

    heads, hd, nsz = 4, 64, RING_N
    i32 = dict(dtype=torch.int32, device=dev)
    log(f"ring_attention on [cuda:0] x P, (2, {heads}, {nsz}, {hd})")
    cases = [("unmasked", None), ("masked", [[2000, 1500], [700, 1900]]),
             ("zero-length kv", [[nsz, 0], [100, 50]])]
    for size in (2, 4, 8):
        devices = [dev] * size
        for label, lens in cases:
            for tag, dt in dtypes.items():
                q, k, v = (rand(2, heads, nsz, hd, dtype=dt) for _ in range(3))
                ln = None if lens is None else torch.tensor(lens, **i32)
                with fp32_scope():
                    got = ring.ring_attention(q, k, v, ln, devices=devices)
                    plain = ring.ring_attention(q, k, v, ln, devices=devices,
                                                step=at.flash_attention_step_plain)
                    ref = at.reference_attention(q, k, v, ln)
                compare(f"P={size} {label} {tag} vs plain step", got, plain, **TOL[tag])
                live = [i for i in range(2) if lens is None or lens[i][1] > 0]
                compare(f"P={size} {label} {tag} vs reference_attention", got[live], ref[live],
                        **TOL[tag])
                for i, (ql, kl) in enumerate(lens or []):
                    rows = got[i] if kl == 0 else got[i, :, ql:]
                    if rows.numel() and float(rows.float().abs().max()) != 0.0:
                        raise AssertionError(f"P={size} {label} {tag}: padded rows are not 0")


def ring_end_to_end(at, counters, img0, img1, step_e, step_fp32_e):
    """forward_ring at full width on the 2048-keypoint extractions of the
    480x640 pair, devices [cuda:0] * 4 (stripes of 512), 9 layers, then
    filter_matches. BF16: launch counts read from 0 around one call,
    against the same loop on the plain step, graph and eager times. FP32:
    against forward (the per-block route) and its match set at threshold 0.
    Returns each rung's inputs to the ring as host arrays with their dtype
    names, for ``ring_process_checks``."""
    import dataclasses

    import numpy as np
    import torch

    from lightglue_tpu_torch.kernels import layer_stack as ls
    from lightglue_tpu_torch.models.lightglue import forward, forward_ring
    from lightglue_tpu_torch.pipeline.match import filter_matches
    from lightglue_tpu_torch.precision import Precision
    from lightglue_tpu_torch.runtime.session import MatcherSession

    counters = counters + [ls.adaptive_decide, at.fused_mha, at.bidirectional_cross_attention,
                           at.flash_attention, at.flash_attention_step]
    devices = [torch.device("cuda", 0)] * RING
    cfg = pb_configs()["2048-keypoint"]
    lgc = cfg.lightglue

    def match_set(scores):
        """Mutual nearest neighbours of the log assignment: the match set at
        threshold 0 (filter_matches' exp of these random-weight
        log-probabilities underflows fp32 for all but a few)."""
        m0, m1 = scores[0].argmax(1), scores[0].argmax(0)
        rows = torch.nonzero(m1[m0] == torch.arange(RING_N, device=scores.device))[:, 0]
        return set(zip(rows.tolist(), m0[rows].tolist()))

    def argmax_agreement(a, b):
        """Share of image-0 keypoints whose best image-1 column is the same,
        and how many distinct columns each side's row argmax falls on."""
        ra, rb = a[0].argmax(1), b[0].argmax(1)
        return (f"row argmax agreement {float((ra == rb).float().mean()):.4f} (on "
                f"{ra.unique().numel()} / {rb.unique().numel()} distinct columns)")

    model_inputs = {}  # per rung: the forward_ring inputs as (host array, dtype name)
    for precision in ("bf16", "fp32"):
        session = MatcherSession(config=dataclasses.replace(cfg, precision=Precision(precision)),
                                 device="cuda")
        ext = counted_extract(session, counters, img0, img1, f"ring {precision}")
        ext0, ext1 = ext.slice(0, 1), ext.slice(1, 2)
        n0, n1 = int(ext0.count[0]), int(ext1.count[0])
        if min(n0, n1) < RING_N:
            raise AssertionError(f"ring: keypoints {n0}/{n1}, want both at {RING_N}")
        inputs = (ext0.keypoints_norm[:, :RING_N], ext1.keypoints_norm[:, :RING_N],
                  ext0.descriptors[:, :RING_N], ext1.descriptors[:, :RING_N],
                  torch.clamp(ext0.count, max=RING_N), torch.clamp(ext1.count, max=RING_N))
        kw = dict(config=lgc, policy=session.policy)
        model_inputs[precision] = [(t.float().cpu().numpy() if t.is_floating_point()
                                    else t.cpu().numpy(), str(t.dtype).split(".")[1])
                                   for t in inputs]

        def ring_call(step=at.flash_attention_step):
            with torch.inference_mode():
                return forward_ring(session.lg_params, *inputs, devices=devices, step=step, **kw)

        log(f"forward_ring, {precision.upper()}, {RING_N}x{RING_N} on [cuda:0] x {RING}, "
            f"{lgc.n_layers} layers, E={lgc.descriptor_dim}, H={lgc.num_heads}")
        ring_call()  # warm
        for fn in counters:
            fn.launches = 0
        out = ring_call()
        launches = {fn.__name__: fn.launches for fn in counters}
        log(f"  launches in one forward_ring: {launches}")
        bad = {k: v for k, v in launches.items()
               if v != (STEP_LAUNCHES if k == "flash_attention_step" else 0)}
        if bad:
            raise AssertionError(f"forward_ring {precision}: launches {bad} (want "
                                 f"flash_attention_step {STEP_LAUNCHES}, every other kernel 0)")
        if out.scores.shape != (1, RING_N, RING_N) or not torch.isfinite(out.scores).all():
            raise AssertionError(f"forward_ring {precision}: scores {tuple(out.scores.shape)} "
                                 "or not finite")
        matches = filter_matches(out.scores, threshold=cfg.match_threshold,
                                 max_matches=min(cfg.max_matches, RING_N))
        idx = matches.indices[0, :int(matches.count[0])]
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= RING_N):
            raise AssertionError("forward_ring: match indices outside the keypoints")
        log(f"  keypoints {n0}/{n1}, matches at threshold {cfg.match_threshold}: "
            f"{int(matches.count[0])}")
        step_ent = step_e if precision == "bf16" else step_fp32_e
        step_ent.d["launches"] = launches["flash_attention_step"]
        if precision == "bf16":
            plain = ring_call(at.flash_attention_step_plain)
            for i, (g, w) in enumerate(((out.desc0, plain.desc0), (out.desc1, plain.desc1))):
                compare(f"forward_ring bf16 d{i} vs the plain step", g, w, **STACK_TOL["bf16"])
            serr = float((out.scores - plain.scores).abs().max())
            mg, mp = match_set(out.scores), match_set(plain.scores)
            log(f"  scores vs the plain step: max_abs_err {serr:.3e}; mutual nearest "
                f"neighbours {len(mg)} / {len(mp)}, IoU {len(mg & mp) / max(1, len(mg | mp)):.4f}; "
                f"{argmax_agreement(out.scores, plain.scores)}")
            graph = cuda_ms(ring_call, reps=5, inner=1)
            eager = eager_ms(ring_call, reps=5)
            log(f"  forward_ring bf16: ms per call {graph:.3f} as a graph, {eager:.3f} eager "
                f"(5 repeats each, median)")
            profile_breakdown(ring_call, eager, top=8, what="forward_ring")
        else:
            with torch.inference_mode():
                ref = forward(session.lg_params, *inputs, **kw)
            for i, (g, w) in enumerate(((out.desc0, ref.desc0), (out.desc1, ref.desc1))):
                compare(f"forward_ring fp32 d{i} vs forward", g, w, **STACK_TOL["fp32"])
            compare("forward_ring fp32 scores vs forward", out.scores, ref.scores,
                    **STACK_TOL["fp32"])
            mg, mr = match_set(out.scores), match_set(ref.scores)
            iou = len(mg & mr) / max(1, len(mg | mr))
            log(f"  fp32 match sets at threshold 0 (mutual nearest neighbours), forward_ring "
                f"vs forward: {len(mg)} / {len(mr)}, IoU {iou:.4f} (needs > 0.95); "
                f"{argmax_agreement(out.scores, ref.scores)}")
            if not mr or iou <= 0.95:
                raise AssertionError(f"forward_ring fp32: match-set IoU {iou:.4f}")
    return model_inputs


# ---- the ring across processes: ranks sharing cuda:0 in a gloo group ------

RING_PROC_SIZES = (2, RING)  # ring_attention at both; forward_ring at RING
RING_PROC_SEED = 23  # the ranks' own generator: the cases' inputs, alike on every rank
RING_PROC_TIMEOUT_S = 120  # a rank waiting longer for a block or a collective raises
RING_PROC_REPS = 10
RING_PROC_CASES = (  # label, GLOBAL lengths at RING_N or None
    ("unmasked", None),
    ("masked, kv boundary inside a stripe", [[2000, 1500], [1900, 1100]]),
    ("stripes wholly past q_len", [[700, RING_N], [300, 1700]]),
    ("zero-length kv", [[RING_N, 0], [100, 50]]),
)


def ring_rank(rank, port, size, model_inputs, queue):
    """One of ``size`` ranks spawned on cuda:0 by ``ring_process_checks``, in
    a gloo group (NCCL refuses two ranks on one card; the blocks cross in
    pinned host memory): ``ring_process_attention``, then, where
    ``model_inputs`` are given, ``ring_process_forward``. Puts (rank,
    traceback or None, readings)."""
    import traceback

    try:
        import datetime

        import torch
        import torch.distributed as dist

        from lightglue_tpu_torch.parallel import multihost

        # one host thread for torch's CPU ops, as torchrun gives each of
        # several ranks on a node: the ranks' default thread pools would
        # share the host's cores and stall each other (scripts/tune_torch_ring.py)
        torch.set_num_threads(1)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        multihost.initialize(f"localhost:{port}", size, rank, backend="gloo",
                             timeout=datetime.timedelta(seconds=RING_PROC_TIMEOUT_S))
        out = {"ring_attention": ring_process_attention(rank, size, dev)}
        if model_inputs is not None:
            out["forward_ring"] = ring_process_forward(rank, size, dev, model_inputs)
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, None, out))
    except Exception:
        queue.put((rank, traceback.format_exc(), None))


def ring_process_attention(rank, size, dev):
    """``ring_attention(..., group=)`` on this rank's stripe at (2, 4, RING_N,
    64), bf16 and fp32, every case of ``RING_PROC_CASES``: bit for bit the
    same rows of the one-process ring on [cuda:0] * size, within ``TOL`` of
    the same process ring on the plain step, padded rows 0, one step launch
    per position. Returns the largest error against the plain step per
    dtype."""
    import torch

    from lightglue_tpu_torch.kernels import attention as at
    from lightglue_tpu_torch.parallel import ring
    from lightglue_tpu_torch.precision import Precision, policy_for, precision_scope

    group = torch.distributed.group.WORLD
    gen = torch.Generator(device=dev).manual_seed(RING_PROC_SEED)
    n = RING_N // size
    rows = slice(rank * n, (rank + 1) * n)
    errs = {}
    for label, lens in RING_PROC_CASES:
        for tag, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            q, k, v = (torch.randn(2, 4, RING_N, 64, generator=gen, device=dev).to(dt)
                       for _ in range(3))
            ln = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
            mine = [t[:, :, rows] for t in (q, k, v)]
            with precision_scope(policy_for(Precision.FP32)):  # the plain fp32 step in fp32
                before = at.flash_attention_step.launches
                got = ring.ring_attention(*mine, ln, group=group)
                launched = at.flash_attention_step.launches - before
                one = ring.ring_attention(q, k, v, ln, devices=[dev] * size)[:, :, rows]
                plain = ring.ring_attention(*mine, ln, group=group,
                                            step=at.flash_attention_step_plain)
            where = f"rank {rank} of {size}, {label} {tag}"
            if launched != size:
                raise AssertionError(f"{where}: {launched} step launches, want {size}")
            if not torch.equal(got, one):
                diff = int((got != one).sum())
                raise AssertionError(f"{where}: {diff} elements differ from the one-process ring")
            g, w = got.float(), plain.float()
            err = (g - w).abs()
            if not torch.isfinite(g).all() or bool((err > TOL[tag]["atol"]
                                                     + TOL[tag]["rtol"] * w.abs()).any()):
                raise AssertionError(f"{where}: max abs err {float(err.max()):.3e} vs the plain "
                                     f"step, beyond {TOL[tag]}")
            errs[tag] = max(errs.get(tag, 0.0), float(err.max()))
            for i, (ql, kl) in enumerate(lens or []):
                pad = got[i] if kl == 0 else got[i, :, max(ql - rank * n, 0):]
                if pad.numel() and float(pad.float().abs().max()) != 0.0:
                    raise AssertionError(f"{where}: padded rows are not 0")
    return dict(cases=2 * len(RING_PROC_CASES), bit_for_bit=2 * len(RING_PROC_CASES),
                max_abs_err_vs_plain=errs)


def ring_process_forward(rank, size, dev, model_inputs):
    """``forward_ring(..., group=)`` at full width (the 2048-keypoint config,
    9 layers) on ``ring_end_to_end``'s extractions, BF16 and FP32: this
    rank's launches in one call read from 0 (RING_N / size-row stripes:
    ``STEP_LAUNCHES / size`` steps, no other stack kernel), the whole output
    against the one-process ``forward_ring`` on [cuda:0] * size at
    ``ring_end_to_end``'s gates (descriptors at STACK_TOL, FP32 scores at
    1e-3) with the mutual-NN sets at threshold 0 equal and not empty
    (``mutual_matches``); then ms per call on each rank's host clock, each
    call between two barriers (median of ``RING_PROC_REPS`` after the warm
    call), the host ms inside the transport per call (staging the caller's
    block, the rest of the posts, the waits), on rank 0 the one-process
    eager ring's ms with the other ranks waiting, and the host P2P alone
    (``ring_process_p2p``)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from lightglue_tpu_torch.kernels import attention as at
    from lightglue_tpu_torch.kernels import conv as conv_k
    from lightglue_tpu_torch.kernels import layer_stack as ls
    from lightglue_tpu_torch.kernels import nms as nms_k
    from lightglue_tpu_torch.kernels import stem as stem_k
    from lightglue_tpu_torch.models.lightglue import forward_ring
    from lightglue_tpu_torch.parallel import ring
    from lightglue_tpu_torch.precision import Precision
    from lightglue_tpu_torch.runtime.session import MatcherSession

    group = dist.group.WORLD
    counters = [stem_k.relu_conv1a_shift, conv_k.conv3x3, nms_k.nms_candidates, ls.linear,
                ls.attention, ls.ln_gelu, ls.row_quant, ls.adaptive_decide, at.fused_mha,
                at.bidirectional_cross_attention, at.flash_attention, at.flash_attention_step]
    cfg = pb_configs()["2048-keypoint"]
    readings = {}
    for precision in ("bf16", "fp32"):
        gate = STACK_TOL[precision]
        session = MatcherSession(config=dataclasses.replace(cfg, precision=Precision(precision)),
                                 device="cuda")
        inputs = [torch.from_numpy(a).to(dev, getattr(torch, name))
                  for a, name in model_inputs[precision]]
        kw = dict(config=cfg.lightglue, policy=session.policy)

        def call():
            with torch.inference_mode():
                return forward_ring(session.lg_params, *inputs, group=group, **kw)

        def one_process():
            with torch.inference_mode():
                return forward_ring(session.lg_params, *inputs, devices=[dev] * size, **kw)

        where = f"rank {rank} of {size}, forward_ring {precision}"
        call()  # warm
        for fn in counters:
            fn.launches = 0
        out = call()
        launches = {fn.__name__: fn.launches for fn in counters}
        want = STEP_LAUNCHES // size
        bad = {k: v for k, v in launches.items()
               if v != (want if k == "flash_attention_step" else 0)}
        if bad:
            raise AssertionError(f"{where}: launches {bad} (want flash_attention_step {want}, "
                                 "every other kernel 0)")
        ref = one_process()
        errs = {}
        for name in ("desc0", "desc1", "scores"):
            g, w = getattr(out, name), getattr(ref, name)
            if g.shape != w.shape or g.dtype != w.dtype or not torch.isfinite(g.float()).all():
                raise AssertionError(f"{where}: {name} {tuple(g.shape)} {g.dtype}, want "
                                     f"{tuple(w.shape)} {w.dtype}, finite")
            err = (g.float() - w.float()).abs()
            errs[name] = float(err.max())
            if (name != "scores" or precision == "fp32") and bool(
                    (err > gate["atol"] + gate["rtol"] * w.float().abs()).any()):
                raise AssertionError(f"{where}: {name} max abs err {errs[name]:.3e} vs the "
                                     f"one-process ring, beyond {gate}")
        got_set, ref_set = (mutual_matches(x.scores, RING_N, RING_N) for x in (out, ref))
        if got_set != ref_set or not ref_set:
            raise AssertionError(f"{where}: mutual-NN set {sorted(got_set)}, the one-process "
                                 f"ring's {sorted(ref_set)}")
        times = []
        for key in ring.transport_time:
            ring.transport_time[key] = 0
        for _ in range(RING_PROC_REPS):
            dist.barrier()
            t = time.perf_counter()
            call()
            torch.cuda.synchronize()
            dist.barrier()
            times.append((time.perf_counter() - t) * 1e3)
        clock = dict(ring.transport_time)
        one_ms = None
        if rank == 0:  # the others wait at the barrier
            one_ms = host_ms(one_process, reps=RING_PROC_REPS)
        dist.barrier()
        per_call = {k: v * 1e3 / RING_PROC_REPS for k, v in clock.items() if k != "posts"}
        readings[precision] = dict(
            ms=statistics.median(times), ms_min=min(times), one_process_eager_ms=one_ms,
            transport_ms_per_call=per_call["post_s"] + per_call["wait_s"],
            stage_ms_per_call=per_call["stage_s"],
            post_ms_per_call=per_call["post_s"] - per_call["stage_s"],
            wait_ms_per_call=per_call["wait_s"], posts_per_call=clock["posts"] / RING_PROC_REPS,
            step_launches=want, max_abs_err=errs, mutual_nn=len(got_set))
    readings["host_p2p_ms_per_call"] = ring_process_p2p(size)
    return readings


def ring_process_p2p(size):
    """The host P2P alone, no card: one forward_ring's rotations (N_LAYERS x
    4 ring calls of ``size - 1``, a new transport each) of a bf16 (1, 4,
    RING_N / size, 64) K/V block between CPU tensors through the direct
    gloo transport, between two barriers; median ms of ``RING_PROC_REPS``."""
    import torch
    import torch.distributed as dist

    from lightglue_tpu_torch.parallel import ring

    pr = ring.ProcessRing(dist.group.WORLD, torch.device("cpu"))
    k = torch.zeros(1, 4, RING_N // size, 64, dtype=torch.bfloat16)
    times = []
    for _ in range(RING_PROC_REPS):
        dist.barrier()
        t = time.perf_counter()
        for _ in range(N_LAYERS * 4):
            transport, block = pr.transport(k, k), (k, k)
            for _ in range(size - 1):
                block = transport.wait(transport.post(*block, 0))
        dist.barrier()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def ring_process_checks(model_inputs):
    """The ring across processes on one card: ``ring_rank`` at each size of
    ``RING_PROC_SIZES``, one position per spawned process on cuda:0 in a
    gloo group; ``forward_ring`` at ``RING`` ranks on ``model_inputs``
    (``ring_end_to_end``'s). Prints a {"ring_processes": ...} line: four
    processes sharing one card, blocks staged through host memory, not a
    time across cards."""
    summary = {}
    for size in RING_PROC_SIZES:
        log(f"ring across {size} processes on cuda:0 (gloo, blocks staged through pinned host "
            f"memory): ring_attention at (2, 4, {RING_N}, 64)"
            + (f"; forward_ring at {RING_N}x{RING_N}, {N_LAYERS} layers, BF16 and FP32"
               if size == RING else ""))
        t = time.perf_counter()
        ranks = spawn_ranks(ring_rank, size, (size, model_inputs if size == RING else None))
        for rank, out in sorted(ranks.items()):
            log(f"  rank {rank}: {json.dumps(out)}")
        log(f"  {size} ranks done in {time.perf_counter() - t:.1f} s")
        summary[size] = ranks
    fwd = {r: out["forward_ring"] for r, out in summary[RING].items()}
    for precision in ("bf16", "fp32"):
        r0 = fwd[0][precision]
        by_rank = {key: [round(fwd[r][precision][key], 3) for r in sorted(fwd)]
                   for key in ("transport_ms_per_call", "stage_ms_per_call", "post_ms_per_call",
                               "wait_ms_per_call")}
        log(f"  forward_ring {precision} across {RING} processes: {r0['ms']:.3f} ms a call "
            f"(rank 0, median of {RING_PROC_REPS}), one-process eager ring "
            f"{r0['one_process_eager_ms']:.3f} ms; host ms per call by rank {by_rank}; step "
            f"launches {RING} x {r0['step_launches']}; mutual NN {r0['mutual_nn']}")
    log(f"  the host P2P alone, one call's rotations between CPU tensors: "
        f"{[round(fwd[r]['host_p2p_ms_per_call'], 3) for r in sorted(fwd)]} ms by rank")
    log(json.dumps({"ring_processes": summary}))
    return summary


GENERIC_CONVS = [
    # label, H, W, C_in, C_out, pool, relu: SuperPoint's C >= 128 layers at 2x480x640
    ("conv3a 120x160 64->128", 120, 160, 64, 128, False, True),
    ("conv3b 120x160 128->128 + pool", 120, 160, 128, 128, True, True),
    ("convDa 60x80 128->256", 60, 80, 128, 256, False, True),
    ("convDb 60x80 256->256 no ReLU", 60, 80, 256, 256, False, False),
]
GENERIC_EDGE_CONVS = [
    # C_in a multiple of 8, not 16, and C_out of 64 channels; a 488-wide
    # map (30.5 tiles) with the pool; batch 2
    ("60x80 24->40 no ReLU", 60, 80, 24, 40, False, False),
    ("360x488 64->128 + pool", 360, 488, 64, 128, True, True),
]


def conv_weights(rand, cin, cout, dt):
    """HWIO weights and an fp32 bias of the port's init scale (1/sqrt(9 C_in))."""
    bound = 1.0 / math.sqrt(9 * cin)
    w = ((rand(3, 3, cin, cout, uniform=True) * 2 - 1) * bound).to(dt)
    return w, (rand(cout, uniform=True) * 2 - 1) * bound


def cudnn_conv(w, b, dt, pool, relu):
    """The library yardstick on NCHW views of NHWC (channels-last) activations:
    cuDNN's conv with the bias [+ ReLU] [+ 2x2 max-pool]."""
    import torch
    import torch.nn.functional as F

    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    bc = b.to(dt)

    def call(xc):
        y = F.conv2d(xc, wc, bc, padding=1)
        y = F.relu(y) if relu else y
        return F.max_pool2d(y, 2) if pool else y

    return call


def bf16_witness(label, got, want, wrong):
    """The rounding witness of a bf16-operand conv case: by elements where
    the output is bf16 (``rounding_witness``), by mean magnitude where it is
    fp32 (``magnitude_witness``: there a different fp32 sum order moves
    nearly every element by an ulp of fp32)."""
    import torch

    if got.dtype == torch.bfloat16:
        rounding_witness(label, got, want, wrong)
    else:
        magnitude_witness(label, got, want, wrong)


def generic_conv_checks(conv_k, rand, dev, dtypes, fp32_scope, gen_e, gen_fp32_e):
    """The generic conv3x3 (JAX conv.py:182) against its plain version at
    SuperPoint's C >= 128 layer shapes for a 2x480x640 batch and at the
    edge shapes, in bf16 and fp32 and with the other output dtype; every
    bf16-operand case also against the rounding witness and the conv's two
    wrong designs, every fp32 -> fp32 case (3xTF32) against a float64 conv
    beside an emulated one-TF32 conv (``tf32_witness``). The four
    SuperPoint shapes are timed in both operand dtypes, cuDNN beside them
    (fp32 with TF32 off)."""
    import torch

    log("conv3x3, generic C_in/C_out (not on a path; the entry point's own calls)")
    for label, h, w, cin, cout, pool, relu in GENERIC_CONVS + GENERIC_EDGE_CONVS:
        for tag, dt in dtypes.items():
            x = rand(2, h, w, cin, uniform=True, dtype=dt)
            wt, b = conv_weights(rand, cin, cout, dt)
            other = torch.float32 if dt == torch.bfloat16 else torch.bfloat16
            for out_dt in (dt, other):
                kw = dict(relu=relu, out_dtype=out_dt)
                case = f"{label} {tag} -> {str(out_dt)[6:]}"
                with fp32_scope():
                    got = conv_k.conv3x3(x, wt, b, pool, **kw)
                    want = conv_k.conv3x3_plain(x, wt, b, pool, **kw)
                    out_tag = "bf16" if torch.bfloat16 in (dt, out_dt) else "fp32"
                    err = compare(case, got, want, **TOL[out_tag])
                    if tag == "bf16":
                        bf16_witness(case, got, want,
                                     conv_wrong_designs(x, wt, b, pool, relu, out_dt))
                    elif out_dt == dt:  # 3xTF32 against float64, one TF32 product wrong
                        one = conv_k.conv3x3_plain(tf32_round(x), tf32_round(wt), b, pool, **kw)
                        tf32_witness(case, got, conv_f64(x, wt, b, pool, relu), one)
                if out_dt == dt:
                    (gen_e if tag == "bf16" else gen_fp32_e).err(err)
    # the entry point's own path: one call per shape, counted from 0
    for tag, dt in dtypes.items():
        ent = gen_e if tag == "bf16" else gen_fp32_e
        conv_k.conv3x3.launches = 0
        timed = []
        for label, h, w, cin, cout, pool, relu in GENERIC_CONVS:
            x = rand(2, h, w, cin, uniform=True, dtype=dt)
            wt, b = conv_weights(rand, cin, cout, dt)
            conv_k.conv3x3(x, wt, b, pool, relu=relu)
            timed.append((label, h, w, cin, cout, pool, relu, x, wt, b))
        ent.d["launches"] = conv_k.conv3x3.launches
        log(f"  generic entry point {tag}, one call per shape: conv3x3 launches "
            f"{conv_k.conv3x3.launches}")
        for label, h, w, cin, cout, pool, relu, x, wt, b in timed:
            lib = cudnn_conv(wt, b, x.dtype, pool, relu)
            xc = x.permute(0, 3, 1, 2)
            with fp32_scope():
                ms = cuda_ms(lambda: conv_k.conv3x3(x, wt, b, pool, relu=relu))
                plain = cuda_ms(lambda: conv_k.conv3x3_plain(x, wt, b, pool, relu=relu))
                lib_ms = cuda_ms(lambda: lib(xc))
            oh, ow = (h // 2, w // 2) if pool else (h, w)
            size = x.element_size()
            nbytes = size * (2 * h * w * cin + 9 * cin * cout + 2 * oh * ow * cout) + 4 * cout
            flops = 2 * 2 * h * w * cin * cout * 9
            ent.add(f"{label} {tag}", 1, ms, plain, lib_ms, nbytes, flops,
                    BF16_FLOP_PER_MS if tag == "bf16" else TF32X3_OP_PER_MS,
                    per="call of the four")


def chain_f64(x, wa, ba, wb, bb, relu=True):
    """conv2_chain's function in float64 (conv2a with ReLU, conv2b [+ReLU],
    the pool): the reference the fp32 chain's error is measured against."""
    return conv_f64(conv_f64(x, wa, ba, False), wb, bb, True, relu)


def chain_one_tf32(conv_k, x, wa, ba, wb, bb, relu=True):
    """The fp32 chain's wrong design: one TF32 product per MAC, emulated
    (every operand of both convs, conv2a's output included, rounded to TF32;
    products and sums in fp32 with TF32 off)."""
    mid = conv_k.conv3x3_plain(tf32_round(x), tf32_round(wa), ba)
    return conv_k.conv3x3_plain(tf32_round(mid), tf32_round(wb), bb, True, relu=relu)


def conv_chain_checks(conv_k, cc, rand, dev, dtypes, fp32_scope, chain_e, chain_fp32_e):
    """conv2_chain (JAX conv_chain.py:140) against its plain version and
    against the port's two-launch conv3x3 chain at the main path's conv2
    shape, 2x240x320x64, and at the 360x488 edge's 2x180x244, in bf16 and
    fp32, with and without conv2b's ReLU, into either output dtype; every
    bf16-operand case also against the rounding witness and the chain's two
    wrong designs (``chain_wrong_designs``); every fp32 -> fp32 case (the
    3xTF32 kernel) against float64 beside an emulated one-TF32 chain
    (``tf32_witness``). One call in each operand dtype is timed beside the
    two-launch chain and cuDNN (fp32 with TF32 off)."""
    import torch

    log("conv2_chain (not on a path: the model runs conv3x3 twice; 2x240x320x64, 2x180x244x64)")
    for tag, dt in dtypes.items():
        other = torch.float32 if dt == torch.bfloat16 else torch.bfloat16
        for h, w in ((240, 320), (180, 244)):
            x = rand(2, h, w, 64, uniform=True, dtype=dt)
            wa, ba = conv_weights(rand, 64, 64, dt)
            wb, bb = conv_weights(rand, 64, 64, dt)
            for relu in (True, False):
                for out_dt in (dt, other):
                    kw = dict(relu=relu, out_dtype=out_dt)
                    case = f"conv2_chain {h}x{w} relu={relu} {tag} -> {str(out_dt)[6:]}"
                    out_tag = "bf16" if torch.bfloat16 in (dt, out_dt) else "fp32"
                    with fp32_scope():
                        got = cc.conv2_chain(x, wa, ba, wb, bb, **kw)
                        want = cc.conv2_chain_plain(x, wa, ba, wb, bb, **kw)
                        err = compare(case, got, want, **TOL[out_tag])
                        two = conv_k.conv3x3(conv_k.conv3x3(x, wa, ba), wb, bb, True, **kw)
                        compare(f"{case} vs two conv3x3 launches", got, two, **TOL[out_tag])
                        if tag == "bf16":
                            bf16_witness(case, got, want,
                                         chain_wrong_designs(x, wa, ba, wb, bb, relu, out_dt))
                        elif out_dt == dt:  # 3xTF32 against float64, one TF32 product wrong
                            tf32_witness(case, got, chain_f64(x, wa, ba, wb, bb, relu),
                                         chain_one_tf32(conv_k, x, wa, ba, wb, bb, relu),
                                         (("two-launch 3xTF32", two),))
                    if out_dt == dt:
                        (chain_e if tag == "bf16" else chain_fp32_e).err(err)
        h, w = 240, 320
        x = rand(2, h, w, 64, uniform=True, dtype=dt)
        wa, ba = conv_weights(rand, 64, 64, dt)
        wb, bb = conv_weights(rand, 64, 64, dt)
        ent = chain_e if tag == "bf16" else chain_fp32_e
        cc.conv2_chain.launches = 0
        cc.conv2_chain(x, wa, ba, wb, bb)
        ent.d["launches"] = cc.conv2_chain.launches
        log(f"  entry point {tag}, one call: conv2_chain launches {cc.conv2_chain.launches}")
        conv2a, conv2b = (cudnn_conv(wa, ba, dt, False, True), cudnn_conv(wb, bb, dt, True, True))
        xc = x.permute(0, 3, 1, 2)
        with fp32_scope():
            ms = cuda_ms(lambda: cc.conv2_chain(x, wa, ba, wb, bb))
            plain = cuda_ms(lambda: cc.conv2_chain_plain(x, wa, ba, wb, bb))
            two_ms = cuda_ms(lambda: conv_k.conv3x3(conv_k.conv3x3(x, wa, ba), wb, bb, True))
            lib_ms = cuda_ms(lambda: conv2b(conv2a(xc)))
        ent.d["two_launch_ms"] = two_ms
        log(f"  the port's two-launch conv3x3 chain {tag} (the model conv's kernel twice; fp32: "
            f"3xTF32): {two_ms:.4f} ms (fused: {ms:.4f}, {ms / two_ms:.3f}x; cuDNN x2 "
            f"{lib_ms:.4f}, {ms / lib_ms:.3f}x)")
        size = x.element_size()
        nbytes = size * (2 * h * w * 64 + 2 * 9 * 64 * 64 + 2 * (h // 2) * (w // 2) * 64) + 8 * 64
        flops = 2 * (2 * 2 * h * w * 64 * 64 * 9)
        # library: two cuDNN convs with bias and ReLU, and the pool
        ent.add(f"conv2a+conv2b+pool 2x240x320x64 {tag}", 1, ms, plain, lib_ms, nbytes, flops,
                BF16_FLOP_PER_MS if tag == "bf16" else TF32X3_OP_PER_MS, per="call")


# ---------------------------------------------------------------------------
# the MIXED and INT8 rungs (and INT8's W8A8 mode)
# ---------------------------------------------------------------------------

INT8_OP_PER_MS = 1979e9        # dense int8 tensor-core peak
# MIXED: bf16 operands, fp32 sums and outputs. A linear kernel and its plain
# version differ only in the order of fp32 sums; an attention output also
# moves where a bf16 rounding of p flips (S summed in another fp32 order)
MIXED_TOL = {"linear": dict(atol=1e-4, rtol=1e-4), "attention": dict(atol=1e-3, rtol=1e-3)}
# 9 layers of a rung's kernels against their plain versions (the stacks, a
# session's LightGlue): twice the envelope of the drift between two
# summation orders of the same stack up to 9 layers, the port's plain stack
# against the JAX stack on the CPU (scripts/derive_rung_stack_envelope.py:
# MIXED 0.0291, INT8 0.1250, W8A8 0.2188), the rule of the bf16 gate
# (golden/bf16_layer_err_r05.txt). INT8 keeps the bf16 9-layer gate. The
# JAX package's share-of-max gates, MIXED 5e-3 and W8A8 0.02 of max|ref|
# (tests/test_layer_stack.py:149-156), were set at 2 layers; each check
# logs its share beside them
RUNG_GATE = {"mixed": dict(atol=0.0581, rtol=0.0), "int8": STACK_TOL["bf16"],
             "w8a8": dict(atol=0.4375, rtol=0.0), "fp32": STACK_TOL["fp32"]}
JAX_SHARE = {"mixed": 5e-3, "int8": None, "w8a8": 0.02, "fp32": None}
# rung: (Precision value, LGTPU_W8A8)
RUNGS = {"mixed": ("mixed", False), "int8": ("int8", False), "w8a8": ("int8", True)}
# the projections whose only reader is the attention: bf16 out at MIXED
BF16_OUT = ("self qkv", "cross qk_v")
LIN_CASES = [
    # (label, K1, K2 (second operand), N, residual, launches per layer)
    ("self qkv", 256, 0, 768, False, 2), ("out", 256, 0, 256, False, 4),
    ("ffn1 cat", 256, 256, 512, False, 4), ("ffn2 +res", 512, 0, 256, True, 4),
    ("cross qk_v", 256, 0, 512, False, 2),
]


def gate_compare(label, got, want, rung):
    """compare() at RUNG_GATE[rung], logging the largest difference's share
    of max|want| beside the JAX package's 2-layer share gate."""
    if JAX_SHARE[rung] is not None:
        share = float((got.float() - want.float()).abs().max() / want.float().abs().max())
        log(f"  {label}: {share:.4f} of max|plain| (the JAX package's 2-layer gate: "
            f"{JAX_SHARE[rung]})")
    return compare(label, got, want, **RUNG_GATE[rung])


@contextlib.contextmanager
def w8a8_env(on):
    """LGTPU_W8A8 for the calls inside (the stacks read it at every call)."""
    old = os.environ.get("LGTPU_W8A8")
    os.environ["LGTPU_W8A8"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["LGTPU_W8A8"]
        else:
            os.environ["LGTPU_W8A8"] = old


@contextlib.contextmanager
def plain_lightglue(ls, at):
    """A session's LightGlue on the kernels' plain versions: the stacks read
    ``layer_stack.KERNEL_OPS`` at each call, and ``forward`` calls the
    module's ``transformer_layers``."""
    import functools

    from lightglue_tpu_torch.models import lightglue as lg_mod

    saved = (ls.KERNEL_OPS, lg_mod.transformer_layers)
    ls.KERNEL_OPS = ls.PLAIN_OPS
    lg_mod.transformer_layers = functools.partial(saved[1], ops=at.PLAIN_OPS)
    try:
        yield
    finally:
        ls.KERNEL_OPS, lg_mod.transformer_layers = saved


@contextlib.contextmanager
def eager_session(session):
    """The session's runners as the eager bodies its CUDA graphs capture
    (``_extract_eager``, ``_match_eager``), on caches of their own, for the
    calls inside: what a context that swaps the kernels (``plain_lightglue``)
    or spies on a call reaches, and what a replay is compared with."""
    saved = session._graphs, session._extract_cache, session._match_cache
    session._graphs, session._extract_cache, session._match_cache = False, {}, {}
    try:
        yield session
    finally:
        session._graphs, session._extract_cache, session._match_cache = saved


def magnitude_witness(label, got, want, wrong):
    """The rounding witness of the MIXED attention kernels, whose outputs are
    fp32, counted by magnitude: the kernel's mean |kernel - plain| is at most
    a quarter of each wrong design's mean |design - plain|. The largest
    difference cannot tell them apart: one bf16 rounding of p that flips
    because S was summed in another fp32 order moves an output by more than
    the whole difference between the two row-sum rules, which moves every
    output a little."""
    if not wrong:
        log(f"  {label}: magnitude witness skipped (no wrong design applies)")
        return
    k_err = (got.float() - want.float()).abs()
    for name, alt in wrong.items():
        p_err = (alt.float() - want.float()).abs()
        log(f"  {label}: magnitude witness: kernel vs plain mean {float(k_err.mean()):.3e} max "
            f"{float(k_err.max()):.3e}; plain vs {name} mean {float(p_err.mean()):.3e} max "
            f"{float(p_err.max()):.3e} (kernel mean at most a quarter)")
        if float(k_err.mean()) > float(p_err.mean()) / 4:
            raise AssertionError(f"{label}: kernel's mean difference {float(k_err.mean()):.3e} "
                                 f"over a quarter of {name}'s {float(p_err.mean()):.3e}")


def mixed_wrong_designs(ls, at, q, k, v, freqs, len_q, len_kv, num_heads, dir1,
                        keep_q=None, keep_kv=None):
    """The MIXED attention's wrong designs on the same operands (bf16 q/k/v,
    fp32 stats and out): (a) the row sum of the other rule (fp32 p where
    the reference's direction 1 sums bf16 p, or the reverse) and, without
    keep masks, (b) an online softmax per Nk / 8 keys
    (``flash_attention_plain`` on the rotated heads)."""
    import torch

    f32 = torch.float32
    out = {"(a) the other row-sum rule": ls.attention_plain(
        q, k, v, freqs, len_q, len_kv, num_heads, f32, f32, keep_q, keep_kv, dir1=not dir1)}
    bsz, nq, e = q.shape
    nk, hd = k.shape[1], e // num_heads
    if keep_q is not None or nk % 8:
        return out

    def heads(t, n):
        return t.reshape(bsz, n, num_heads, hd).transpose(1, 2)

    qh, kh, vh = heads(q, nq), heads(k, nk), heads(v, nk)
    if freqs is not None:
        qh, kh = ls.apply_rotary(freqs, qh), ls.apply_rotary(freqs, kh)
    lens = None if len_q is None else torch.stack([len_q, len_kv], dim=1)
    online = at.flash_attention_plain(qh, kh, vh, lens, stat_dtype=f32, out_dtype=f32,
                                      block_q=nq, block_k=nk // 8)
    out["(b) online softmax per Nk / 8 keys"] = online.transpose(1, 2).reshape(bsz, nq, e)
    return out


def quantized_weight(w, dev):
    """The port's per-output-channel int8 quantization of an fp32 (K, N)
    weight: (w_q (K, N) int8, scale (N,) fp32) on ``dev``."""
    import torch

    from lightglue_tpu_torch import quant

    q = quant.quantize_weight(w.cpu().numpy())
    return (torch.from_numpy(q["w_q"]).to(dev),
            torch.from_numpy(q["scale"].reshape(-1)).to(dev))


def rung_linear_checks(ls, rand, dev, fp32_scope, ents):
    """linear.cu's MIXED, INT8 weight-only and W8A8 modes (with row_quant)
    against their plain versions at every projection of one layer of a
    1024x1024 pair; INT8 also against ``linear`` on the dequantized weight
    (bit for bit), W8A8 and row_quant exactly. Every case is timed."""
    import torch

    from lightglue_tpu_torch import quant

    bf16, f32 = torch.bfloat16, torch.float32
    m = BUCKET
    gen = torch.Generator(device=dev).manual_seed(8)
    log(f"linear MIXED / INT8 weight-only / W8A8 (per match_pair: 16 launches per layer x "
        f"{N_LAYERS} layers, N={m}; W8A8 adds one row_quant launch to each)")
    for label, k1, k2, n, res, per_layer in LIN_CASES:
        k = k1 + k2
        weight = per_layer * N_LAYERS
        w32 = (torch.rand(k, n, generator=gen, device=dev) * 2 - 1) / math.sqrt(k)
        b32 = (torch.rand(n, generator=gen, device=dev) * 2 - 1) / math.sqrt(k)
        wb, (wq, sc) = w32.to(bf16), quantized_weight(w32, dev)
        a, a2 = rand(1, m, k1), (rand(1, m, k2) if k2 else None)
        r = rand(1, m, n) if res else None
        a_cat = a if a2 is None else torch.cat([a, a2], -1)
        out_dt = bf16 if label in BF16_OUT else f32
        out_b = 2 if out_dt == bf16 else 4
        # MIXED: fp32 activations, bias and residual; bf16 weights and products
        with fp32_scope():
            got = ls.linear(a, wb, b32, a2=a2, residual=r, out_dtype=out_dt)
            want = ls.linear_plain(a, wb, b32, a2, r, out_dtype=out_dt)
            ents["linear mixed"].err(compare(
                f"{label} mixed -> {str(out_dt)[6:]}", got, want,
                **(TOL["bf16"] if out_dt == bf16 else MIXED_TOL["linear"])))
        ab, bb = a_cat.to(bf16), b32.to(bf16)
        ms = cuda_ms(lambda: ls.linear(a, wb, b32, a2=a2, residual=r, out_dtype=out_dt))
        with fp32_scope():
            plain = cuda_ms(lambda: ls.linear_plain(a, wb, b32, a2, r, out_dtype=out_dt))
        lib_ms = cuda_ms(lambda: torch.addmm(bb, ab[0], wb))
        nbytes = 4 * m * k + 2 * k * n + 4 * n + (4 * m * n if res else 0) + out_b * m * n
        ents["linear mixed"].add(f"{label} mixed", weight, ms, plain, lib_ms, nbytes,
                                 2 * m * k * n, BF16_FLOP_PER_MS)
        # INT8 weight-only: bf16 activations, int8 weights with fp32 scales, fp32 bias
        a, a2 = a.to(bf16), (a2.to(bf16) if k2 else None)
        r = r.to(bf16) if res else None
        with fp32_scope():
            got = ls.linear(a, wq, b32, a2=a2, residual=r, scale=sc)
            deq = quant.dequantize({"w_q": wq, "scale": sc})
            compare(f"{label} int8 vs linear on the dequantized weight", got,
                    ls.linear(a, deq, bb, a2=a2, residual=r), 0, 0, exact=True)
            ents["linear int8"].err(compare(
                f"{label} int8", got, ls.linear_plain(a, wq, b32, a2, r, scale=sc),
                **TOL["bf16"]))
        ms = cuda_ms(lambda: ls.linear(a, wq, b32, a2=a2, residual=r, scale=sc))
        with fp32_scope():
            plain = cuda_ms(lambda: ls.linear_plain(a, wq, b32, a2, r, scale=sc))
        lib_ms = cuda_ms(lambda: torch.addmm(bb, ab[0], deq))
        nbytes = 2 * m * k + k * n + 8 * n + (2 * m * n if res else 0) + 2 * m * n
        ents["linear int8"].add(f"{label} int8 weight-only", weight, ms, plain, lib_ms, nbytes,
                                2 * m * k * n, BF16_FLOP_PER_MS)
        # W8A8: row_quant, then the s8 GEMM on the K-major weight
        wt = wq.t().contiguous()
        with fp32_scope():
            q, sa = ls.row_quant(a, a2)
            qp, sap = ls.row_quant_plain(a, a2)
            compare(f"{label} row_quant q", q, qp, 0, 0, exact=True)
            compare(f"{label} row_quant sa", sa, sap, 0, 0, exact=True)
            got = ls.linear(a, wq, b32, a2=a2, residual=r, scale=sc, w8a8=True, w_t=wt)
            compare(f"{label} w8a8", got, ls.linear_plain(a, wq, b32, a2, r, scale=sc, w8a8=True),
                    0, 0, exact=True)
            w8a8_edge_checks(ls, label, k1, k2, n, res, wq, wt, sc, b32, gen, dev)
        y = torch.empty_like(got)
        ms = cuda_ms(lambda: ls.linear_s8(q, sa, wt, sc, b32, r, y, None, m))
        with fp32_scope():
            plain = cuda_ms(lambda: ls.linear_plain(a, wq, b32, a2, r, scale=sc, w8a8=True))
        try:  # the library's int8 x int8 -> int32 product (no scales, bias or residual)
            lib_ms = cuda_ms(lambda: torch._int_mm(q[0], wq))
        except RuntimeError as err:
            log(f"  {label} torch._int_mm refused these operands: {err}")
            lib_ms = None
        nbytes = m * k + 4 * m + k * n + 8 * n + (2 * m * n if res else 0) + 2 * m * n
        ents["linear w8a8"].add(f"{label} w8a8 s8 GEMM", weight, ms, plain, lib_ms, nbytes,
                                2 * m * k * n, INT8_OP_PER_MS)
        log(f"  {label} yardsticks per call: bf16 addmm of the same shape "
            f"{cuda_ms(lambda: torch.addmm(bb, ab[0], wb)):.4f} ms, s8 plan "
            f"{ls.s8_plan(m, n, k)}")
        ms = cuda_ms(lambda: ls.row_quant(a, a2))
        plain = cuda_ms(lambda: ls.row_quant_plain(a, a2))
        # library: none, no single PyTorch call quantizes rows
        ents["row_quant"].add(f"{label} row_quant {m}x{k}", weight, ms, plain, None,
                              2 * m * k + m * k + 4 * m, 5 * m * k, FP32_OP_PER_MS)


def tie_row(k):
    """A bf16 row of width k whose amax gives sa with v / sa an exact .5 for
    some v of each parity (round-half-even decides them), on the CPU."""
    import torch

    f32 = torch.float32
    for amax2 in range(192, 320):
        amax = torch.tensor(amax2 / 2, dtype=torch.bfloat16).float()
        sa = torch.clamp(amax, min=1e-6) * (1.0 / 127.0)
        halves = torch.arange(0.5, 120.0, 1.0, dtype=f32)
        v = (halves * sa).to(torch.bfloat16).float()
        tied = v[v / sa == halves]
        parity = (tied / sa).floor().remainder(2)
        evens, odds = tied[parity == 0][:3], tied[parity == 1][:3]
        if len(evens) and len(odds):
            row = torch.zeros(k, dtype=f32)
            row[0] = amax
            picks = torch.cat([evens, odds])[: k // 2 - 1]
            row[2:2 + 2 * len(picks):2] = picks * torch.tensor([1.0, -1.0]).repeat(3)[:len(picks)]
            return row
    raise AssertionError("no bf16 amax gives exact .5 ties")


def w8a8_edge_checks(ls, label, k1, k2, n, res, wq, wt, sc, b32, gen, dev):
    """W8A8 exactly against its plain version (q, sa and y) at 999 rows (off
    the s8 GEMM's 32 / 64-row tiles and row_quant's 2 / 4-row blocks) with
    crafted rows in front: exact .5 ties of v / sa, an all-zero row (the
    1e-6 clamp), a one-hot row, ffn1's amax in the message and in x; then
    two 128-row pairs, the first retired at this layer: with a residual its
    rows are the residual, without one they stay unwritten."""
    import torch

    bf16 = torch.bfloat16
    k = k1 + k2
    x = (torch.randn(999, k, generator=gen, device=dev)
         * torch.rand(999, 1, generator=gen, device=dev) * 4).to(bf16)
    x[0] = tie_row(k).to(dev, bf16)
    x[1] = 0.0
    x[2] = 0.0
    x[2, k // 3] = -3.0
    if k2:
        x[3, k1 + 5] = 50.0
        x[4, 7] = -50.0
    a, a2 = x[:, :k1].contiguous(), (x[:, k1:].contiguous() if k2 else None)
    r = torch.randn(999, n, generator=gen, device=dev).to(bf16) if res else None
    q, sa = ls.row_quant(a, a2)
    qp, sap = ls.row_quant_plain(a, a2)
    compare(f"{label} 999 rows, crafted: row_quant q", q, qp, 0, 0, exact=True)
    compare(f"{label} 999 rows, crafted: row_quant sa", sa, sap, 0, 0, exact=True)
    got = ls.linear(a, wq, b32, a2=a2, residual=r, scale=sc, w8a8=True, w_t=wt)
    compare(f"{label} 999 rows, crafted: w8a8", got,
            ls.linear_plain(a, wq, b32, a2, r, scale=sc, w8a8=True), 0, 0, exact=True)
    # liveness: pair 0 retired (exit 3 <= layer 3), pair 1 live
    x2 = torch.randn(2, 128, k, generator=gen, device=dev).to(bf16)
    a, a2 = x2[..., :k1].contiguous(), (x2[..., k1:].contiguous() if k2 else None)
    r = torch.randn(2, 128, n, generator=gen, device=dev).to(bf16) if res else None
    live = ls.Live(torch.tensor([3.0, 9.0], device=dev), 3)
    q, sa = ls.row_quant(a, a2)
    y = torch.full((2, 128, n), float("nan"), dtype=bf16, device=dev)
    ls.linear_s8(q, sa, wt, sc, b32, r, y, live, 128)
    want = ls.linear_plain(a, wq, b32, a2, r, live, scale=sc, w8a8=True)
    compare(f"{label} retired pair 0, live pair 1: w8a8 live rows", y[1], want[1], 0, 0,
            exact=True)
    if res:
        compare(f"{label} retired pair 0 with a residual: its rows", y[0], r[0], 0, 0, exact=True)
    elif not bool(torch.isnan(y[0]).all()):
        raise AssertionError(f"{label}: the retired pair's rows were written")
    else:
        log(f"  {label} retired pair 0 without a residual: its rows left unwritten")


def rung_stack_kernel_checks(ls, at, rand, freqs_for, dev, fp32_scope, ents):
    """attention.cu at MIXED (bf16 operands, fp32 stats and out; direction
    1 summing bf16 p) in both directions, masked, keep-masked and with
    liveness, each against its plain version and the magnitude witness;
    the other stack kernels' new modes under liveness; ln_gelu with fp32
    gamma/beta on bf16 rows (INT8). The main path's calls are timed."""
    import torch
    import torch.nn.functional as F

    bf16, f32 = torch.bfloat16, torch.float32
    e, heads, hd = 256, 4, 64
    i32 = dict(dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    log(f"attention MIXED (per match_pair: 4 launches per layer x {N_LAYERS} layers, N={BUCKET})")
    cases = [
        # label, Nq, Nk, rope, lengths (q, kv), per-layer launches, direction 1
        ("self rope", BUCKET, BUCKET, True, None, 2, False),
        ("cross direction 0", BUCKET, BUCKET, False, None, 1, False),
        ("cross direction 1", BUCKET, BUCKET, False, None, 1, True),
        ("self masked", 768, 768, True, ([700], [700]), 0, False),
        ("cross masked 768x1024 direction 1", 768, BUCKET, False, ([700], [900]), 0, True),
        ("cross length 0 direction 1", 256, 512, False, ([0], [0]), 0, True),
    ]
    for label, nq, nk, rope, lens, per_layer, dir1 in cases:
        if rope:
            qkv = rand(1, nq, 3 * e, dtype=bf16)
            q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
            f = freqs_for(1, nq)
        else:
            q = rand(1, nq, e, dtype=bf16)
            kv = rand(1, nk, 2 * e, dtype=bf16)
            k, v = kv[..., :e], kv[..., e:]
            f = None
        lq = lk = None
        if lens:
            lq, lk = torch.tensor(lens[0], **i32), torch.tensor(lens[1], **i32)
        with fp32_scope():
            got = ls.attention(q, k, v, f, lq, lk, heads, f32, f32, dir1=dir1)
            want = ls.attention_plain(q, k, v, f, lq, lk, heads, f32, f32, dir1=dir1)
            err = compare(f"{label} mixed", got, want, **MIXED_TOL["attention"])
            if lens and lens[0][0] == 0:
                if float(got.abs().max()) != 0.0:
                    raise AssertionError(f"{label} mixed: length-0 rows are not exactly 0")
            else:
                magnitude_witness(f"{label} mixed", got, want, mixed_wrong_designs(
                    ls, at, q, k, v, f, lq, lk, heads, dir1))
        ents["attention mixed"].err(err)
        if not per_layer:
            continue
        qh, kh, vh = (t.reshape(1, -1, heads, hd).transpose(1, 2) for t in (q, k, v))
        ms = cuda_ms(lambda: ls.attention(q, k, v, f, lq, lk, heads, f32, f32, dir1=dir1))
        plain = cuda_ms(lambda: ls.attention_plain(q, k, v, f, lq, lk, heads, f32, f32,
                                                   dir1=dir1))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
        nbytes = 2 * (nq * e + 2 * nk * e) + 4 * nq * e + (4 * 2 * nq * hd if rope else 0)
        # library: scaled_dot_product_attention (bf16 out, no RoPE)
        ents["attention mixed"].add(f"{label} mixed", per_layer * N_LAYERS, ms, plain, lib_ms,
                                    nbytes, 4 * heads * nq * nk * hd, BF16_FLOP_PER_MS)

    log(f"keep-masked and liveness operands at MIXED and INT8 (N={BUCKET})")
    n = BUCKET
    qkv = rand(1, n, 3 * e, dtype=bf16)
    q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
    kq = (torch.rand(1, n, generator=gen, device=dev) > 0.3).float()
    kk = (torch.rand(1, n, generator=gen, device=dev) > 0.3).float()
    with fp32_scope():
        for label, ff, keeps, dir1 in (("self rope, keep", freqs_for(1, n), (kq, kq), False),
                                       ("cross direction 1, keep", None, (kq, kk), True),
                                       ("cross, other image retired", None,
                                        (kq, torch.zeros_like(kk)), False)):
            got = ls.attention(q, k, v, ff, None, None, heads, f32, f32, keep_q=keeps[0],
                               keep_kv=keeps[1], dir1=dir1)
            want = ls.attention_plain(q, k, v, ff, None, None, heads, f32, f32, keep_q=keeps[0],
                                      keep_kv=keeps[1], dir1=dir1)
            ents["attention mixed"].err(compare(f"{label} mixed", got, want,
                                                **MIXED_TOL["attention"]))
            if "retired" in label:
                if float(got.abs().max()) != 0.0:
                    raise AssertionError(f"{label} mixed: rows are not exactly 0")
            else:
                magnitude_witness(f"{label} mixed", got, want, mixed_wrong_designs(
                    ls, at, q, k, v, ff, None, None, heads, dir1, keeps[0], keeps[1]))
        # a batch of 2 whose second pair retired at layer 3, at layer 5
        live = ls.Live(torch.tensor([N_LAYERS + 1.0, 3.0], device=dev), 5)
        l2 = torch.tensor([n, 700], **i32)
        q2, kv2 = rand(2, n, e, dtype=bf16), rand(2, n, 2 * e, dtype=bf16)
        compare("attention, live pair, mixed",
                ls.attention(q2, kv2[..., :e], kv2[..., e:], None, l2, l2, heads, f32, f32,
                             live=live, dir1=True)[:1],
                ls.attention_plain(q2, kv2[..., :e], kv2[..., e:], None, l2, l2, heads, f32,
                                   f32, dir1=True)[:1], **MIXED_TOL["attention"])
        w32 = rand(2 * e, e) / math.sqrt(2 * e)
        b32 = rand(e) / math.sqrt(2 * e)
        wq, sc = quantized_weight(w32, dev)
        for tag, a, r, wkw in (
                ("mixed", rand(2, n, 2 * e), rand(2, n, e), dict(w=w32.to(bf16))),
                ("int8", rand(2, n, 2 * e, dtype=bf16), rand(2, n, e, dtype=bf16),
                 dict(w=wq, scale=sc)),
                ("w8a8", rand(2, n, 2 * e, dtype=bf16), rand(2, n, e, dtype=bf16),
                 dict(w=wq, scale=sc, w8a8=True, w_t=wq.t().contiguous()))):
            w = wkw.pop("w")
            got = ls.linear(a, w, b32, residual=r, live=live, **wkw)
            compare(f"ffn2 +res, retired pair = residual, {tag}", got[1], r[1], 0, 0, exact=True)
            compare(f"ffn2 +res, live pair, {tag}", got[:1],
                    ls.linear_plain(a, w, b32, None, r, **wkw)[:1],
                    **(MIXED_TOL["linear"] if tag == "mixed" else TOL["bf16"]))
        h = rand(2, n, 2 * e, dtype=bf16)
        g32, bt32 = 1 + 0.3 * rand(2 * e), 0.3 * rand(2 * e)  # off the bf16 grid
        compare("ln_gelu, live pair, int8", ls.ln_gelu(h, g32, bt32, live=live)[:1],
                ls.ln_gelu_plain(h, g32, bt32)[:1], **TOL["bf16"])

    log(f"ln_gelu INT8: bf16 rows, fp32 gamma/beta (per match_pair: 4 launches per layer x "
        f"{N_LAYERS} layers, N={BUCKET})")
    h = rand(1, BUCKET, 2 * e, dtype=bf16)
    with fp32_scope():
        ents["ln_gelu int8"].err(compare("ln_gelu int8", ls.ln_gelu(h, g32, bt32),
                                         ls.ln_gelu_plain(h, g32, bt32), **TOL["bf16"]))
    ms = cuda_ms(lambda: ls.ln_gelu(h, g32, bt32))
    plain = cuda_ms(lambda: ls.ln_gelu_plain(h, g32, bt32))
    gb, bb = g32.to(bf16), bt32.to(bf16)
    lib_ms = cuda_ms(lambda: F.gelu(F.layer_norm(h, (2 * e,), gb, bb)))
    # library: layer_norm + gelu with bf16 gamma/beta (no fp32-affine variant)
    ents["ln_gelu int8"].add("1024x512 int8", 4 * N_LAYERS, ms, plain, lib_ms,
                             2 * 2 * h.numel() + 2 * 4 * 2 * e, 20 * h.numel(), FP32_OP_PER_MS)


def rung_attention_checks(at, ls, rand, freqs_for, dev, fp32_scope, ents):
    """fused_mha, flash_attention and bidirectional_cross_attention at
    MIXED (bf16 operands, fp32 stats, fp32 out) against their plain versions
    at the per-block path's shapes, with the magnitude witness; the main
    per-block calls are timed."""
    import torch
    import torch.nn.functional as F

    bf16, f32 = torch.bfloat16, torch.float32
    e, heads, hd = 256, 4, 64
    i32 = dict(dtype=torch.int32, device=dev)
    mixed = dict(stat_dtype=f32, out_dtype=f32)
    log(f"fused_mha MIXED (per 2048-keypoint match_pair: 1 self + 2 cross launches per layer "
        f"x {N_LAYERS} layers)")
    cases = [
        # label, B, Nq, Nk, rope, lengths, block_k, per-pair launches
        ("self rope 2x2048", 2, PB_BUCKET, PB_BUCKET, True, None, 1024, N_LAYERS),
        ("cross 2048x2048", 1, PB_BUCKET, PB_BUCKET, False, None, 1024, 2 * N_LAYERS),
        ("self rope 2x2048 ragged, kv_len 0", 2, PB_BUCKET, PB_BUCKET, True,
         [[2000, 1500], [700, 0]], 1024, 0),
        ("cross 2048x1024 masked", 1, PB_BUCKET, 1024, False, [[2000, 1000]], 1024, 0),
        ("self rope 2x960 (pad-to-64)", 2, PAD64, PAD64, True, None, 1024, 0),
    ]
    for label, b, nq, nk, rope, lens, block, weight in cases:
        if rope:
            qkv = rand(b, nq, 3 * e, dtype=bf16)
            q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
            f = freqs_for(b, nq)
        else:
            q = rand(b, nq, e, dtype=bf16)
            kv = rand(b, nk, 2 * e, dtype=bf16)
            k, v = kv[..., :e], kv[..., e:]
            f = None
        ln = None if lens is None else torch.tensor(lens, **i32)
        kw = dict(num_heads=heads, block_q=block, block_k=block, **mixed)
        with fp32_scope():
            got = at.fused_mha(q, k, v, f, ln, **kw)
            want = at.fused_mha_plain(q, k, v, f, ln, **kw)
            ents["fused_mha mixed"].err(compare(f"{label} mixed", got, want,
                                                **MIXED_TOL["attention"]))
            if got.dtype != f32:
                raise AssertionError(f"{label} mixed: output {got.dtype}")
            magnitude_witness(f"{label} mixed", got, want, fine_block(
                lambda bk: at.fused_mha_plain(q, k, v, f, ln, **dict(kw, block_k=bk)), block, nk))
        for i, (ql, kl) in enumerate(lens or []):
            rows = got[i] if kl == 0 else got[i, ql:]
            if rows.numel() and float(rows.abs().max()) != 0.0:
                raise AssertionError(f"{label} mixed: padded or empty-side rows are not 0")
        if not weight:
            continue
        qh, kh, vh = (t.reshape(t.shape[0], t.shape[1], heads, hd).transpose(1, 2)
                      for t in (q, k, v))
        ms = cuda_ms(lambda: at.fused_mha(q, k, v, f, ln, **kw))
        plain = cuda_ms(lambda: at.fused_mha_plain(q, k, v, f, ln, **kw))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
        nbytes = 2 * (b * nq * e + 2 * b * nk * e) + 4 * b * nq * e + (
            4 * b * 2 * nk * hd if rope else 0)
        ents["fused_mha mixed"].add(f"{label} mixed", weight, ms, plain, lib_ms, nbytes,
                                    4 * b * heads * nq * nk * hd, BF16_FLOP_PER_MS)

    log("flash_attention MIXED (the generic entry point)")
    for label, b, nq, nk, lens, block, timed in (
            ("2x4x2048 unmasked", 2, PB_BUCKET, PB_BUCKET, None, 1024, True),
            ("2x4x256x192 block_k 64, kv_len 0", 2, 256, 192, [[256, 100], [200, 0]], 64, False)):
        q, k, v = (rand(b, heads, x, hd, dtype=bf16) for x in (nq, nk, nk))
        ln = None if lens is None else torch.tensor(lens, **i32)
        kw = dict(block_q=block, block_k=block, **mixed)
        with fp32_scope():
            got = at.flash_attention(q, k, v, ln, **kw)
            want = at.flash_attention_plain(q, k, v, ln, **kw)
            ents["flash_attention mixed"].err(compare(f"{label} mixed", got, want,
                                                      **MIXED_TOL["attention"]))
            magnitude_witness(f"{label} mixed", got, want, fine_block(
                lambda bk: at.flash_attention_plain(q, k, v, ln, **dict(kw, block_k=bk)),
                block, nk))
        if not timed:
            continue
        at.flash_attention.launches = 0
        at.flash_attention(q, k, v, ln, **kw)
        ents["flash_attention mixed"].d["launches"] = at.flash_attention.launches
        ms = cuda_ms(lambda: at.flash_attention(q, k, v, ln, **kw))
        plain = cuda_ms(lambda: at.flash_attention_plain(q, k, v, ln, **kw))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        nbytes = 2 * 3 * b * heads * nq * hd + 4 * b * heads * nq * hd
        ents["flash_attention mixed"].add(f"{label} mixed", 1, ms, plain, lib_ms, nbytes,
                                          4 * b * heads * nq * nk * hd, BF16_FLOP_PER_MS,
                                          per="call")

    log(f"bidirectional_cross_attention MIXED (per pad-to-64 match_pair: 1 launch per layer "
        f"x {N_LAYERS} layers)")
    for label, b, n0, n1, lens, weight, stats in BIDIR_CASES:
        if stats:  # fp32 operands at bf16 stats: not a MIXED case
            continue
        a0, a1 = rand(b, n0, 2 * e, dtype=bf16), rand(b, n1, 2 * e, dtype=bf16)
        args = (a0[..., :e], a1[..., :e], a0[..., e:], a1[..., e:])
        ln = None if lens is None else torch.tensor(lens, **i32)
        kw = dict(num_heads=heads, **mixed)
        with fp32_scope():
            got = at.bidirectional_cross_attention(*args, ln, **kw)
            want = at.bidirectional_cross_attention_plain(*args, ln, **kw)
            errs = [compare(f"{label} mixed o{i}", g, w, **MIXED_TOL["attention"])
                    for i, (g, w) in enumerate(zip(got, want))]
            if all(min(x) > 0 for x in lens or [[1, 1]]):
                len0, len1 = (None, None) if ln is None else (ln[:, 0], ln[:, 1])
                for i, (q, k, v, lq, lk) in enumerate(((args[0], args[1], args[3], len0, len1),
                                                       (args[1], args[0], args[2], len1, len0))):
                    magnitude_witness(f"{label} mixed o{i}", got[i], want[i], mixed_wrong_designs(
                        ls, at, q, k, v, None, lq, lk, heads, dir1=i == 1))
        ents["bidirectional_cross_attention mixed"].err(max(errs))
        for i, (x0, x1) in enumerate(lens or []):
            for o, (lq, lk) in ((got[0][i], (x0, x1)), (got[1][i], (x1, x0))):
                rows = o if lk == 0 else o[lq:]
                if rows.numel() and float(rows.abs().max()) != 0.0:
                    raise AssertionError(f"{label} mixed: padded or empty-side rows are not 0")
        if not weight:
            continue
        ms = cuda_ms(lambda: at.bidirectional_cross_attention(*args, ln, **kw))
        plain = cuda_ms(lambda: at.bidirectional_cross_attention_plain(*args, ln, **kw))
        two, stack = bidir_yardsticks(ls, args, heads, f32, f32)
        sdpa2, stack2 = cuda_ms(two), cuda_ms(stack)
        log(f"  {label} mixed: two scaled_dot_product_attention calls (one per direction, not "
            f"one call): {sdpa2:.4f} ms; two lg_attention launches (one per direction): "
            f"{stack2:.4f} ms; the bidirectional kernel {ms:.4f} ms")
        ents["bidirectional_cross_attention mixed"].d["two_sdpa_ms"] = weight * sdpa2
        ents["bidirectional_cross_attention mixed"].d["two_attention_ms"] = weight * stack2
        nbytes = 2 * 2 * b * (n0 + n1) * e + 4 * b * (n0 + n1) * e
        # library: none, no single PyTorch call computes both directions
        ents["bidirectional_cross_attention mixed"].add(
            f"{label} mixed", weight, ms, plain, None, nbytes, 6 * b * heads * n0 * n1 * hd,
            BF16_FLOP_PER_MS)


def rung_stack_checks(ls, weights, rand, freqs_for, dev, fp32_scope):
    """transformer_stack at MIXED, INT8 and W8A8 against its plain loop at 9
    layers (1x1024x1024 unmasked, 768x1024 masked), each timed; then
    transformer_stack_adaptive at MIXED and INT8 (random weights, the exit-3
    weights) with exits equal."""
    import torch

    from lightglue_tpu_torch.config import LightGlueConfig
    from lightglue_tpu_torch.quant import quantize_lightglue

    bf16, f32 = torch.bfloat16, torch.float32
    e, heads, hd, n = 256, 4, 64, BUCKET
    base = weights.init_lightglue(0, LightGlueConfig(n_layers=N_LAYERS))

    def tree(rung, t):  # MIXED: fp32; INT8: quantized and not cast (the session's rule)
        return (weights.params_from_numpy(t, dev, f32) if rung == "mixed"
                else weights.params_from_numpy(quantize_lightglue(t), dev))

    log(f"transformer_stack vs plain at MIXED, INT8 and W8A8, L={N_LAYERS}")
    for rung, (_, w8) in RUNGS.items():
        layers = tree(rung, base)["layers"]
        act = f32 if rung == "mixed" else bf16
        kw = dict(num_heads=heads, head_dim=hd, stat_dtype=act, attn_dtype=bf16)
        for label, n0, n1, lens in (("1x1024x1024 unmasked", n, n, None),
                                    ("768x1024 lengths 700/900", 768, n, (700, 900))):
            d0, d1 = rand(1, n0, e, dtype=act), rand(1, n1, e, dtype=act)
            f0, f1 = freqs_for(1, n0), freqs_for(1, n1)
            l0 = l1 = None
            if lens:
                l0 = torch.tensor([lens[0]], dtype=torch.int32, device=dev)
                l1 = torch.tensor([lens[1]], dtype=torch.int32, device=dev)
            with w8a8_env(w8), fp32_scope():
                got = ls.transformer_stack(layers, d0, d1, f0, f1, l0, l1, **kw)
                want = ls.transformer_stack_plain(layers, d0, d1, f0, f1, l0, l1, **kw)
            for i in (0, 1):
                if got[i].dtype != act:
                    raise AssertionError(f"stack {rung}: d{i} is {got[i].dtype}")
                gate_compare(f"stack {label} {rung} d{i}", got[i], want[i], rung)
            if lens is None:
                with w8a8_env(w8):
                    def stack():
                        return ls.transformer_stack(layers, d0, d1, f0, f1, l0, l1, **kw)

                    log(f"  stack {label} {rung}: kernel_ms {cuda_ms(stack, inner=2):.4f} "
                        f"(eager: {eager_ms(stack):.4f})")

    log(f"transformer_stack_adaptive vs plain at MIXED and INT8, L={N_LAYERS}, 1x{n}x{n}, "
        "depth 0.95 width 0.99")
    lens = (torch.tensor([n], dtype=torch.int32, device=dev),) * 2
    for rung in ("mixed", "int8"):
        act = f32 if rung == "mixed" else bf16
        d0, d1 = rand(1, n, e, dtype=act), rand(1, n, e, dtype=act)
        f0, f1 = freqs_for(1, n), freqs_for(1, n)
        kw = dict(num_heads=heads, head_dim=hd, stat_dtype=act, attn_dtype=bf16,
                  depth_confidence=0.95, width_confidence=0.99)
        for label, t, expect in (("random weights", base, N_LAYERS),
                                 ("exit-3 weights", pinned_exit_weights(base, 3), 3)):
            p = tree(rung, t)
            args = (p["layers"], p["token"], d0, d1, f0, f1, *lens, p["assign"]["match"])
            with fp32_scope():
                got = ls.transformer_stack_adaptive(*args, **kw)
                want = ls.transformer_stack_adaptive_plain(*args, **kw)
            compare(f"adaptive {label} {rung} exit", got[2], want[2], 0, 0, exact=True)
            flips = sum(int((g != w).sum()) for g, w in zip(got[3:], want[3:]))
            log(f"  adaptive {label} {rung}: exit {got[2].tolist()}, keep flips vs plain {flips}")
            if int(got[2][0]) != expect or flips:
                raise AssertionError(f"adaptive {label} {rung}: exit {got[2].tolist()} (want "
                                     f"{expect}) or {flips} keep flips")
            for i in (0, 1):
                gate_compare(f"adaptive {label} {rung} d{i}", got[i], want[i],
                             "mixed" if rung == "mixed" else "int8")


def mutual_matches(scores, n0, n1):
    """Mutual nearest neighbours of a log assignment over its valid block:
    the match set at threshold 0."""
    import torch

    s = scores[0, :n0, :n1].float()
    m0, m1 = s.argmax(1), s.argmax(0)
    rows = torch.nonzero(m1[m0] == torch.arange(n0, device=s.device))[:, 0]
    return set(zip(rows.tolist(), m0[rows].tolist()))


def rung_end_to_end(ls, at, counters, img0, img1, ents):
    """match_pair at 480x640, 9 layers, on every route at MIXED, INT8 and
    FP32: the fixed-depth stack (and INT8 with LGTPU_W8A8=1), the adaptive
    stack (random weights), the 2048-keypoint and pad-to-64 per-block
    configs. The FP32 runs give the launch counts of the FP32 rows.
    Each: launch counts read from 0 around one call, ms per pair (median of
    10 after a warm call), one profiled call, a two-pair match_batch, and
    the same extraction's LightGlue on the kernels against it on their plain
    versions (the descriptors at the rung's stack gate, the match set at
    threshold 0)."""
    import dataclasses

    import numpy as np
    import torch

    from lightglue_tpu_torch.config import LightGlueConfig, PipelineConfig
    from lightglue_tpu_torch.precision import Precision
    from lightglue_tpu_torch.runtime.session import MatcherSession

    counters = counters + [ls.row_quant, ls.adaptive_decide, at.fused_mha,
                           at.bidirectional_cross_attention, at.flash_attention]
    adaptive_cfg = PipelineConfig(lightglue=LightGlueConfig(depth_confidence=0.95,
                                                            width_confidence=0.99))
    configs = {"fixed depth": PipelineConfig(), "adaptive": adaptive_cfg, **pb_configs()}
    runs = [("mixed", "fixed depth"), ("int8", "fixed depth"), ("w8a8", "fixed depth"),
            ("mixed", "adaptive"), ("int8", "adaptive"),
            ("mixed", "2048-keypoint"), ("int8", "2048-keypoint"),
            ("mixed", "pad-to-64"), ("int8", "pad-to-64"),
            ("fp32", "fixed depth"), ("fp32", "adaptive"), ("fp32", "2048-keypoint"),
            ("fp32", "pad-to-64")]
    # (rung, config) -> {kernels line entry: launch counter}: the rung's main path
    main_of = {("mixed", "fixed depth"): {"linear mixed": "linear", "attention mixed": "attention",
                                          "relu_conv1a_shift mixed": "relu_conv1a_shift",
                                          "conv3x3 mixed": "conv3x3"},
               ("int8", "fixed depth"): {"linear int8": "linear", "ln_gelu int8": "ln_gelu"},
               ("w8a8", "fixed depth"): {"linear w8a8": "linear", "row_quant": "row_quant"},
               ("mixed", "adaptive"): {"adaptive_decide mixed": "adaptive_decide"},
               ("mixed", "2048-keypoint"): {"fused_mha mixed": "fused_mha"},
               ("mixed", "pad-to-64"): {"bidirectional_cross_attention mixed":
                                        "bidirectional_cross_attention"},
               ("fp32", "fixed depth"): {"linear fp32": "linear", "attention fp32": "attention",
                                         "ln_gelu fp32": "ln_gelu"},
               ("fp32", "adaptive"): {"adaptive_decide fp32": "adaptive_decide"},
               ("fp32", "2048-keypoint"): {"fused_mha fp32": "fused_mha"},
               ("fp32", "pad-to-64"): {"bidirectional_cross_attention fp32":
                                       "bidirectional_cross_attention"}}
    summary = []
    for rung, route in runs:
        precision, w8 = {**RUNGS, "fp32": ("fp32", False)}[rung]
        cfg = dataclasses.replace(configs[route], precision=Precision(precision))
        log(f"MatcherSession(device='cuda').match_pair, {rung.upper()}, {route}, 480x640, "
            f"{N_LAYERS} layers")
        with w8a8_env(w8):
            session = MatcherSession(config=cfg, device="cuda")
            result, counts, launches = first_call(counters,
                                                  lambda: session.match_pair(img0, img1))
            log(f"  launches in the first match_pair {counts}, per call {launches}")
            stack = route in ("fixed depth", "adaptive")
            want = dict(SP_LAUNCHES, row_quant=16 * N_LAYERS if rung == "w8a8" else 0)
            if stack:
                want.update(fused_mha=0, bidirectional_cross_attention=0, flash_attention=0)
                if route == "fixed depth":
                    want.update(linear=16 * N_LAYERS, attention=4 * N_LAYERS,
                                ln_gelu=4 * N_LAYERS, adaptive_decide=0)
            else:
                want.update(linear=0, attention=0, ln_gelu=0, adaptive_decide=0,
                            flash_attention=0)
            bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
            # the route's own kernels launch: the stack's, or fused_mha (and up
            # to 1024 keypoints the bidirectional kernel) on the per-block route
            need = {"fixed depth": ["linear", "attention", "ln_gelu"],
                    "adaptive": ["linear", "attention", "ln_gelu", "adaptive_decide"],
                    "2048-keypoint": ["fused_mha"],
                    "pad-to-64": ["fused_mha", "bidirectional_cross_attention"]}[route]
            bad.update({k: (0, ">= 1") for k in need if launches[k] < 1})
            if bad:
                raise AssertionError(f"{rung} {route}: launches (got, want) {bad}")
            used = [k for k, v in launches.items() if v]
            for key in ("scores", "match_scores", "keypoints0", "keypoints1"):
                if not np.isfinite(result[key]).all():
                    raise AssertionError(f"{rung} {route}: match_pair output {key} is not finite")
            for ent, counter in main_of.get((rung, route), {}).items():
                ents[ent].d["launches"] = counts[counter]
            times = []
            for _ in range(10):
                t = time.perf_counter()
                session.match_pair(img0, img1)
                times.append((time.perf_counter() - t) * 1e3)
            pair_ms = statistics.median(times)
            n0, n1 = result["num_keypoints0"], result["num_keypoints1"]
            log(f"  keypoints {n0}/{n1} scores {tuple(result['scores'].shape)} matches "
                f"{len(result['matches'])} ms_per_pair median {pair_ms:.3f} (10 repeats, min "
                f"{min(times):.3f})")
            profile_replay(f"{rung} {route}", lambda: session.match_pair(img0, img1), pair_ms,
                           launches, top=6)
            if (rung, route) == ("mixed", "fixed depth"):
                extract_profile(session, img0, img1, "MIXED")
            batch = session.match_batch(np.stack([img0, img1]), np.stack([img1, img0]))
            if len(batch) != 2 or not all(np.isfinite(r["match_scores"]).all() for r in batch):
                raise AssertionError(f"{rung} {route}: match_batch of 2 pairs failed")
            log(f"  match_batch of 2 pairs: matches {[len(r['matches']) for r in batch]}")
            # the same extraction through LightGlue on the kernels and on their plain versions
            ext = session.extract(np.stack([img0, img1]))
            e0, e1 = ext.slice(0, 1), ext.slice(1, 2)
            out_k, _ = session.match_from_extractions(e0, e1)
            with plain_lightglue(ls, at), eager_session(session):
                out_p, _ = session.match_from_extractions(e0, e1)
        c0, c1 = int(e0.count[0]), int(e1.count[0])
        if hasattr(out_k, "desc0"):
            for i, (g, w) in enumerate(((out_k.desc0, out_p.desc0), (out_k.desc1, out_p.desc1))):
                gate_compare(f"{rung} {route} d{i} vs plain", g, w, rung)
            b0, b1 = min(c0, out_k.scores.shape[1]), min(c1, out_k.scores.shape[2])
        else:  # adaptive: compacted survivors; equal exits and lengths first
            compare(f"{rung} {route} exit vs plain", out_k.exit_layer, out_p.exit_layer, 0, 0,
                    exact=True)
            b0, b1 = int(out_k.lengths0[0]), int(out_k.lengths1[0])
        mk, mp = mutual_matches(out_k.scores, b0, b1), mutual_matches(out_p.scores, b0, b1)
        iou = len(mk & mp) / max(1, len(mk | mp))
        serr = float((out_k.scores[0, :b0, :b1] - out_p.scores[0, :b0, :b1]).abs().max())
        # random weights give a handful of mutual matches, where an IoU says
        # nothing: the descriptor gate above holds those runs
        log(f"  vs plain: mutual nearest neighbours {len(mk)} / {len(mp)}, IoU {iou:.4f} "
            f"({'needs > 0.95' if len(mp) >= 10 else 'too few for an IoU'}); scores "
            f"max_abs_err {serr:.3e}")
        if len(mp) >= 10 and iou <= 0.95:
            raise AssertionError(f"{rung} {route}: match-set IoU {iou:.4f} against plain")
        summary.append(dict(rung=rung, route=route, ms_per_pair=round(pair_ms, 3),
                            kernels=used, iou_vs_plain=round(iou, 4)))
    log(json.dumps({"rungs": summary}))


def same_result(label, got, want):
    """Two match_pair / match_batch results equal bit for bit: the same
    keys, every array of the same dtype and shape with equal bits."""
    import numpy as np

    if got.keys() != want.keys():
        raise AssertionError(f"{label}: keys {sorted(got)} != {sorted(want)}")
    for key, g in got.items():
        w = want[key]
        if isinstance(g, np.ndarray):
            same = (isinstance(w, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape
                    and g.tobytes() == w.tobytes())
        else:
            same = type(g) is type(w) and g == w
        if not same:
            raise AssertionError(f"{label}: {key} differs between graph replay and eager call")


def graph_configs(weights):
    """PERF.md's configurations of a session (every route and rung; the ring
    runs outside the session): (label, PipelineConfig, LightGlue weights or
    None for the seed's, LGTPU_W8A8)."""
    import dataclasses

    from lightglue_tpu_torch.config import LightGlueConfig, PipelineConfig
    from lightglue_tpu_torch.precision import Precision

    base = weights.init_lightglue(0, LightGlueConfig())
    adaptive = PipelineConfig(lightglue=LightGlueConfig(depth_confidence=0.95,
                                                        width_confidence=0.99))
    downshift = PipelineConfig(lightglue=LightGlueConfig(depth_confidence=0.95,
                                                         width_confidence=0.99, downshift_layer=4))
    routes = {"fixed depth": PipelineConfig(), "adaptive": adaptive, **pb_configs()}
    out = [("BF16 fixed depth", routes["fixed depth"], None, False),
           ("BF16 adaptive exit 9", adaptive, None, False),
           ("BF16 adaptive exit 3", adaptive, pinned_exit_weights(base, 3), False),
           ("BF16 adaptive pruning, downshift 4", downshift, prune_weights(base), False),
           ("BF16 2048-keypoint", routes["2048-keypoint"], None, False),
           ("BF16 pad-to-64", routes["pad-to-64"], None, False)]
    for rung, w8 in (("MIXED", False), ("INT8", False), ("W8A8", True), ("FP32", False)):
        precision = Precision("int8" if rung == "W8A8" else rung.lower())
        for route, cfg in routes.items():
            if rung == "W8A8" and route != "fixed depth":
                continue
            out.append((f"{rung} {route}", dataclasses.replace(cfg, precision=precision), None,
                        w8))
    return out


# batch_invariance's four distinct 480x640 pairs (smooth_pair seeds); on
# every configuration of graph_configs they fill the cap bucket
INVARIANCE_SEEDS = (2, 3, 4, 5)


def match_key(session, ext0, ext1):
    """The (bucket0, bucket1, full) of one pair's match: ``MatcherSession.
    _match``'s rule on its extractions, before ``_match_fn`` normalizes
    ``full``."""
    c0, c1 = (int(e.count[0]) for e in (ext0, ext1))
    b0, b1 = (session.config.bucket_for(max(c, 1)) for c in (c0, c1))
    return b0, b1, c0 >= b0 and c1 >= b1


def api_rows_equal(single, batched):
    """One pair's ``match_pair`` result and its row of a ``match_batch``:
    every field of the row bit for bit."""
    import numpy as np

    return all(np.array_equal(single[k], v) and np.asarray(single[k]).dtype == np.asarray(v).dtype
               for k, v in batched.items())


def output_rows(res, i, counts):
    """Pair ``i`` of ``match_from_extractions``' (LightGlue or adaptive
    output, Matches): every field's row (a 0-d field as it is), and its
    log assignment's valid block (an adaptive output's compacted survivors,
    else the pair's keypoint ``counts`` within the bucket)."""
    out, matches = res
    rows = [t if t.dim() == 0 else t[i] for t in (*out, *matches)]
    if hasattr(out, "lengths0"):
        n0, n1 = int(out.lengths0[i]), int(out.lengths1[i])
    else:
        n0, n1 = (min(c, n) for c, n in zip(counts, out.scores.shape[1:]))
    return rows, out.scores[i:i + 1], n0, n1


def outputs_compared(alone, together, i, counts):
    """Pair ``i`` alone (``alone``: its own ``match_from_extractions``)
    against its row of a batch's (``together``), the pair's keypoint counts
    ``counts``: (every field bit for bit, the IoU of the
    mutual-nearest-neighbour sets of their log assignments at threshold 0,
    the largest difference of the log assignments over the valid block, the
    pair's mutual nearest neighbours alone)."""
    import torch

    (a, sa, n0, n1), (b, sb, m0, m1) = (output_rows(alone, 0, counts),
                                        output_rows(together, i, counts))
    exact = all(x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
                for x, y in zip(a, b, strict=True))
    mine, ref = mutual_matches(sb, m0, m1), mutual_matches(sa, n0, n1)
    iou = len(mine & ref) / max(1, len(mine | ref))
    diff = 0.0
    if (n0, n1) == (m0, m1):
        diff = float((sa[0, :n0, :n1].float() - sb[0, :n0, :n1].float()).abs().max())
    return exact, iou, diff, len(ref)


def with_count(ext, count):
    """An Extraction of one image with its first ``count`` keypoints valid."""
    import torch

    from lightglue_tpu_torch.pipeline.extract import Extraction

    n = torch.full_like(ext.count, count)
    mask = torch.arange(ext.mask.shape[1], device=ext.mask.device)[None] < n[:, None]
    return Extraction(ext.keypoints, ext.keypoints_norm, ext.descriptors, ext.scores, mask, n)


def cat_extractions(*exts):
    import torch

    from lightglue_tpu_torch.pipeline.extract import Extraction

    return Extraction(*(torch.cat(fields) for fields in zip(*exts)))


def batch_invariance(session, label, pairs, unguarded=False):
    """Whether a pair's result on the card depends on its batch: on one
    session (``session_graph_checks`` builds one per configuration), the four
    ``pairs``, which pick one (bucket0, bucket1, full), from the session's
    CUDA graphs and from its eager bodies (``eager_session``): each pair's
    ``match_pair`` against its row of one ``match_batch`` of all four, and
    each pair's ``match_from_extractions`` alone against its row of the
    four's (the LightGlue output, whose log assignment holds every score,
    and the matches; random weights leave few matches above the default
    threshold). Returns a row per path: every field of both bit for bit (the
    gate; ``hold_invariance``), the smallest IoU of the pairs' mutual
    nearest neighbours at threshold 0, the largest log-assignment
    difference. With ``unguarded``, two cases the contract leaves out, from
    the graphs, reported only: pair 0 (it fills its bucket, so it runs
    unmasked alone) in a batch of two beside pair 1 cut to 8 keypoints short
    of the bucket (which makes the batch run masked), and pair 1 cut to a
    smaller bucket in a batch with pair 0 (it runs at the larger bucket
    there)."""
    import numpy as np

    with eager_session(session):  # one uncaptured extraction of the four pairs' images
        exts = [(e.slice(0, 1), e.slice(1, 2)) for e in (
            session._extract(np.stack([img0, img1])) for img0, img1 in pairs)]
    keys = {match_key(session, *e) for e in exts}
    if len(keys) != 1:
        raise AssertionError(f"{label}: the invariance pairs pick {sorted(keys)}, not one key")
    key = keys.pop()
    images0, images1 = (np.stack([p[k] for p in pairs]) for k in (0, 1))
    both = [cat_extractions(*(e[k] for e in exts)) for k in (0, 1)]
    rows = []
    for path in ("graphs", "eager"):
        with eager_session(session) if path == "eager" else contextlib.nullcontext():
            api = all(api_rows_equal(session.match_pair(*p), b) for p, b in zip(
                pairs, session.match_batch(images0, images1), strict=True))
            together = session.match_from_extractions(*both)
            cells = [outputs_compared(session.match_from_extractions(*e), together, i,
                                      [int(x.count[0]) for x in e])
                     for i, e in enumerate(exts)]
        rows.append(dict(config=label, path=path, key=list(key),
                         bit_for_bit=api and all(c[0] for c in cells), api_bit_for_bit=api,
                         iou=min(c[1] for c in cells), max_score_diff=max(c[2] for c in cells),
                         mutual_nn=[c[3] for c in cells]))
        log(f"  batch invariance, {path}: {len(pairs)} pairs at (bucket0, bucket1, full) {key}, "
            f"each alone against its row of the batch of {len(pairs)}: match_pair / match_batch "
            f"bit for bit {api}, LightGlue outputs and matches bit for bit "
            f"{all(c[0] for c in cells)}; mutual-NN IoU >= {rows[-1]['iou']:.4f} "
            f"({rows[-1]['mutual_nn']} a pair), log assignments apart by <= "
            f"{rows[-1]['max_score_diff']:.3e}")
    if unguarded:
        (a0, a1), (b0, b1) = exts[:2]
        cap = key[0]
        short = [with_count(e, cap - 8) for e in (b0, b1)]
        small = session.config.buckets[(len(session.config.buckets) - 1) // 2]
        smaller = [with_count(e, small - 8) for e in (b0, b1)]
        out = {}
        for case, (alone, together, row) in {
                "filled pair beside a partial one (masked there, unmasked alone)":
                    ((a0, a1), (cat_extractions(a0, short[0]), cat_extractions(a1, short[1])), 0),
                f"pair cut to bucket {session.config.bucket_for(small - 8)} in a batch at {cap}":
                    (smaller, (cat_extractions(a0, smaller[0]), cat_extractions(a1, smaller[1])),
                     1)}.items():
            got = outputs_compared(session.match_from_extractions(*alone),
                                   session.match_from_extractions(*together), row,
                                   [int(x.count[0]) for x in alone])
            out[case] = dict(bit_for_bit=got[0], iou=got[1], max_score_diff=got[2])
            log(f"  unguarded, {case}: bit for bit {got[0]}, mutual-NN IoU {got[1]:.4f} of "
                f"{got[3]}, log assignments apart by {got[2]:.3e} (reported, not gated)")
        rows[0]["unguarded"] = out
    return rows


def hold_invariance(rows):
    """Every guarded cell of ``batch_invariance`` bit for bit."""
    bad = [f"{r['config']} ({r['path']})" for r in rows if not r["bit_for_bit"]]
    if bad:
        raise AssertionError(f"a pair's match_pair differs from its match_batch row in {bad}")


def session_graph_checks(weights, img0, img1):
    """MatcherSession on a card replays per-bucket CUDA graphs: on every
    configuration of ``graph_configs``, match_pair and a two-pair
    match_batch from the graphs against the same session's eager bodies
    (``eager_session``): every returned array equal bit for bit, the
    replay's launches per wrapper, counted from a profiler trace by kernel
    name (``trace_launches``), equal to the wrappers' own counts over the
    eager call; a second call (the pair swapped) leaves the first call's
    returned arrays as they were. Then ms per pair as graphs and eager
    (median of 10 each) and the profiled graph call's device busy share.
    ``warmup`` fills the default config's keys first (diagonal buckets and
    the cap's full variant at batch 1) and the match keys are held to it.
    On each session, ``batch_invariance`` (its rows printed as a
    {"batch_invariance": ...} line, held by ``hold_invariance`` after it).
    Last, the device memory a session holds after ``warmup(pairs="all")``
    at the default buckets and at the 2048-keypoint config's."""
    import copy
    import gc
    import itertools

    import numpy as np
    import torch

    from lightglue_tpu_torch.config import PipelineConfig
    from lightglue_tpu_torch.kernels import attention as at
    from lightglue_tpu_torch.kernels import conv, conv_chain, layer_stack as ls, nms, stem
    from lightglue_tpu_torch.runtime.session import MatcherSession, _Graph, _SplitGraph

    counters = (stem.relu_conv1a_shift, conv.conv3x3, conv_chain.conv2_chain,
                nms.nms_candidates, ls.linear, ls.row_quant, ls.attention, ls.ln_gelu,
                ls.adaptive_decide, at.fused_mha, at.bidirectional_cross_attention,
                at.flash_attention, at.flash_attention_step)
    rows = []

    def counted(fn):
        for c in counters:
            c.launches = 0
        out = fn()
        return out, {c.__name__: c.launches for c in counters if c.launches}

    def timed(fn):
        times = []
        for _ in range(10):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times), min(times)

    pair, swapped = (img0, img1), (img1, img0)
    batch = (np.stack([img0, img1]), np.stack([img1, img0]))
    inv_pairs = [smooth_pair(seed) for seed in INVARIANCE_SEEDS]
    inv_rows, inv_s = [], 0.0
    for label, cfg, tree, w8 in graph_configs(weights):
        log(f"MatcherSession(device='cuda') from CUDA graphs against eager, {label}, 480x640")
        with w8a8_env(w8):
            session = MatcherSession(lg_params=tree, config=cfg, device="cuda")
            t = time.perf_counter()
            if label == "BF16 fixed depth":
                session.warmup(img0.shape[:2])
                buckets = cfg.buckets
                want = {(b, b, False, 1) for b in buckets} | {(max(buckets),) * 2 + (True, 1)}
                if set(session._match_cache) != want or set(session._extract_cache) != {
                        (1, *img0.shape[:2])}:
                    raise AssertionError(f"warmup keys {set(session._match_cache)} "
                                         f"{set(session._extract_cache)}")
            session.match_pair(*pair)  # captures this pair's keys
            capture_s = time.perf_counter() - t
            with eager_session(session):
                session.match_pair(*pair)
            graph_r = session.match_pair(*pair)
            with eager_session(session):
                eager_r, eager_l = counted(lambda: session.match_pair(*pair))
            same_result(f"{label} match_pair", graph_r, eager_r)
            kept = copy.deepcopy(graph_r)
            session.match_pair(*swapped)
            same_result(f"{label} match_pair after a second call", graph_r, kept)
            graph_b = session.match_batch(*batch)
            with eager_session(session):
                eager_b, eager_bl = counted(lambda: session.match_batch(*batch))
            for i, (g, e) in enumerate(zip(graph_b, eager_b, strict=True)):
                same_result(f"{label} match_batch pair {i}", g, e)
            # the pair's match graph again, after the batch's was captured in
            # and replayed from the pool they share
            same_result(f"{label} match_pair after match_batch", session.match_pair(*pair),
                        eager_r)
            hold_launches(f"{label} match_batch",
                          traced(lambda: session.match_batch(*batch), TRACES, eager_bl)[1],
                          eager_bl)
            graph_ms, graph_min = timed(lambda: session.match_pair(*pair))
            with eager_session(session):
                session.match_pair(*pair)
                eager_ms, eager_min = timed(lambda: session.match_pair(*pair))
            graphs = sum(isinstance(r, (_Graph, _SplitGraph))
                         or isinstance(getattr(r, "graph", None), _Graph)
                         for r in (*session._extract_cache.values(),
                                   *session._match_cache.values()))
            if graphs != len(session._extract_cache) + len(session._match_cache):
                raise AssertionError(f"{label}: {graphs} of the session's runners are graphs")
            log(f"  keys: extract {sorted(session._extract_cache)} match "
                f"{sorted(session._match_cache)} ({graphs} of them graphs; first calls "
                f"{capture_s:.2f} s); eager launches per call {eager_l}; match_pair and "
                "match_batch bit for bit equal to eager, the first call's arrays kept")
            log(f"  ms_per_pair graph median {graph_ms:.3f} (min {graph_min:.3f}), eager median "
                f"{eager_ms:.3f} (min {eager_min:.3f})")
            prof = profile_replay(label, lambda: session.match_pair(*pair), graph_ms, eager_l,
                                  top=5)
            t = time.perf_counter()
            inv_rows += batch_invariance(session, label, inv_pairs,
                                         unguarded=label.startswith("BF16"))
            inv_s += time.perf_counter() - t
        rows.append(dict(config=label, graph_ms=round(graph_ms, 3), eager_ms=round(eager_ms, 3),
                         kernel_ms=round(prof[1], 3), busy_share=round(prof[0] / graph_ms, 3)))
        del session
        gc.collect()  # a session's runners hold it in a reference cycle: free its graphs' pools
        torch.cuda.empty_cache()
    log(json.dumps({"sessions": rows}))
    log(json.dumps({"batch_invariance": dict(seconds=round(inv_s, 1), cells=inv_rows)}))
    hold_invariance(inv_rows)

    # the session's shared match pool against one pool per match graph
    # (``_match_pool`` None: each graph captures into its own)
    for (label, cfg), shared in itertools.product(
            (("default buckets", PipelineConfig()),
             ("2048-keypoint", pb_configs()["2048-keypoint"])), (True, False)):
        gc.collect()  # a session's runners hold it in a reference cycle
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
        t = time.perf_counter()
        session = MatcherSession(config=cfg, device="cuda")
        if not shared:
            session._match_pool = None
        session.warmup(img0.shape[:2], pairs="all")
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved() - base[0], torch.cuda.memory_allocated() - base[1]
        log(f"warmup(pairs='all'), {label} (buckets {cfg.buckets}), "
            f"{'one shared match pool' if shared else 'one pool per match graph'}: "
            f"{len(session._match_cache)} match graphs, {len(session._extract_cache)} "
            f"extraction graph in {warm_s:.2f} s; the session holds "
            f"{held[0] / 2**20:.1f} MiB reserved ({held[1] / 2**20:.1f} MiB allocated), "
            "weights included")
        if shared:  # every graph of the pool captured: a replay still equals eager
            got = session.match_pair(*pair)
            with eager_session(session):
                same_result(f"{label} match_pair after warmup(pairs='all')", got,
                            session.match_pair(*pair))
        del session


# ---- phase 8: the entry points users run ----------------------------------

DEMO_FRAMES = 6
DEMO_PAIRS = 10
DEMO_SRC_HW = (600, 800)  # frames are resized to 480x640 by the native preprocess
BATCHER_PAIRS = 24
BATCHER_SIZE = 4


def demo_frames(seed=0):
    """``DEMO_FRAMES`` (600, 800, 3) uint8 frames: shifted crops of one
    ``smooth_pair`` field (a camera panning over a textured scene)."""
    import numpy as np

    h, w = DEMO_SRC_HW
    dy, dx = 12, 18
    field = smooth_pair(seed, h + DEMO_FRAMES * dy, w + DEMO_FRAMES * dx, 0, 0)[0][..., 0]
    frames = []
    for k in range(DEMO_FRAMES):
        crop = field[k * dy:k * dy + h, k * dx:k * dx + w]
        frames.append(np.ascontiguousarray(np.repeat((crop * 255).astype(np.uint8)[..., None],
                                                     3, axis=-1)))
    return frames


def frame_files(frames, pair):
    """The frames through files and a render, where cv2 or PIL imports here
    (the card's machine need not have either): each frame written as PNG and
    read back by ``utils.image.read_image`` must equal it; with cv2, the
    demo's ``_render`` of one pair. Returns what ran, for the log."""
    import tempfile

    import numpy as np

    from lightglue_tpu_torch.cli import demo_mono
    from lightglue_tpu_torch.utils import image

    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None:
        try:
            from PIL import Image
        except ImportError:
            return "cv2 and PIL absent: no frame files, no render (the demo ran on in-memory frames)"
    with tempfile.TemporaryDirectory() as d:
        for k, rgb in enumerate(frames):
            path = f"{d}/frame_{k:02d}.png"
            if cv2 is not None:
                cv2.imwrite(path, rgb[..., ::-1])
            else:
                Image.fromarray(rgb).save(path)
            if not np.array_equal(image.read_image(path), rgb):
                raise AssertionError(f"frame {k}: read_image of its PNG differs")
        if cv2 is None:
            return "PIL: frames written and read back equal; no render (the demo renders with cv2)"
        out = Path(d) / "match_000.jpg"
        demo_mono._render(out, frames[pair["i0"]], frames[pair["i1"]], pair["matched_kpts0"],
                          pair["matched_kpts1"], pair["inlier_mask"], (480, 640))
        if not out.is_file() or out.stat().st_size == 0:
            raise AssertionError("demo render wrote no file")
        return f"cv2: frames written and read back equal; one render of {out.stat().st_size} B"


def batcher_pairs(ladder):
    """``BATCHER_PAIRS`` random pairs (numpy seed 17) across the ladder: both
    sides strictly inside one bucket, so a pair's own
    match_from_extractions runs the batcher's bucket, masked."""
    import numpy as np

    gen = np.random.default_rng(17)
    pairs = []
    for k in range(BATCHER_PAIRS):
        lo, hi = (ladder[k % len(ladder) - 1] if k % len(ladder) else 0) + 1, ladder[k % len(ladder)] - 1
        n0, n1 = (int(x) for x in gen.integers(lo, hi + 1, 2))
        d0, d1 = (gen.standard_normal((n, 256)).astype(np.float32) for n in (n0, n1))
        pairs.append((gen.uniform(-1, 1, (n0, 2)).astype(np.float32),
                      gen.uniform(-1, 1, (n1, 2)).astype(np.float32),
                      d0 / np.linalg.norm(d0, axis=1, keepdims=True),
                      d1 / np.linalg.norm(d1, axis=1, keepdims=True)))
    return pairs


def hold_matches(label, got, idx, sc, own=True):
    """A batcher's ``MatchResult`` against a reference's match indices and
    scores: True where bit for bit. ``own``: the batch ran at the pair's own
    (bucket0, bucket1, full), so a pair's result is its own and anything but
    bit for bit raises; else the match set at IoU > 0.95 given >= 10 matches
    and the common scores at the bf16 tolerance, or raise."""
    import numpy as np

    if np.array_equal(got.indices, idx) and np.array_equal(got.scores, sc):
        return True
    if own:
        raise AssertionError(f"{label}: not bit for bit, though its batch ran at the pair's own "
                             "(bucket0, bucket1, full)")
    mine = {tuple(p): s for p, s in zip(got.indices.tolist(), got.scores)}
    ref = {tuple(p): s for p, s in zip(idx.tolist(), sc)}
    iou = len(mine.keys() & ref.keys()) / max(1, len(mine.keys() | ref.keys()))
    serr = max((abs(mine[k] - ref[k]) - TOL["bf16"]["rtol"] * abs(ref[k])
                for k in mine.keys() & ref.keys()), default=0.0)
    log(f"  {label}: not bit for bit; IoU {iou:.4f} of {len(mine)} / {len(ref)}, scores beyond "
        f"rtol {serr:.3e}")
    if len(ref) < 10 or iou <= 0.95 or serr > TOL["bf16"]["atol"]:
        raise AssertionError(f"{label}: IoU {iou:.4f}, {len(ref)} matches, score error {serr}")
    return False


def match_set(kpts0, kpts1):
    """A result's matches as a set of ((x0, y0), (x1, y1)) keypoint pairs."""
    return set(zip(map(tuple, kpts0.tolist()), map(tuple, kpts1.tolist())))


def hold_path_launches(label, counters, want_names):
    """Every kernel of a path launched at least once since the counts were
    zeroed: the wrappers' counts over the path's calls."""
    counts = {fn.__name__: fn.launches for fn in counters if fn.launches}
    missing = [n for n in want_names if not counts.get(n)]
    log(f"  {label}: launches {counts}")
    if missing:
        raise AssertionError(f"{label}: no launch of {missing}")
    return counts


def entry_point_checks(counters):
    """The one-card entry points a user runs, at full width on the card:
    the native host library (built with g++ into build/torch_native/),
    ``preprocess_image`` against its plain version; the demo's per-pair
    function (``cli.demo_mono.match_frames``) at BF16, 480x640, 1024
    keypoints, 9 layers, default ladder, on ``DEMO_FRAMES`` frames under
    ``--proxy_whiten`` weights (threshold 0: every mutual match), each
    pair's match indices against ``match_pair`` of the same session on the
    same preprocessed images (equal, or IoU > 0.95 given >= 10 matches);
    the bench CLI (``cli.bench --all`` at 1x1024 and at --batch 8) in
    subprocesses, every p50 finite and > 0, and SuperPoint's images/s on
    the other rungs in process; ``ContinuousBatcher`` on ``BATCHER_PAIRS``
    pairs across the ladder at batch ``BATCHER_SIZE``, each result against
    ``match_from_extractions`` of the pair: bit for bit where the batch ran
    at the pair's own (bucket0, bucket1, full), else the match set at IoU >
    0.95 given >= 10 matches and common scores at the bf16 tolerance
    (``hold_matches``). The launch counts are zeroed before the demo and the
    batcher and read after them. Prints an {"entry_points": ...} line."""
    import random

    import numpy as np
    import torch

    from lightglue_tpu_torch.cli import bench, demo_mono
    from lightglue_tpu_torch.config import PipelineConfig, SuperPointConfig
    from lightglue_tpu_torch.parallel.batcher import ContinuousBatcher, session_match_fn
    from lightglue_tpu_torch.pipeline.extract import Extraction
    from lightglue_tpu_torch.runtime import host, weights
    from lightglue_tpu_torch.runtime.session import MatcherSession

    summary = {}
    path_kernels = ("relu_conv1a_shift", "conv3x3", "nms_candidates", "linear", "attention",
                    "ln_gelu")

    # ---- native host library ---------------------------------------------
    t = time.perf_counter()
    lib_path = host.build()
    build_s = time.perf_counter() - t
    frames = demo_frames()
    hw = (480, 640)
    err = max(float(np.abs(host.preprocess_image(f, hw) - host.preprocess_image_plain(f, hw)).max())
              for f in frames)
    log(f"native host library {lib_path.relative_to(ROOT)} (g++ -O3) in {build_s:.2f} s; "
        f"preprocess_image {DEMO_SRC_HW[0]}x{DEMO_SRC_HW[1]} -> 480x640 vs its plain version "
        f"on {len(frames)} frames: max_abs_err {err:.3e} (atol 1e-6)")
    if err > 1e-6:
        raise AssertionError(f"preprocess_image vs plain: {err}")
    summary["preprocess_max_abs_err"] = err

    # ---- the demo: proxy-whitened SuperPoint, BF16, 480x640 ---------------
    log("demo (cli.demo_mono.match_frames): BF16, 480x640, 1024 keypoints, 9 layers, "
        f"--proxy_whiten, threshold 0, {DEMO_PAIRS} pairs of {DEMO_FRAMES} frames")
    for fn in counters:
        fn.launches = 0
    config = PipelineConfig(superpoint=SuperPointConfig(max_num_keypoints=1024),
                            match_threshold=0.0, max_matches=1024)
    t = time.perf_counter()
    sp = weights.whiten_superpoint_descriptors(
        weights.init_superpoint(0, config.superpoint), host.preprocess_image(frames[0], hw)[None],
        config=config.superpoint, device="cuda")
    session = MatcherSession(sp, None, config, device="cuda")
    session.warmup(hw)
    log(f"  whitening and warmup (graphs of {sorted(session._match_cache)}): "
        f"{time.perf_counter() - t:.2f} s")
    rng = random.Random(888)
    rows = []
    for i in range(DEMO_PAIRS):
        i0, i1 = rng.sample(range(len(frames)), 2)
        r = demo_mono.match_frames(session, frames[i0], frames[i1], hw, 888)
        r.update(i0=i0, i1=i1)
        rows.append(r)
        log(f"  pair {i:3d} [{i0:2d},{i1:2d}]: kpts {r['num_keypoints0']}/{r['num_keypoints1']}  "
            f"matches {len(r['matches']):4d}  ransac inliers {r['inliers']:4d}  "
            f"sp {r['sp_ms']:6.2f} ms  lg {r['lg_ms']:6.2f} ms")
    demo_launches = hold_path_launches("demo (whitening, warmup, pairs)", counters, path_kernels)
    for i, r in enumerate(rows):
        ref = session.match_pair(host.preprocess_image(frames[r["i0"]], hw),
                                 host.preprocess_image(frames[r["i1"]], hw))
        for key in ("num_keypoints0", "num_keypoints1", "matches", "matched_kpts0",
                    "matched_kpts1", "match_scores"):
            if not np.isfinite(np.asarray(r[key], np.float64)).all():
                raise AssertionError(f"demo pair {i}: {key} not finite")
        if (r["num_keypoints0"], r["num_keypoints1"]) != (ref["num_keypoints0"],
                                                           ref["num_keypoints1"]):
            raise AssertionError(f"demo pair {i}: keypoints {r['num_keypoints0']}/"
                                 f"{r['num_keypoints1']} vs match_pair {ref['num_keypoints0']}/"
                                 f"{ref['num_keypoints1']}")
        if np.array_equal(r["matches"], ref["matches"]):
            how = "equal"
        else:
            got = match_set(r["matched_kpts0"], r["matched_kpts1"])
            want = match_set(ref["matched_kpts0"], ref["matched_kpts1"])
            iou = len(got & want) / max(1, len(got | want))
            how = f"IoU {iou:.4f} of {len(got)} / {len(want)}"
            if len(want) < 10 or iou <= 0.95:
                raise AssertionError(f"demo pair {i} vs match_pair: {how} (needs > 0.95 of >= 10)")
        log(f"  pair {i} vs match_pair of the same images: match indices {how}")
    warm = max(1, min(5, len(rows) - 1))
    sp_warm = float(np.mean([r["sp_ms"] for r in rows[warm:]]))
    lg_warm = float(np.mean([r["lg_ms"] for r in rows[warm:]]))
    log(f"  warm avg (excl. first {warm} pairs): superpoint {sp_warm:.2f} ms, lightglue "
        f"{lg_warm:.2f} ms (host wall-clock, each ending in a count fetch); matches "
        f"{np.mean([len(r['matches']) for r in rows]):.1f}, inliers "
        f"{np.mean([r['inliers'] for r in rows]):.1f}")
    files = frame_files(frames, rows[0])
    log(f"  frame files: {files}")
    summary["demo"] = dict(
        pairs=len(rows), matches=[len(r["matches"]) for r in rows],
        inliers=[r["inliers"] for r in rows], sp_ms=[round(r["sp_ms"], 3) for r in rows],
        lg_ms=[round(r["lg_ms"], 3) for r in rows], warm_sp_ms=round(sp_warm, 3),
        warm_lg_ms=round(lg_warm, 3), launches=demo_launches, files=files.split(":")[0])
    del session

    # ---- the bench CLI, in subprocesses -------------------------------------
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    summary["bench"] = {}
    for batch in (1, 8):
        cmd = [sys.executable, "-m", "lightglue_tpu_torch.cli.bench", "--all", "--batch",
               str(batch)]
        log(f"bench: {' '.join(cmd[1:])}")
        t = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=600)
        lines = proc.stdout.strip().splitlines()
        for line in lines[:-1]:
            log(f"  {line}")
        if proc.returncode:
            raise AssertionError(f"bench --batch {batch} failed ({proc.returncode}):\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        result = json.loads(lines[-1])
        want = {f"lightglue_{p}_{batch}x1024_ms" for p in ("fp32", "mixed", "bf16", "int8")}
        if set(result) != want | {"superpoint_bf16_ms"}:
            raise AssertionError(f"bench keys {sorted(result)}")
        for key, st in result.items():
            if not (math.isfinite(st["p50"]) and st["p50"] > 0):
                raise AssertionError(f"bench {key}: p50 {st['p50']}")
        log(f"  {len(result)} rows, every p50 finite and > 0, in {time.perf_counter() - t:.1f} s")
        summary["bench"].update(result if batch == 1 else
                                {k: v for k, v in result.items() if k.startswith("lightglue")})
    for p in ("fp32", "mixed", "int8"):  # bf16 ran in the CLI
        for fn in counters:
            fn.launches = 0
        st = bench.bench_superpoint(p, 480, 640, "cuda")
        log(f"  superpoint {p} 480x640 (bench.bench_superpoint in process): {st['p50']:.3f} ms "
            f"+-{st['spread_pct']:.1f}% ({1e3 / st['p50']:.1f} images/s)")
        hold_path_launches(f"superpoint {p} bench (its graph's capture)", counters,
                           ("relu_conv1a_shift", "conv3x3", "nms_candidates"))
        summary["bench"][f"superpoint_{p}_ms"] = st

    # ---- the continuous batcher across the ladder --------------------------
    # threshold 0: every mutual nearest neighbour is a match (random weights
    # leave next to none above the default 0.1), so the results compared
    # below hold scores
    config = PipelineConfig(match_threshold=0.0)
    session = MatcherSession(config=config, device="cuda")
    ladder = config.buckets
    pairs = batcher_pairs(ladder)
    log(f"ContinuousBatcher: {BATCHER_PAIRS} pairs across the ladder {ladder} at batch "
        f"{BATCHER_SIZE}, BF16, 9 layers (first pass captures each bucket's graph, second timed)")

    def stream():
        batcher = ContinuousBatcher(session_match_fn(session), session.lg_params,
                                    buckets=ladder, batch_size=BATCHER_SIZE, device="cuda")
        t = time.perf_counter()
        for i, p in enumerate(pairs):
            batcher.submit(i, *p)
        results = {r.pair_id: r for r in batcher.flush()}
        return results, batcher.dispatches, (time.perf_counter() - t) * 1e3

    for fn in counters:
        fn.launches = 0
    results, dispatches, _ = stream()
    batcher_launches = hold_path_launches("batcher (first pass)", counters,
                                          ("linear", "attention", "ln_gelu"))
    timed_runs = [stream() for _ in range(3)]
    for again, _, _ in timed_runs:
        for i in results:
            if not (np.array_equal(again[i].indices, results[i].indices)
                    and np.array_equal(again[i].scores, results[i].scores)):
                raise AssertionError(f"batcher pair {i}: a replayed stream differs from the first")
    stream_ms = statistics.median(ms for _, _, ms in timed_runs)
    want_dispatches = sum(-(-sum(1 for k0, k1, _, _ in pairs if config.bucket_for(
        max(len(k0), len(k1))) == b) // BATCHER_SIZE) for b in ladder)
    if len(results) != BATCHER_PAIRS or dispatches != want_dispatches:
        raise AssertionError(f"batcher: {len(results)} results, {dispatches} dispatches "
                             f"(want {want_dispatches})")
    def padded(k, d, bucket):  # one side of a pair as an Extraction of `bucket` slots
        kp = torch.zeros((1, bucket, 2), device="cuda")
        de = torch.zeros((1, bucket, 256), device="cuda")
        kp[0, :len(k)], de[0, :len(d)] = torch.from_numpy(k), torch.from_numpy(d)
        mask = torch.arange(bucket, device="cuda")[None] < len(k)
        return Extraction(kp, kp, de, mask.float(), mask,
                          torch.full((1,), len(k), dtype=torch.int32, device="cuda"))

    exact, own_key = 0, 0
    for i, (k0, k1, d0, d1) in enumerate(pairs):
        bucket = config.bucket_for(max(len(k0), len(k1)))
        b0, b1 = config.bucket_for(len(k0)), config.bucket_for(len(k1))
        # the batcher runs (bucket, bucket, masked); alone the pair runs at its own key
        own = b0 == b1 == bucket and not (len(k0) == b0 and len(k1) == b1)
        own_key += own
        _, m = session.match_from_extractions(padded(k0, d0, bucket), padded(k1, d1, bucket))
        c = int(m.count[0])
        exact += hold_matches(f"batcher pair {i} ({len(k0)}/{len(k1)}, bucket {bucket}) vs "
                              "match_from_extractions", results[i],
                              m.indices[0, :c].cpu().numpy(), m.scores[0, :c].cpu().numpy(),
                              own=own)
    log(f"  {BATCHER_PAIRS} pairs in {dispatches} dispatches; {own_key} of them batched at "
        f"their own (bucket0, bucket1, full), which must be bit for bit, "
        f"{BATCHER_PAIRS - own_key} at another; {exact} of {BATCHER_PAIRS} bit "
        f"for bit equal to the pair's own match_from_extractions; replayed stream "
        f"{stream_ms:.3f} ms (median of 3): {stream_ms / BATCHER_PAIRS:.3f} ms a pair, "
        f"{BATCHER_PAIRS / stream_ms * 1e3:.1f} pairs/s (host clock, staging and fetches "
        "included)")
    summary["batcher"] = dict(pairs=BATCHER_PAIRS, batch_size=BATCHER_SIZE, dispatches=dispatches,
                              own_key=own_key, bit_for_bit=exact,
                              ms_per_pair=round(stream_ms / BATCHER_PAIRS, 3),
                              pairs_per_s=round(BATCHER_PAIRS / stream_ms * 1e3, 1),
                              launches=batcher_launches)
    del session
    log(json.dumps({"entry_points": summary}))


# ---- phase 9: the parallel path ----------------------------------------------

PAR_MESHES = ((2, 2), (4, 1), (1, 4))  # (data, model), each on [cuda:0] x 4
PAR_BATCH = 4
PAR_SEED = 21  # the phase's own generator: earlier phases keep their inputs
# __graft_entry__.py:184-191: twice the 9-layer envelope of the per-block
# (tensor-parallel) lowering against the single-device stack
# (golden/bf16_layer_err_r05.txt: 0.2501), rounded up; INT8 shares it
BF16_GATE = 0.51
FP32_GATE = 1e-3  # __graft_entry__.py:250
PAR_RUNGS = (("bf16", BF16_GATE, 2 * BF16_GATE), ("fp32", FP32_GATE, FP32_GATE),
             ("int8", BF16_GATE, 2 * BF16_GATE))  # rung, score gate, tie margin of the sets
# the tensor-parallel shards' attention calls at B = 4: local heads ->
# (fused_mha batch: both images stacked, bidirectional batch) of a shard
TP_SHAPES = {2: (4, 2), 1: (8, 4)}  # H = 2 on the 2 x 2 mesh, H = 1 on 1 x 4


def mutual_nn_sets(scores, margin, ref):
    """__graft_entry__.py:142-171: per pair, the mutual nearest neighbours of
    ``scores`` whose row and column argmax margins IN ``ref`` are at least
    ``margin`` (near-ties of the reference are left out, from one side)."""
    import torch

    sets = []
    for s, r in zip(scores.float(), ref.float()):
        top_r, top_c = r.topk(2, dim=1).values, r.topk(2, dim=0).values
        solid_r = (top_r[:, 0] - top_r[:, 1]) >= margin
        solid_c = (top_c[0] - top_c[1]) >= margin
        row_arg, col_arg = s.argmax(1), s.argmax(0)
        rows = torch.arange(s.shape[0], device=s.device)
        ok = (col_arg[row_arg] == rows) & solid_r & solid_c[row_arg]
        sets.append(set(zip(rows[ok].tolist(), row_arg[ok].tolist())))
    return sets


def adaptive_flips(label, got, ref):
    """Tokens kept on one side only, per pair and image, between two adaptive
    outputs of the same pairs: a pair's keep decisions are its own whatever
    its batch, so none may flip. Returns the total (0), or raises naming the
    first pair and image with a flip."""
    for b in range(got.exit_layer.shape[0]):
        for side in (0, 1):
            lg, lr = (int(getattr(x, f"lengths{side}")[b]) for x in (got, ref))
            kept = [set(getattr(x, f"index{side}")[b, :n].tolist()) for x, n in ((got, lg), (ref, lr))]
            diff = len(kept[0] ^ kept[1])
            if lg != lr or diff:
                raise AssertionError(f"adaptive {label} pair {b} image {side}: lengths {lg} / "
                                     f"{lr}, {diff} tokens kept on one side only")
    return 0


def tp_attention_checks(at, dev, fp32_scope, ents):
    """fused_mha (self, RoPE) and bidirectional_cross_attention at the
    tensor-parallel shards' local head counts (H = 2 and 1), N = 1024, in
    bf16, MIXED and fp32, masked, against their plain versions at
    attention_kernel_checks' tolerances; each timed beside SDPA (two SDPA
    calls for both cross directions). Returns the readings."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(PAR_SEED)
    hd, n = 64, BUCKET
    modes = {  # operands, stats, out, tolerance
        "bf16": (torch.bfloat16, torch.bfloat16, torch.bfloat16, TOL["bf16"]),
        "mixed": (torch.bfloat16, torch.float32, torch.float32, MIXED_TOL["attention"]),
        "fp32": (torch.float32, torch.float32, torch.float32, TOL["fp32"]),
    }
    readings = {}
    log(f"fused_mha and bidirectional_cross_attention at the TP shards' local heads, N={n}")
    for heads, (bf, bb) in TP_SHAPES.items():
        e = heads * hd
        lens_f = torch.randint(n * 2 // 3, n + 1, (bf, 1), generator=gen, device=dev).expand(bf, 2)
        lens_b = torch.randint(n * 2 // 3, n + 1, (bb, 2), generator=gen, device=dev)
        ang = torch.rand(bf, n, hd // 2, generator=gen, device=dev) * 4.0
        emb = torch.stack([torch.cos(ang), torch.sin(ang)], dim=1)
        freqs = torch.cat([emb, emb], dim=-1).contiguous()
        for tag, (dt, sdt, odt, tol) in modes.items():
            qkv = torch.randn(bf, n, 3 * e, generator=gen, device=dev).to(dt)
            q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
            a0, a1 = (torch.randn(bb, n, 2 * e, generator=gen, device=dev).to(dt) for _ in "01")
            bargs = (a0[..., :e], a1[..., :e], a0[..., e:], a1[..., e:])
            kw = dict(num_heads=heads, stat_dtype=sdt, out_dtype=odt)

            def split(t):
                return t.reshape(t.shape[0], n, heads, hd).transpose(1, 2)

            with fp32_scope():
                err_f = compare(f"fused_mha self rope H={heads} {bf}x{n} masked {tag}",
                                at.fused_mha(q, k, v, freqs, lens_f, **kw),
                                at.fused_mha_plain(q, k, v, freqs, lens_f, **kw), **tol)
                got = at.bidirectional_cross_attention(*bargs, lens_b, **kw)
                want = at.bidirectional_cross_attention_plain(*bargs, lens_b, **kw)
                err_b = max(compare(f"bidirectional H={heads} {bb}x{n}x{n} masked {tag} o{i}",
                                    g, w, **tol) for i, (g, w) in enumerate(zip(got, want)))
                qh, kh, vh = split(q), split(k), split(v)
                q0, q1, w0, w1 = (split(t) for t in bargs)
                f_ms = cuda_ms(lambda: at.fused_mha(q, k, v, freqs, lens_f, **kw))
                f_plain = cuda_ms(lambda: at.fused_mha_plain(q, k, v, freqs, lens_f, **kw))
                f_lib = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
                b_ms = cuda_ms(lambda: at.bidirectional_cross_attention(*bargs, lens_b, **kw))
                b_plain = cuda_ms(lambda: at.bidirectional_cross_attention_plain(*bargs, lens_b,
                                                                                 **kw))
                b_two = cuda_ms(lambda: (F.scaled_dot_product_attention(q0, q1, w1),
                                         F.scaled_dot_product_attention(q1, q0, w0)))
            readings[f"fused_mha H={heads} {tag}"] = dict(
                batch=bf, ms=f_ms, plain_ms=f_plain, sdpa_ms=f_lib, max_abs_err=err_f)
            readings[f"bidirectional H={heads} {tag}"] = dict(
                batch=bb, ms=b_ms, plain_ms=b_plain, two_sdpa_ms=b_two, max_abs_err=err_b)
            log(f"  H={heads} {tag}: fused_mha {f_ms:.4f} ms (plain {f_plain:.4f}, SDPA {f_lib:.4f}),"
                f" bidirectional {b_ms:.4f} ms (plain {b_plain:.4f}, two SDPA {b_two:.4f})")
            if tag != "bf16":
                continue
            # a mesh of PAR_BATCH shards runs each per layer on every shard:
            # N_LAYERS launches per pair, each the call timed here
            ent_f, ent_b = ents[("fused_mha", heads)], ents[("bidirectional_cross_attention", heads)]
            ent_f.err(err_f)
            ent_f.add(f"self rope H={heads} {bf}x{n} bf16", N_LAYERS, f_ms, f_plain, f_lib,
                      q.element_size() * 4 * bf * n * e + 4 * bf * 2 * n * hd,
                      4 * bf * heads * n * n * hd, BF16_FLOP_PER_MS)
            ent_b.err(err_b)
            ent_b.d["two_sdpa_ms"] = N_LAYERS * b_two
            # library: none, no single PyTorch call computes both directions
            ent_b.add(f"H={heads} {bb}x{n}x{n} bf16", N_LAYERS, b_ms, b_plain, None,
                      a0.element_size() * 6 * bb * n * e, 6 * bb * heads * n * n * hd,
                      BF16_FLOP_PER_MS)
    return readings


def par_step_ms(step, params, args):
    """Median host-clock ms of one eager mesh step over 10 calls, each ending
    in a synchronise (after one warm call)."""
    return host_ms(lambda: step(params, *args))


def parallel_rank(rank, port, inputs, queue):
    """One of two ranks spawned on cuda:0 (``parallel_checks``), in a gloo
    group (NCCL refuses two ranks on one card): ``initialize``, the barrier
    at data=2, model=1, the match step there (each rank feeds its own pair
    through ``global_batch_from_local``) and at data=1, model=2 (the model
    axis across the two processes), each against this rank's own
    single-device forward of both pairs at the BF16 gates, then a sharded
    ContinuousBatcher on ``batcher_pairs`` in lockstep against a
    single-device batcher. Puts (rank, traceback or None, readings)."""
    import traceback

    try:
        import numpy as np
        import torch

        from lightglue_tpu_torch.config import PipelineConfig
        from lightglue_tpu_torch.models import lightglue
        from lightglue_tpu_torch.parallel import mesh as mesh_lib
        from lightglue_tpu_torch.parallel import multihost
        from lightglue_tpu_torch.parallel.batcher import (ContinuousBatcher, mesh_match_fn,
                                                           session_match_fn)
        from lightglue_tpu_torch.runtime.session import MatcherSession

        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        multihost.initialize(f"localhost:{port}", 2, rank, backend="gloo")
        out = {}
        mesh = mesh_lib.make_mesh(2, 1, devices=[dev])
        out["barrier"] = multihost.barrier(mesh)
        if out["barrier"] != 2:
            raise AssertionError(f"rank {rank}: barrier counted {out['barrier']}")
        # BF16, 9 layers; threshold 0, so the batchers' results hold matches
        config = PipelineConfig(buckets=(BUCKET,), max_matches=BUCKET, match_threshold=0.0)
        session = MatcherSession(config=config, device="cuda")
        params = session.lg_params
        batch = [torch.from_numpy(a).to(dev) for a in inputs]
        with torch.inference_mode():
            ref = lightglue.forward(params, *batch, config=config.lightglue,
                                    policy=session.policy).scores.float()
        ref_sets = mutual_nn_sets(ref, 2 * BF16_GATE, ref)
        for d, m in ((2, 1), (1, 2)):
            mp = mesh if (d, m) == (2, 1) else mesh_lib.make_mesh(d, m, devices=[dev])
            step = mesh_lib.make_parallel_match_fn(mp, config, BUCKET, BUCKET)
            if d == 2:  # this rank's own pair, placed by global_batch_from_local
                args = multihost.global_batch_from_local([a[rank:rank + 1] for a in inputs], mp)
            else:  # one data row across both ranks: each holds the whole batch
                args = batch
            res, _ = step(mesh_lib.shard_lightglue_params(params, mp), *args)
            err, sets = 0.0, 0
            for shard in res.scores.shards:
                rows = slice(shard.start, shard.start + shard.data.shape[0])
                err = max(err, float((shard.data.float() - ref[rows]).abs().max()))
                got = mutual_nn_sets(shard.data, 2 * BF16_GATE, ref[rows])
                if got != ref_sets[rows]:
                    raise AssertionError(f"rank {rank} mesh {d}x{m}: mutual-NN sets differ")
                sets += sum(len(x) for x in got)
            if err >= BF16_GATE:
                raise AssertionError(f"rank {rank} mesh {d}x{m}: max abs err {err} vs forward")
            out[f"{d}x{m}"] = dict(rows=[s.start for s in res.scores.shards], max_abs_err=err,
                                   matches=sets)
        ladder = PipelineConfig().buckets
        pairs = batcher_pairs(ladder)
        results = {}
        for name, batcher in (
                ("sharded", ContinuousBatcher(mesh_match_fn(mesh, config),
                                              mesh_lib.shard_lightglue_params(params, mesh),
                                              buckets=ladder, batch_size=BATCHER_SIZE,
                                              sharding=mesh)),
                ("single", ContinuousBatcher(session_match_fn(session), params, buckets=ladder,
                                             batch_size=BATCHER_SIZE, device="cuda"))):
            for i, p in enumerate(pairs):
                batcher.submit(i, *p)
            results[name] = {r.pair_id: r for r in batcher.flush()}
        mine = results["sharded"]
        # lockstep: this rank keeps row k % 2 of each dispatch's batch of 4
        want_ids, seen = [], {b: 0 for b in ladder}
        for i, (k0, k1, _, _) in enumerate(pairs):
            b = PipelineConfig().bucket_for(max(len(k0), len(k1)))
            if (seen[b] % BATCHER_SIZE) // (BATCHER_SIZE // 2) == rank:
                want_ids.append(i)
            seen[b] += 1
        if sorted(mine) != want_ids:
            raise AssertionError(f"rank {rank}: batcher rows {sorted(mine)}, want {want_ids}")
        exact = sum(hold_matches(f"rank {rank} batcher pair {i}", r, results["single"][i].indices,
                                 results["single"][i].scores) for i, r in mine.items())
        out["batcher"] = dict(pairs=len(mine), bit_for_bit=exact)
        queue.put((rank, None, out))
    except Exception:
        queue.put((rank, traceback.format_exc(), None))


def spawn_ranks(target, size, args, wait_s=300):
    """``size`` ranks of ``target(rank, port, *args, queue)`` spawned on
    cuda:0 (``parallel_rank``, ``ring_rank``); each puts (rank, traceback or
    None, readings). Returns {rank: readings}; a traceback, a silent rank or
    a non-zero exit fails the run. The kernel library is built already, so
    no rank builds it. Every process started is joined or killed."""
    import multiprocessing
    import queue as queue_mod
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")  # CUDA in the parent
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, port, *args, q)) for r in range(size)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < size:
            rank, tb, out = q.get(timeout=wait_s)  # drained before the joins
            if tb is not None:
                raise AssertionError(f"rank {rank} failed:\n{tb}")
            got[rank] = out
        for p in procs:
            p.join(timeout=60)
            if p.exitcode != 0:
                raise AssertionError(f"rank exited with {p.exitcode}")
    except queue_mod.Empty:
        raise AssertionError(f"{size} ranks: a rank sent nothing in {wait_s} s") from None
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return got


def two_process_checks(inputs):
    """Two ranks spawned on cuda:0 (``parallel_rank``), each held to its own
    single-device results."""
    return spawn_ranks(parallel_rank, 2, (inputs,))


def nccl_world_one(dev):
    """The NCCL backend at world size 1 (env:// rendezvous on localhost):
    ``initialize`` brings the group up and ``barrier`` counts 1."""
    import socket

    import torch.distributed as dist

    from lightglue_tpu_torch.parallel import mesh as mesh_lib
    from lightglue_tpu_torch.parallel import multihost

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="1", RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        multihost.initialize(backend="nccl")
        try:
            if dist.get_backend() != "nccl":
                raise AssertionError(f"backend {dist.get_backend()}")
            count = multihost.barrier(mesh_lib.make_mesh(devices=[dev]))
        finally:
            dist.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    if count != 1:
        raise AssertionError(f"nccl barrier at world size 1 counted {count}")
    log("  nccl, world size 1 (env:// on localhost): initialize, barrier == 1")
    return count


def parallel_checks(at, counters, fp32_scope, tp_ents):
    """The parallel path on ``[cuda:0] x 4`` (``__graft_entry__.py:
    dryrun_multichip``, :59-470, at BUCKET keypoints and 480x640): the
    attention kernels at the TP shards' local heads (``tp_attention_checks``);
    DP extraction of four images (a proxy-whitened SuperPoint) over a 2 x 2
    mesh against the unsharded one, bit for bit; the match step of each mesh
    of ``PAR_MESHES`` at BF16, FP32 and INT8 (image1 = image0, so the match
    sets are not vacuous) against the single-device ``forward``: scores under
    the rung's gate, mutual-NN sets equal with near-ties of the reference left
    out, launches per wrapper (and, for the TP route, from a trace), the DP
    rows bit for bit the single-device rows (on the 4 x 1 mesh a gate, on the
    TP meshes reported: their LayerNorm sums meet in shard order); ms per pair of each
    mesh's eager step beside a 1 x 1 mesh's and the session's eager
    ``match_pair``; ``make_parallel_adaptive_fn`` over 2 x 2 with the pinned
    exit-3 weights (depth+width; depth-only ``full``) and through the
    downshift at layer 4 (both arms): every field equal to
    ``forward_adaptive`` of each data row's pairs alone and of the batch of
    four, bit for bit (no keep flip); two processes on the
    card (``two_process_checks``); NCCL at world size 1. Prints a
    {"parallel": ...} line."""
    import dataclasses

    import numpy as np
    import torch

    from lightglue_tpu_torch.config import LightGlueConfig, PipelineConfig, SuperPointConfig
    from lightglue_tpu_torch.models import lightglue, superpoint
    from lightglue_tpu_torch.parallel import mesh as mesh_lib
    from lightglue_tpu_torch.pipeline.extract import extract_keypoints
    from lightglue_tpu_torch.precision import Precision, policy_for
    from lightglue_tpu_torch.quant import quantize_lightglue
    from lightglue_tpu_torch.runtime import weights
    from lightglue_tpu_torch.runtime.session import MatcherSession

    dev = torch.device("cuda", 0)
    summary = {"tp_attention": tp_attention_checks(at, dev, fp32_scope, tp_ents)}

    def grid(d, m):
        return mesh_lib.make_mesh(d, m, devices=[dev] * (d * m))

    # ---- DP extraction: four 480x640 images over a 2 x 2 mesh ---------------
    sp_cfg = SuperPointConfig(max_num_keypoints=BUCKET)
    config = PipelineConfig(superpoint=sp_cfg, buckets=(BUCKET,), max_matches=BUCKET)  # BF16
    images = np.stack([smooth_pair(seed)[k] for seed in (0, 1) for k in (0, 1)])
    sp_tree = weights.whiten_superpoint_descriptors(weights.init_superpoint(0, sp_cfg), images[:1],
                                                    config=sp_cfg)
    sp = weights.params_from_numpy(sp_tree, dev)
    log(f"make_parallel_extract_fn over 2 x 2, {PAR_BATCH}x480x640, proxy-whitened SuperPoint, "
        "BF16, against one unsharded extraction")
    ext = mesh_lib.make_parallel_extract_fn(grid(2, 2), config)(sp, torch.from_numpy(images))
    with torch.inference_mode():
        scores, desc = superpoint.forward(sp, torch.from_numpy(images).to(dev), config=sp_cfg,
                                          policy=policy_for(Precision.BF16), nms=False)
        whole = extract_keypoints(scores, desc, config=sp_cfg, raw_scores=True)
    for name, g, w in zip(ext._fields, ext, whole):
        compare(f"DP extraction {name}", g, w, 0, 0, exact=True)
    summary["dp_extraction_bit_for_bit"] = True
    counts = torch.clamp(ext.count, max=BUCKET)
    args = (ext.keypoints_norm, ext.keypoints_norm, ext.descriptors, ext.descriptors,
            counts, counts)  # image1 = image0: strongly diagonal assignments
    log(f"  keypoints per image {ext.count.tolist()}")

    # ---- the match step on each mesh, per rung --------------------------------
    lg_tree = weights.init_lightglue(0, config.lightglue)
    by_name = {fn.__name__: fn for fn in counters}
    summary["meshes"] = {}
    for rung, gate, margin in PAR_RUNGS:
        cfg = dataclasses.replace(config, precision=Precision(rung))
        pol = policy_for(cfg.precision)
        params = (weights.params_from_numpy(quantize_lightglue(lg_tree), dev) if pol.int8_weights
                  else weights.params_from_numpy(lg_tree, dev, pol.param_dtype))
        with torch.inference_mode():
            ref = lightglue.forward(params, *args, config=cfg.lightglue, policy=pol).scores.float()
        ref_sets = mutual_nn_sets(ref, margin, ref)
        log(f"match step, {rung}, {PAR_BATCH}x{BUCKET}, {N_LAYERS} layers: gate {gate}, tie margin "
            f"{margin}; single-device mutual-NN sets {[len(x) for x in ref_sets]}")
        if not all(ref_sets):
            raise AssertionError(f"{rung}: a pair without a solid mutual match; the set check "
                                 "would be vacuous")
        for d, m in PAR_MESHES:
            mesh = grid(d, m)
            step = mesh_lib.make_parallel_match_fn(mesh, cfg, BUCKET, BUCKET)
            mp = mesh_lib.shard_lightglue_params(params, mesh)
            for fn in counters:
                fn.launches = 0
            out, matches = step(mp, *args)
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in counters}
            label = f"  mesh {d}x{m} {rung}"
            if out.scores.shape != (PAR_BATCH, BUCKET, BUCKET) or matches.indices.shape != (
                    PAR_BATCH, BUCKET, 2):
                raise AssertionError(f"{label}: scores {tuple(out.scores.shape)}, indices "
                                     f"{tuple(matches.indices.shape)}")
            err = float((out.scores.float() - ref).abs().max())
            if not err < gate:
                raise AssertionError(f"{label}: scores vs single-device max abs err {err}")
            sets = mutual_nn_sets(out.scores, margin, ref)
            for b, (g, r) in enumerate(zip(sets, ref_sets)):
                if g != r:
                    raise AssertionError(f"{label} pair {b}: mutual-NN sets differ: mesh only "
                                         f"{sorted(g - r)[:5]}, single only {sorted(r - g)[:5]}")
            shards = d * m
            if m == 1:  # the stack on every shard: the main path's launches per pair
                want = dict(linear=16 * N_LAYERS * d, attention=4 * N_LAYERS * d,
                            ln_gelu=4 * N_LAYERS * d, fused_mha=0,
                            bidirectional_cross_attention=0)
            else:  # the per-block route at H / m heads on every shard
                want = dict(linear=0, attention=0, ln_gelu=0, fused_mha=N_LAYERS * shards,
                            bidirectional_cross_attention=N_LAYERS * shards)
            bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
            if bad:
                raise AssertionError(f"{label}: launches (got, want) {bad}")
            bitwise = bool(torch.equal(out.scores.float(), ref))
            if m == 1 and not bitwise:  # a pair's rows are its own, whatever its batch
                raise AssertionError(f"{label}: the DP rows differ from the single device's "
                                     f"(max abs err {err:.3e}); they must be bit for bit")
            row = dict(max_abs_err=err, matches=[len(x) for x in sets], bit_for_bit=bitwise,
                       launches_per_pair={k: v / PAR_BATCH for k, v in launches.items() if v})
            if rung == "bf16":
                if m > 1:  # the TP route's launches per pair from a trace
                    _, traced_counts = traced(lambda: step(mp, *args), traces=TRACES, want={
                        "fused_mha": want["fused_mha"],
                        "bidirectional_cross_attention": want["fused_mha"]})
                    if {k: v for k, v in traced_counts.items() if v} != {
                            "fused_mha": want["fused_mha"],
                            "bidirectional_cross_attention": want["fused_mha"]}:
                        raise AssertionError(f"{label}: traced launches {traced_counts}")
                    row["traced_launches_per_pair"] = {k: v / PAR_BATCH
                                                       for k, v in traced_counts.items() if v}
                    heads = cfg.lightglue.num_heads // m
                    tp_ents[("fused_mha", heads)].d["launches"] = launches["fused_mha"]
                    tp_ents[("bidirectional_cross_attention", heads)].d["launches"] = (
                        launches["bidirectional_cross_attention"])
                row["ms_per_pair"] = par_step_ms(step, mp, args) / PAR_BATCH
            summary["meshes"][f"{d}x{m} {rung}"] = row
            log(f"{label}: max_abs_err {err:.3e} (gate {gate}); mutual-NN sets equal "
                f"({row['matches']} a pair); DP rows bit for bit the single device's: {bitwise}; "
                f"launches {row['launches_per_pair']} a pair"
                + (f"; eager step {row['ms_per_pair']:.3f} ms a pair" if "ms_per_pair" in row
                   else ""))

    # ---- one card without a mesh, for the timings' sake ----------------------
    bf16 = weights.params_from_numpy(lg_tree, dev, torch.bfloat16)
    one = grid(1, 1)
    summary["one_device_step_ms_per_pair"] = par_step_ms(
        mesh_lib.make_parallel_match_fn(one, config, BUCKET, BUCKET),
        mesh_lib.shard_lightglue_params(bf16, one), args) / PAR_BATCH
    session = MatcherSession(device="cuda")
    img0, img1 = smooth_pair(0)
    with eager_session(session):
        session.match_pair(img0, img1)
        times = []
        for _ in range(10):
            t = time.perf_counter()
            session.match_pair(img0, img1)
            times.append((time.perf_counter() - t) * 1e3)
    summary["session_eager_match_pair_ms"] = statistics.median(times)
    log(f"  1 x 1 mesh eager step {summary['one_device_step_ms_per_pair']:.3f} ms a pair; the "
        f"session's eager BF16 match_pair (extraction included) "
        f"{summary['session_eager_match_pair_ms']:.3f} ms (host clock, median of 10)")

    # ---- adaptive over 2 x 2 --------------------------------------------------
    m22 = grid(2, 2)
    summary["adaptive"] = {}
    full_lens = torch.full((PAR_BATCH,), BUCKET, dtype=torch.int32, device=dev)
    rngd = np.random.default_rng(3)  # __graft_entry__.py:381-391, at the 1024 bucket
    ds_args = tuple(torch.from_numpy(a).to(dev) for a in (
        rngd.uniform(-1, 1, (PAR_BATCH, BUCKET, 2)).astype(np.float32),
        rngd.uniform(-1, 1, (PAR_BATCH, BUCKET, 2)).astype(np.float32),
        rngd.standard_normal((PAR_BATCH, BUCKET, 256), dtype=np.float32),
        rngd.standard_normal((PAR_BATCH, BUCKET, 256), dtype=np.float32),
        np.full((PAR_BATCH,), BUCKET - 5, np.int32), np.full((PAR_BATCH,), BUCKET - 9, np.int32)))
    no_prune = prune_weights(lg_tree)
    match = no_prune["assign"]["match"]
    no_prune["assign"] = dict(no_prune["assign"], match=dict(match, b=np.full_like(match["b"], 50.0)))
    # label, tree, LightGlueConfig knobs, full, inputs, the exit every pair
    # takes (None: unpinned. The JAX dry run wants 9 from the downshift
    # cases, which its kernel forces: phase 2 tests liveness against the
    # local layer (ROADMAP queue 3); the port follows the oracle, where a
    # pair can meet the depth criterion in phase 2)
    cases = [
        ("depth+width exit 3", pinned_exit_weights(lg_tree, 3),
         dict(depth_confidence=0.95, width_confidence=0.99), False, args, 3),
        ("depth-only exit 3 full", pinned_exit_weights(lg_tree, 3),
         dict(depth_confidence=0.95, width_confidence=-1.0), True, args[:4] + (full_lens,) * 2, 3),
        ("downshift half-width arm", prune_weights(lg_tree),
         dict(depth_confidence=0.95, width_confidence=0.99, downshift_layer=4), False, ds_args,
         None),
        ("downshift full-width arm", no_prune,
         dict(depth_confidence=0.95, width_confidence=0.99, downshift_layer=4), False, ds_args,
         None),
    ]
    per = PAR_BATCH // 2
    for label, tree, knobs, full, case_args, want_exit in cases:
        cfg = dataclasses.replace(config, lightglue=LightGlueConfig(**knobs))
        params = weights.params_from_numpy(tree, dev, torch.bfloat16)
        got = mesh_lib.make_parallel_adaptive_fn(m22, cfg, full=full)(params, *case_args)
        with torch.inference_mode():
            def single(rows):
                return lightglue.forward_adaptive(
                    params, *(a[rows] for a in case_args), config=cfg.lightglue,
                    policy=policy_for(Precision.BF16), full=full)

            ref = single(slice(0, PAR_BATCH))
            # each data row's pairs alone on one device: the shard's own batch
            rows = [single(slice(i * per, (i + 1) * per)) for i in range(2)]
        if want_exit is not None and ref.exit_layer.tolist() != [want_exit] * PAR_BATCH:
            raise AssertionError(f"adaptive {label}: single-device exits {ref.exit_layer.tolist()}"
                                 f", the pinned setup wants {want_exit}")
        lens = torch.cat([ref.lengths0, ref.lengths1])
        half = BUCKET // 2
        if "half-width" in label and int(lens.max()) > half // 2:
            raise AssertionError(f"adaptive {label}: survivors {lens.tolist()} not deep inside "
                                 "the half bucket")
        if "full-width" in label and int(lens.min()) <= half:
            raise AssertionError(f"adaptive {label}: survivors {lens.tolist()} pruned below half")
        for k, name in enumerate(got._fields):  # against the shards' own batches: exact
            compare(f"adaptive {label} {name} vs each data row alone", got[k],
                    torch.cat([r[k] for r in rows]), 0, 0, exact=True)
        compare(f"adaptive {label} exit_layer vs the batch of {PAR_BATCH}", got.exit_layer,
                ref.exit_layer, 0, 0, exact=True)
        flips = adaptive_flips(label, got, ref)
        for k, name in enumerate(got._fields):  # a pair's result is its own: bit for bit
            compare(f"adaptive {label} {name} vs the batch of {PAR_BATCH}", got[k], ref[k], 0, 0,
                    exact=True)
        summary["adaptive"][label] = dict(exits=ref.exit_layer.tolist(),
                                          lengths0=ref.lengths0.tolist(), keep_flips=flips,
                                          max_abs_err=0.0)
        log(f"  adaptive {label} over 2 x 2: exits {got.exit_layer.tolist()}, lengths0 "
            f"{got.lengths0.tolist()}; every field equal to each data row's pairs alone and to "
            f"the batch of {PAR_BATCH}: {flips} keep flips")

    # ---- two processes on the card, then NCCL at world size 1 -----------------
    log("two ranks spawned on cuda:0 (gloo): barrier, match step at 2 x 1 and 1 x 2 (the model "
        f"axis across the processes), a sharded ContinuousBatcher on {BATCHER_PAIRS} pairs")
    inputs = [a[:2].cpu().numpy() for a in args]
    t = time.perf_counter()
    ranks = two_process_checks(inputs)
    for rank, out in sorted(ranks.items()):
        log(f"  rank {rank}: {json.dumps(out)}")
    log(f"  both ranks done in {time.perf_counter() - t:.1f} s")
    summary["two_processes"] = ranks
    summary["nccl_world_one_barrier"] = nccl_world_one(dev)
    log(json.dumps({"parallel": summary}))


def ring_int8(at, counters, img0, img1):
    """forward_ring at INT8 (weight-only, whatever LGTPU_W8A8 says) on
    [cuda:0] x 4 at full width on the 2048-keypoint extractions, once
    against the same loop on the plain step."""
    import dataclasses

    import numpy as np
    import torch

    from lightglue_tpu_torch.kernels import layer_stack as ls
    from lightglue_tpu_torch.models.lightglue import forward_ring
    from lightglue_tpu_torch.precision import Precision
    from lightglue_tpu_torch.runtime.session import MatcherSession

    counters = counters + [ls.row_quant, ls.adaptive_decide, at.fused_mha,
                           at.bidirectional_cross_attention, at.flash_attention,
                           at.flash_attention_step]
    cfg = dataclasses.replace(pb_configs()["2048-keypoint"], precision=Precision.INT8)
    session = MatcherSession(config=cfg, device="cuda")
    ext = counted_extract(session, counters, img0, img1, "ring int8")
    e0, e1 = ext.slice(0, 1), ext.slice(1, 2)
    inputs = (e0.keypoints_norm[:, :RING_N], e1.keypoints_norm[:, :RING_N],
              e0.descriptors[:, :RING_N], e1.descriptors[:, :RING_N],
              torch.clamp(e0.count, max=RING_N), torch.clamp(e1.count, max=RING_N))
    devices = [torch.device("cuda", 0)] * RING

    def ring_call(step=at.flash_attention_step):
        with torch.inference_mode():
            return forward_ring(session.lg_params, *inputs, devices=devices, step=step,
                                config=cfg.lightglue, policy=session.policy)

    log(f"forward_ring, INT8, {RING_N}x{RING_N} on [cuda:0] x {RING}, {N_LAYERS} layers")
    with w8a8_env(True):  # the ring runs weight-only whatever the switch says
        ring_call()
        for fn in counters:
            fn.launches = 0
        out = ring_call()
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"  launches in one forward_ring: {launches}")
    bad = {k: v for k, v in launches.items()
           if v != (STEP_LAUNCHES if k == "flash_attention_step" else 0)}
    if bad:
        raise AssertionError(f"forward_ring int8: launches {bad}")
    plain = ring_call(at.flash_attention_step_plain)
    for i, (g, w) in enumerate(((out.desc0, plain.desc0), (out.desc1, plain.desc1))):
        if g.dtype != torch.bfloat16:
            raise AssertionError(f"forward_ring int8: d{i} is {g.dtype}")
        compare(f"forward_ring int8 d{i} vs the plain step", g, w, **STACK_TOL["bf16"])
    if not torch.isfinite(out.scores).all():
        raise AssertionError("forward_ring int8: scores not finite")
    mk, mp = (mutual_matches(x.scores, RING_N, RING_N) for x in (out, plain))
    log(f"  scores vs the plain step: max_abs_err {float((out.scores - plain.scores).abs().max()):.3e}"
        f"; mutual nearest neighbours {len(mk)} / {len(mp)}, IoU "
        f"{len(mk & mp) / max(1, len(mk | mp)):.4f}")


# ---- phase 10: exported programs reloaded in a fresh process ---------------

AOT_DIR = ROOT / "build" / "aot_smoke"  # under build/, which git ignores


def aot_configs(weights):
    """Phase 10's match programs: (label, PipelineConfig, LightGlue weights
    or None for the seed's, LGTPU_W8A8, bucket); each is exported at the
    bucket's diagonal, batch 1."""
    import dataclasses

    from lightglue_tpu_torch.config import LightGlueConfig, PipelineConfig
    from lightglue_tpu_torch.precision import Precision

    base = weights.init_lightglue(0, LightGlueConfig())
    adaptive = PipelineConfig(lightglue=LightGlueConfig(depth_confidence=0.95,
                                                        width_confidence=0.99))
    downshift = PipelineConfig(lightglue=LightGlueConfig(depth_confidence=0.95,
                                                         width_confidence=0.99, downshift_layer=4))
    default = PipelineConfig()
    return [("BF16 fixed depth", default, None, False, BUCKET),
            ("W8A8 fixed depth", dataclasses.replace(default, precision=Precision.INT8), None,
             True, BUCKET),
            ("FP32 fixed depth", dataclasses.replace(default, precision=Precision.FP32), None,
             False, BUCKET),
            ("BF16 adaptive exit 3", adaptive, pinned_exit_weights(base, 3), False, BUCKET),
            ("BF16 adaptive pruning, downshift 4", downshift, prune_weights(base), False, BUCKET),
            ("BF16 2048-keypoint", pb_configs()["2048-keypoint"], None, False, PB_BUCKET)]


def same_tree(label, got, want):
    """Two outputs equal bit for bit: the same structure and types (the
    namedtuples by name), every tensor of the same dtype and shape with
    equal bytes."""
    import torch
    import torch.utils._pytree as pytree

    gl, gs = pytree.tree_flatten(got)
    wl, ws = pytree.tree_flatten(want)
    names = [type(t).__name__ for t in (got if isinstance(got, tuple) else (got,))]
    want_names = [type(t).__name__ for t in (want if isinstance(want, tuple) else (want,))]
    if str(gs) != str(ws) or names != want_names:
        raise AssertionError(f"{label}: output structure {names} {gs} != {want_names} {ws}")
    for i, (g, w) in enumerate(zip(gl, wl)):
        if g.dtype != w.dtype or g.shape != w.shape or not g.reshape(-1).view(
                torch.uint8).equal(w.reshape(-1).view(torch.uint8)):
            raise AssertionError(f"{label}: output leaf {i} ({g.dtype} {tuple(g.shape)}) differs "
                                 "from the eager body's")


def aot_checks(weights, img0, img1, counters):
    """Phase 10, ``runtime/aot.py`` on the card: on ``cuda:0`` the extraction
    at 480x640 and the match at the diagonal of each ``aot_configs`` row are
    exported into ``AOT_DIR`` (no wrapper count moves during an export: it
    traces the fake implementations); then a fresh process with an empty
    kernel cache loads the BF16 program and calls it once (cold start: build,
    load, first call), and another, on the kernel directory this process
    loaded from, loads every program and runs it on the inputs saved here
    (``aot_worker``, which imports nothing of the package but
    ``runtime.aot``). Every output equals the session's eager body on the
    same inputs bit for bit; the loaded program's launches, counted by the
    wrappers and from profiler traces by kernel name, equal the eager call's
    wrapper counts; the warm process builds nothing. Prints an {"aot": ...}
    line: export seconds per program, cold and warm start, and ms a pair of
    the loaded BF16 program beside the session's graph and eager bodies."""
    import shutil

    import numpy as np
    import torch
    import torch.utils._pytree as pytree

    from lightglue_tpu_torch.kernels import _build
    from lightglue_tpu_torch.runtime import aot
    from lightglue_tpu_torch.runtime.session import MatcherSession

    shutil.rmtree(AOT_DIR, ignore_errors=True)
    AOT_DIR.mkdir(parents=True)
    summary = {"export_s": {}, "eager_launches": {}}
    specs = []

    def counted(label, fn):
        for c in counters:
            c.launches = 0
        with torch.inference_mode():
            out = fn()
        torch.cuda.synchronize()
        summary["eager_launches"][label] = {c.__name__: c.launches for c in counters
                                            if c.launches}
        return pytree.tree_map_only(torch.Tensor, lambda t: t.cpu(), out)

    def exported(label, export):
        before = [c.launches for c in counters]
        t = time.perf_counter()
        path = export()
        summary["export_s"][label] = round(time.perf_counter() - t, 3)
        if [c.launches for c in counters] != before:
            raise AssertionError(f"{label}: the export moved a wrapper's launch count")
        return path

    wants = {}
    ext_label = "BF16 extraction {}x{}".format(*img0.shape[:2])
    for label, cfg, tree, w8, bucket in aot_configs(weights):
        slug = label.lower().replace(" ", "_").replace(",", "")
        log(f"export the match step, {label}, {bucket}x{bucket}, batch 1")
        with w8a8_env(w8):
            session = MatcherSession(lg_params=tree, config=cfg, device="cuda")
            ext = session.extract(np.stack([img0, img1]))
            inputs = tuple(t.contiguous() for t in (
                ext.keypoints_norm[:1, :bucket], ext.keypoints_norm[1:, :bucket],
                ext.descriptors[:1, :bucket], ext.descriptors[1:, :bucket], ext.count[:1],
                ext.count[1:]))
            path = exported(label, lambda: aot.export_matcher(
                session, str(AOT_DIR / slug), pairs=[(bucket, bucket)])[(bucket, bucket)])
            wants[label] = counted(label, lambda: session._match_eager(False, *inputs))
            specs.append(dict(label=label, path=path, inputs=str(AOT_DIR / f"{slug}.in.pt")))
            torch.save((session.lg_params, *inputs), specs[-1]["inputs"])
            if label == "BF16 fixed depth":  # the session's runner of this key and its body
                with torch.inference_mode():
                    run = session._match_fn(bucket, bucket, False, 1)
                    summary["session_graph_ms"] = host_ms(lambda: run(*inputs))
                    summary["session_eager_ms"] = host_ms(
                        lambda: session._match_eager(False, *inputs))
                ext_path = exported(ext_label, lambda: aot.export_extractor(
                    session, str(AOT_DIR / slug), img0.shape[:2]))
                image = torch.from_numpy(img0[None]).cuda()
                wants[ext_label] = counted(ext_label, lambda: session._extract_eager(image))
                specs.append(dict(label=ext_label, path=ext_path,
                                  inputs=str(AOT_DIR / "extract.in.pt")))
                torch.save((session.sp_params, image), specs[-1]["inputs"])
        log(f"  {summary['export_s'][label]:.2f} s; eager launches "
            f"{summary['eager_launches'][label]}")
        del session
    for spec in specs:
        spec["want"] = summary["eager_launches"][spec["label"]]
        spec["out"] = str(AOT_DIR / (Path(spec["inputs"]).stem + ".out.pt"))

    def worker(mode, kernel_dir):
        spec_path = AOT_DIR / f"{mode}.json"
        spec_path.write_text(json.dumps(dict(kernel_dir=str(kernel_dir), programs=specs)))
        t = time.perf_counter()
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--aot-load",
                              str(spec_path), mode], capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t
        if out.returncode:
            raise AssertionError(f"aot worker ({mode}) failed:\n{out.stdout[-4000:]}\n"
                                 f"{out.stderr[-4000:]}")
        report = json.loads(out.stdout.strip().splitlines()[-1])
        report["process_s"] = round(wall, 3)
        return report

    log("a fresh process, empty kernel cache: import runtime.aot, load the BF16 program, "
        "one call (cold start)")
    cold = worker("cold", AOT_DIR / "kernels_cold")
    if cold["builds"] != 1:
        raise AssertionError(f"cold start ran {cold['builds']} builds, want 1")
    log(f"  {cold}")
    log(f"a fresh process on this process's kernel directory ({_build.BUILD_DIR}): every "
        "program loaded and run on the saved inputs (warm start)")
    warm = worker("warm", _build.BUILD_DIR)
    if warm["builds"] != 0:
        raise AssertionError(f"the warm process ran {warm['builds']} builds")
    for spec in specs:
        label = spec["label"]
        got = torch.load(spec["out"], weights_only=False)
        same_tree(f"loaded {label}", got, wants[label])
        counts, traced_counts = warm["programs"][label]
        if counts != spec["want"]:
            raise AssertionError(f"loaded {label}: wrapper launches {counts}, eager {spec['want']}")
        hold_launches(f"loaded {label}", traced_counts, spec["want"])
        log(f"  loaded {label}: bit for bit the eager body; launches {counts} (traced equal)")
    summary.update(cold_start={k: v for k, v in cold.items() if k != "programs"},
                   warm_start={k: v for k, v in warm.items() if k != "programs"})
    log(f"  BF16 match step at {BUCKET}x{BUCKET}, ms a pair: loaded program "
        f"{warm['loaded_ms']:.3f}, session graph {summary['session_graph_ms']:.3f}, session "
        f"eager {summary['session_eager_ms']:.3f}")
    log(json.dumps({"aot": summary}))


def aot_worker(spec_path: str, mode: str) -> int:
    """``aot_checks``' fresh process: imports nothing of the package but
    ``runtime.aot``, points its kernel cache at the spec's directory, loads
    the programs and runs each on its saved inputs. ``cold``: the first
    program only, one call. ``warm``: every program, its outputs saved, its
    launches counted by the wrappers and from profiler traces, the BF16
    program's ms a pair. Prints one JSON line."""
    t0 = time.perf_counter()
    import torch
    import torch.utils._pytree as pytree

    if any(m.startswith("lightglue_tpu") for m in sys.modules):
        raise AssertionError("the worker found the package imported before runtime.aot")
    from lightglue_tpu_torch.runtime import aot

    report = dict(import_s=round(time.perf_counter() - t0, 3))
    spec = json.loads(Path(spec_path).read_text())
    counters = (aot.stem.relu_conv1a_shift, aot.conv.conv3x3, aot.conv_chain.conv2_chain,
                aot.nms.nms_candidates, aot.layer_stack.linear, aot.layer_stack.row_quant,
                aot.layer_stack.attention, aot.layer_stack.ln_gelu,
                aot.layer_stack.adaptive_decide, aot.attention.fused_mha,
                aot.attention.bidirectional_cross_attention, aot.attention.flash_attention,
                aot.attention.flash_attention_step)
    aot.enable_compile_cache(spec["kernel_dir"])
    programs = spec["programs"] if mode == "warm" else [
        p for p in spec["programs"] if p["label"] == "BF16 fixed depth"]
    report["programs"] = {}
    for i, program in enumerate(programs):
        t = time.perf_counter()
        call = aot.load_exported(program["path"])
        args = torch.load(program["inputs"], weights_only=False)
        load_s = time.perf_counter() - t
        for c in counters:
            c.launches = 0
        t = time.perf_counter()
        out = call(*args)
        torch.cuda.synchronize()
        if i == 0:  # this process's start: import, load, first call (a build where cold)
            report.update(load_s=round(load_s, 3), first_call_s=round(time.perf_counter() - t, 3),
                          start_s=round(time.perf_counter() - t0, 3))
        counts = {c.__name__: c.launches for c in counters if c.launches}
        if mode == "cold":
            break
        torch.save(pytree.tree_map_only(torch.Tensor, lambda x: x.cpu(), out), program["out"])
        _, traced_counts = traced(lambda: call(*args), TRACES, program["want"])
        report["programs"][program["label"]] = (counts, traced_counts)
        if program["label"] == "BF16 fixed depth":
            report["loaded_ms"] = host_ms(lambda: call(*args))
    report["builds"] = aot._build.builds
    print(json.dumps(report), flush=True)
    return 0


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from lightglue_tpu_torch.config import LightGlueConfig, PipelineConfig, SuperPointConfig
    from lightglue_tpu_torch.kernels import _build
    from lightglue_tpu_torch.kernels import attention as at
    from lightglue_tpu_torch.kernels import conv as conv_k
    from lightglue_tpu_torch.kernels import conv_chain as cc
    from lightglue_tpu_torch.kernels import layer_stack as ls
    from lightglue_tpu_torch.kernels import nms as nms_k
    from lightglue_tpu_torch.kernels import stem as stem_k
    from lightglue_tpu_torch.parallel import ring
    from lightglue_tpu_torch.precision import Precision, policy_for, precision_scope
    from lightglue_tpu_torch.runtime import weights
    from lightglue_tpu_torch.runtime.session import MatcherSession

    import torch.nn.functional as F

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.lib()
    log(f"build (nvcc, sm_90a, all sources in parallel): {time.perf_counter() - t0:.1f} s")
    tensor_core_check(_build.build())

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def fp32_scope():  # TF32 off, so plain fp32 products are true fp32
        return precision_scope(policy_for(Precision.FP32))

    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}

    conv_e = Entry("conv3x3", "src/lightglue_tpu_torch/csrc/conv3x3.cu",
                   "src/lightglue_tpu/kernels/conv.py:356")
    conv_fp32_e = Entry("conv3x3 (MIXED, FP32: fp32 operands, 3xTF32 on wgmma, "
                        "conv3x3_tf32_wgmma_kernel)",
                        "src/lightglue_tpu_torch/csrc/conv3x3.cu",
                        "src/lightglue_tpu/kernels/conv.py:356")
    nms_e = Entry("nms_candidates", "src/lightglue_tpu_torch/csrc/nms.cu",
                  "src/lightglue_tpu/kernels/nms.py:199")
    stem_e = Entry("relu_conv1a_shift", "src/lightglue_tpu_torch/csrc/stem.cu",
                   "src/lightglue_tpu/models/superpoint.py:56")
    stem_fp32_e = Entry("relu_conv1a_shift (MIXED, FP32: fp32 image and out)",
                        "src/lightglue_tpu_torch/csrc/stem.cu",
                        "src/lightglue_tpu/models/superpoint.py:56")
    lin_e = Entry("linear", "src/lightglue_tpu_torch/csrc/linear.cu",
                  "src/lightglue_tpu/kernels/layer_stack.py:801")
    att_e = Entry("attention", "src/lightglue_tpu_torch/csrc/attention.cu",
                  "src/lightglue_tpu/kernels/layer_stack.py:801")
    ln_e = Entry("ln_gelu", "src/lightglue_tpu_torch/csrc/ln_gelu.cu",
                 "src/lightglue_tpu/kernels/layer_stack.py:801")
    # the FP32 rung's instantiations (3xTF32 on the tensor cores, or fp32 on
    # the FMA units): launches from its match_pair on each route (rung_end_to_end),
    # flash_attention's from its own call, the step's from the FP32 forward_ring
    src, ref = "src/lightglue_tpu_torch/csrc/", "src/lightglue_tpu/kernels/"
    fp32_ents = {
        "linear": Entry("linear (FP32: fp32 operands, 3xTF32)", src + "linear.cu",
                        ref + "layer_stack.py:801"),
        "attention": Entry("attention (FP32: fp32 operands, 3xTF32 on wgmma, "
                           "attention_tf32_wgmma_kernel)", src + "attention.cu",
                           ref + "layer_stack.py:801"),
        "ln_gelu": Entry("ln_gelu (FP32)", src + "ln_gelu.cu", ref + "layer_stack.py:801"),
        "adaptive_decide": Entry("adaptive_decide (FP32)", src + "adaptive.cu",
                                 ref + "layer_stack.py:974"),
        "fused_mha": Entry("fused_mha (FP32: fp32 operands, 3xTF32)", src + "flash_attn.cu",
                           ref + "attention.py:687"),
        "bidirectional_cross_attention": Entry(
            "bidirectional_cross_attention (FP32: fp32 operands, 3xTF32 on wgmma, "
            "bidir_tf32_wgmma_kernel)", src + "bidir_cross.cu",
            ref + "attention.py:925"),
        "flash_attention": Entry("flash_attention (FP32: fp32 operands, 3xTF32)",
                                 src + "flash_attn.cu", ref + "attention.py:197"),
        "flash_attention_step": Entry("flash_attention_step (FP32: fp32 operands, 3xTF32)",
                                      src + "flash_attn.cu", ref + "attention.py:422"),
    }

    def rand(*shape, dtype=torch.float32, scale=1.0, uniform=False):
        f = torch.rand if uniform else torch.randn
        return (f(*shape, generator=gen, device=dev) * scale).to(dtype)

    # ---- conv3x3: conv1b+pool, conv2a, conv2b+pool at 2x480x640 ----------
    log("conv3x3 (per match_pair: conv1b+pool, conv2a, conv2b+pool, bf16 on BF16 and INT8, "
        "fp32 on MIXED and FP32; then edge tiles at 360x488)")
    conv_cases = [  # label, H, W, pool, timed
        ("conv1b+pool", 480, 640, True, True), ("conv2a", 240, 320, False, True),
        ("conv2b+pool", 240, 320, True, True),
        ("conv1b+pool 360x488", 360, 488, True, False), ("conv2a 180x244", 180, 244, False, False),
    ]
    for label, h, w, pool, timed in conv_cases:
        for tag, dt in dtypes.items():
            x = rand(2, h, w, 64, uniform=True, dtype=dt)
            wt = ((torch.rand(3, 3, 64, 64, generator=gen, device=dev) * 2 - 1) / 24).to(dt)
            b = (torch.rand(64, generator=gen, device=dev) * 2 - 1) / 24
            with fp32_scope():
                got = conv_k.conv3x3(x, wt, b, pool=pool)
                want = conv_k.conv3x3_plain(x, wt, b, pool)
                err = compare(f"{label} {tag}", got, want, **TOL[tag])
                if tag == "bf16":
                    rounding_witness(f"{label} {tag}", got, want,
                                     conv_wrong_designs(x, wt, b, pool))
                else:
                    conv_tf32_witness(conv_k, f"{label} {tag}", got, x, wt, b, pool)
            ent = conv_e if tag == "bf16" else conv_fp32_e
            ent.err(err)
            if not timed:
                continue
            lib = cudnn_conv(wt, b, dt, pool, True)
            xc = x.permute(0, 3, 1, 2)
            with fp32_scope():  # cuDNN's fp32 conv with TF32 off
                ms = cuda_ms(lambda: conv_k.conv3x3(x, wt, b, pool=pool))
                plain = cuda_ms(lambda: conv_k.conv3x3_plain(x, wt, b, pool))
                lib_ms = cuda_ms(lambda: lib(xc))
            oh, ow = (h // 2, w // 2) if pool else (h, w)
            nbytes = x.element_size() * (2 * h * w * 64 + 9 * 64 * 64 + 2 * oh * ow * 64) + 4 * 64
            flops = 2 * 2 * h * w * 64 * 64 * 9
            ent.add(f"{label} {tag}", 1, ms, plain, lib_ms, nbytes, flops,
                    BF16_FLOP_PER_MS if tag == "bf16" else TF32X3_OP_PER_MS)

    # ---- nms_candidates: 2x480x640, edge bands, radii, caps, ties ----------
    log("nms_candidates (per match_pair: one launch over 2x480x640; then edge bands, radius 2, "
        "caps 1 and 8, a map below the border value, ties across band edges)")
    nms_checks(nms_k, gen, dev)  # exact: max_abs_err stays 0
    raw = nms_map(gen, dev, 2, 480, 640)
    ms = cuda_ms(lambda: nms_k.nms_candidates(raw))
    plain = cuda_ms(lambda: nms_k.nms_candidates_plain(raw))
    ncand = raw.numel() // 16
    # ops: 5 separable radius-4 max-pools (2 x 8 compares each) + 4 rounds
    nms_e.add("2x480x640", 1, ms, plain, None, 4 * raw.numel() + 8 * ncand,
              raw.numel() * (20 * 4 + 4), FP32_OP_PER_MS)

    # ---- relu_conv1a_shift: conv1a's tap stem, bf16 and fp32 -----------------
    log("relu_conv1a_shift (per match_pair: one launch over 2x480x640; bf16 on BF16 and INT8, "
        "fp32 on MIXED and FP32; then edge tiles at 360x488 and 480x600)")
    stem_checks(stem_k, gen, dev, fp32_scope, stem_e, stem_fp32_e)

    # ---- linear: every projection of one layer of a 1024x1024 pair -------
    plan_checks(ls, at, nms_k, conv_k, cc, _build.lib())
    log(f"linear (per match_pair: 16 launches per layer x {N_LAYERS} layers, N={BUCKET})")
    e = 256
    m = BUCKET
    # (label, K1, K2 (second operand), N, residual, launches per layer)
    lin_cases = [("self qkv", e, 0, 3 * e, False, 2), ("out", e, 0, e, False, 4),
                 ("ffn1 cat", e, e, 2 * e, False, 4), ("ffn2 +res", 2 * e, 0, e, True, 4),
                 ("cross qk_v", e, 0, 2 * e, False, 2)]
    for label, k1, k2, n, res, per_layer in lin_cases:
        for tag, dt in dtypes.items():
            a = rand(1, m, k1, dtype=dt)
            a2 = rand(1, m, k2, dtype=dt) if k2 else None
            w = ((torch.rand(k1 + k2, n, generator=gen, device=dev) * 2 - 1)
                 / math.sqrt(k1 + k2)).to(dt)
            b = ((torch.rand(n, generator=gen, device=dev) * 2 - 1) / math.sqrt(k1 + k2)).to(dt)
            r = rand(1, m, n, dtype=dt) if res else None
            with fp32_scope():
                got = ls.linear(a, w, b, a2=a2, residual=r)
                want = ls.linear_plain(a, w, b, a2, r)
                err = compare(f"{label} {tag}", got, want, **TOL[tag])
                if tag == "fp32" and res:  # 3xTF32 against float64, one TF32 product wrong
                    tf32_witness(f"{label} {tag}", got,
                                 (a.double() @ w.double() + b.double()) + r.double(),
                                 ls.linear_plain(tf32_round(a), tf32_round(w), b, None, r))
            ent = lin_e if tag == "bf16" else fp32_ents["linear"]
            ent.err(err)
            a_cat = a if a2 is None else torch.cat([a, a2], -1)
            with fp32_scope():  # the fp32 addmm in true fp32, TF32 off
                ms = cuda_ms(lambda: ls.linear(a, w, b, a2=a2, residual=r))
                plain = cuda_ms(lambda: ls.linear_plain(a, w, b, a2, r))
                lib_ms = cuda_ms(lambda: torch.addmm(b, a_cat[0], w))
            nbytes = a.element_size() * (m * (k1 + k2) + (k1 + k2) * n + n
                                         + m * n * (2 if res else 1))
            flops = 2 * m * (k1 + k2) * n
            ent.add(f"{label} {tag}", per_layer * N_LAYERS, ms, plain, lib_ms, nbytes, flops,
                    BF16_FLOP_PER_MS if tag == "bf16" else TF32X3_OP_PER_MS)

    # ---- attention: self (RoPE) and cross at 1024, masked, length 0 -------
    log(f"attention (per match_pair: 4 launches per layer x {N_LAYERS} layers, N={BUCKET})")
    heads, hd = 4, 64

    def freqs_for(bsz, n):
        ang = rand(bsz, n, hd // 2, scale=2.0)
        emb = torch.stack([torch.cos(ang), torch.sin(ang)], dim=1)
        return torch.cat([emb, emb], dim=-1).contiguous()

    att_cases = [
        # label, Nq, Nk, rope, lengths (q, kv) or None, per-layer launches,
        # stats (None: the operands' dtype; bf16: fp32 operands with bf16
        # stats only)
        ("self rope", BUCKET, BUCKET, True, None, 2, None),
        ("cross", BUCKET, BUCKET, False, None, 2, None),
        ("self masked", 768, 768, True, ([700], [700]), 0, None),
        ("cross masked 768x1024", 768, BUCKET, False, ([700], [900]), 0, None),
        ("cross length 0", 256, 512, False, ([0], [0]), 0, None),
        ("self rope masked, bf16 stats", 768, 768, True, ([700], [650]), 0, "bf16"),
    ]
    for label, nq, nk, rope, lens, per_layer, stats in att_cases:
        for tag, dt in dtypes.items():
            if stats and tag != "fp32":
                continue
            sdt = torch.bfloat16 if stats else dt
            if rope:  # q, k, v as column slices of one qkv projection
                qkv = rand(1, nq, 3 * e, dtype=dt)
                q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
                f = freqs_for(1, nq)
            else:
                q = rand(1, nq, e, dtype=dt)
                kv = rand(1, nk, 2 * e, dtype=dt)
                k, v = kv[..., :e], kv[..., e:]
                f = None
            lq = lk = None
            if lens:
                lq = torch.tensor(lens[0], dtype=torch.int32, device=dev)
                lk = torch.tensor(lens[1], dtype=torch.int32, device=dev)
            with fp32_scope():
                got = ls.attention(q, k, v, f, lq, lk, heads, sdt)
                want = ls.attention_plain(q, k, v, f, lq, lk, heads, sdt)
                err = compare(f"{label} {tag}", got, want, **TOL["bf16" if stats else tag])
                if tag == "bf16":
                    rounding_witness(f"{label} {tag}", got, want,
                                     stack_wrong_designs(q, k, v, f, lq, lk, heads))
                elif per_layer:  # 3xTF32 against float64, one TF32 product the wrong design
                    stack_tf32_witness(ls, f"{label} {tag}", got, q, k, v, f, heads)
            if lens and lens[0][0] == 0 and float(got.float().abs().max()) != 0.0:
                raise AssertionError(f"{label} {tag}: length-0 rows are not exactly 0")
            if stats:  # not the FP32 rung's row: its error is logged above
                continue
            ent = att_e if tag == "bf16" else fp32_ents["attention"]
            ent.err(err)
            if not per_layer:
                continue
            qh = q.reshape(1, nq, heads, hd).transpose(1, 2)
            kh = k.reshape(1, nk, heads, hd).transpose(1, 2)
            vh = v.reshape(1, nk, heads, hd).transpose(1, 2)
            with fp32_scope():  # fp32 SDPA with TF32 off
                ms = cuda_ms(lambda: ls.attention(q, k, v, f, lq, lk, heads, dt))
                plain = cuda_ms(lambda: ls.attention_plain(q, k, v, f, lq, lk, heads, dt))
                lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
            nbytes = (q.element_size() * (nq * e + 2 * nk * e + nq * e)
                      + (4 * 2 * nq * hd if rope else 0))
            flops = 4 * heads * nq * nk * hd
            # library: scaled_dot_product_attention, which does no RoPE
            ent.add(f"{label} {tag}", per_layer * N_LAYERS, ms, plain, lib_ms, nbytes, flops,
                    BF16_FLOP_PER_MS if tag == "bf16" else TF32X3_OP_PER_MS)

    # ---- ln_gelu: 1024 rows of 512 ----------------------------------------
    log(f"ln_gelu (per match_pair: 4 launches per layer x {N_LAYERS} layers, N={BUCKET})")
    for tag, dt in dtypes.items():
        h = rand(1, BUCKET, 2 * e, dtype=dt)
        g = (1 + 0.1 * rand(2 * e)).to(dt)
        bb = (0.1 * rand(2 * e)).to(dt)
        with fp32_scope():
            err = compare(f"ln_gelu {tag}", ls.ln_gelu(h, g, bb), ls.ln_gelu_plain(h, g, bb),
                          **TOL[tag])
        ent = ln_e if tag == "bf16" else fp32_ents["ln_gelu"]
        ent.err(err)
        ms = cuda_ms(lambda: ls.ln_gelu(h, g, bb))
        plain = cuda_ms(lambda: ls.ln_gelu_plain(h, g, bb))
        lib_ms = cuda_ms(lambda: F.gelu(F.layer_norm(h, (2 * e,), g, bb)))
        nbytes = h.element_size() * (2 * h.numel() + 4 * e)
        ent.add(f"1024x512 {tag}", 4 * N_LAYERS, ms, plain, lib_ms, nbytes, 20 * h.numel(),
                FP32_OP_PER_MS)
        ent.d["ffn_triple_ms"] = 4 * N_LAYERS * ffn_triple_ms(ls, dev, dt)
        log(f"  ffn1 -> ln_gelu -> ffn2 {tag} as the stack runs them: "
            f"{ent.d['ffn_triple_ms'] / (4 * N_LAYERS):.4f} ms a triple, "
            f"{ent.d['ffn_triple_ms']:.4f} ms per match_pair")
    ln_gelu_checks(ls, _build, dev, fp32_scope)

    # ---- the whole stack against its plain version, 9 layers -------------
    log(f"transformer_stack vs plain, L={N_LAYERS}")
    lg_np = weights.init_lightglue(0, LightGlueConfig(n_layers=N_LAYERS))
    for tag, dt in dtypes.items():
        layers = weights.params_from_numpy(lg_np, dev, dt)["layers"]
        for label, n0, n1, lens in (("1x1024x1024 unmasked", 1024, 1024, None),
                                    ("768x1024 lengths 700/900", 768, 1024, (700, 900))):
            d0, d1 = rand(1, n0, e, dtype=dt), rand(1, n1, e, dtype=dt)
            f0, f1 = freqs_for(1, n0), freqs_for(1, n1)
            l0 = l1 = None
            if lens:
                l0 = torch.tensor([lens[0]], dtype=torch.int32, device=dev)
                l1 = torch.tensor([lens[1]], dtype=torch.int32, device=dev)
            kw = dict(num_heads=heads, head_dim=hd, stat_dtype=dt, attn_dtype=dt)
            with fp32_scope():
                got = ls.transformer_stack(layers, d0, d1, f0, f1, l0, l1, **kw)
                want = ls.transformer_stack_plain(layers, d0, d1, f0, f1, l0, l1, **kw)
                for i in (0, 1):
                    compare(f"stack {label} {tag} d{i}", got[i], want[i], **STACK_TOL[tag])
            if tag == "bf16" and lens is None:
                def stack():
                    return ls.transformer_stack(layers, d0, d1, f0, f1, l0, l1, **kw)

                def stack_plain():
                    return ls.transformer_stack_plain(layers, d0, d1, f0, f1, l0, l1, **kw)

                log(f"  stack {label} bf16: kernel_ms {cuda_ms(stack, inner=2):.4f} "
                    f"(eager, launch overhead included: {eager_ms(stack):.4f}) "
                    f"plain_ms {cuda_ms(stack_plain, inner=2):.4f}")

    # ---- end to end: the main path ------------------------------------------
    log("MatcherSession(device='cuda').match_pair, default config, 480x640")
    img0, img1 = smooth_pair(0)
    session = MatcherSession(device="cuda")
    counters = [stem_k.relu_conv1a_shift, conv_k.conv3x3, nms_k.nms_candidates, ls.linear,
                ls.attention, ls.ln_gelu]
    result, counts, launches = first_call(counters, lambda: session.match_pair(img0, img1))
    log(f"  launches in the first match_pair {counts}, per call {launches}")
    want = dict(SP_LAUNCHES, linear=16 * N_LAYERS, attention=4 * N_LAYERS,
                ln_gelu=4 * N_LAYERS)
    if launches != want:
        raise AssertionError(f"main path launches per call {launches}, want {want}")
    for entry in (stem_e, conv_e, nms_e, lin_e, att_e, ln_e):
        entry.d["launches"] = counts[entry.d["name"]]
    n0, n1 = result["num_keypoints0"], result["num_keypoints1"]
    bucket = (session.config.bucket_for(max(n0, 1)), session.config.bucket_for(max(n1, 1)))
    for key in ("scores", "match_scores", "keypoints0", "keypoints1"):
        if not np.isfinite(result[key]).all():
            raise AssertionError(f"match_pair output {key} is not finite")
    if result["scores"].shape != bucket or n0 < 1 or n1 < 1:
        raise AssertionError(f"match_pair: scores {result['scores'].shape}, bucket {bucket}")
    times = []
    for _ in range(10):
        t = time.perf_counter()
        session.match_pair(img0, img1)  # returns host arrays: synchronised
        times.append((time.perf_counter() - t) * 1e3)
    pair_ms = statistics.median(times)
    log(f"  keypoints {n0}/{n1} bucket {bucket[0]}x{bucket[1]} matches {len(result['matches'])} "
        f"ms_per_pair median {pair_ms:.3f} (10 repeats, min {min(times):.3f})")
    profile_replay("main path", lambda: session.match_pair(img0, img1), pair_ms, launches,
                   attribute=True)
    extract_profile(session, img0, img1, "BF16")

    # ---- end to end against the port on the CPU, small FP32 pair ----------
    log("match_pair cuda vs cpu, FP32, 96x128, 2 layers, buckets (128, 256), threshold 0")
    cfg = PipelineConfig(superpoint=SuperPointConfig(max_num_keypoints=256),
                         lightglue=LightGlueConfig(n_layers=2), precision=Precision.FP32,
                         buckets=(128, 256), match_threshold=0.0, max_matches=256)
    s0, s1 = smooth_pair(1, 96, 128, 8, 12)
    rg = MatcherSession(config=cfg, seed=3, device="cuda").match_pair(s0, s1)
    rc = MatcherSession(config=cfg, seed=3, device="cpu").match_pair(s0, s1)

    mg = match_set(rg["matched_kpts0"], rg["matched_kpts1"])
    mc = match_set(rc["matched_kpts0"], rc["matched_kpts1"])
    iou = len(mg & mc) / max(1, len(mg | mc))
    perm = []  # cuda keypoint index of each cpu keypoint (order may differ at ties)
    for i in (0, 1):
        n = rc[f"num_keypoints{i}"]
        where = {tuple(p): j for j, p in enumerate(rg[f"keypoints{i}"][:n])}
        cpu_kp = [tuple(p) for p in rc[f"keypoints{i}"][:n]]
        if rg[f"num_keypoints{i}"] != n or set(cpu_kp) != where.keys():
            raise AssertionError(f"cuda vs cpu: keypoints of image {i} differ")
        perm.append([where[p] for p in cpu_kp])
    # log-assignment scores over the valid block: true fp32 on both sides,
    # sums in another order
    score_err = float(np.abs(rg["scores"][np.ix_(perm[0], perm[1])]
                             - rc["scores"][:len(perm[0]), :len(perm[1])]).max())
    log(f"  keypoints {rg['num_keypoints0']}/{rg['num_keypoints1']} (equal) matches cuda "
        f"{len(mg)} cpu {len(mc)} IoU {iou:.4f} scores max_abs_err {score_err:.3e} (atol 1e-3)")
    if not mc or iou <= 0.95 or score_err > 1e-3:
        raise AssertionError(f"cuda vs cpu: IoU {iou:.4f} (needs > 0.95), scores {score_err}")

    # ---- the adaptive path -------------------------------------------------
    dec_e = Entry("adaptive_decide", "src/lightglue_tpu_torch/csrc/adaptive.cu",
                  "src/lightglue_tpu/kernels/layer_stack.py:974")
    dec_mixed_e = Entry("adaptive_decide (MIXED: fp32 x, bf16 heads)",
                        "src/lightglue_tpu_torch/csrc/adaptive.cu",
                        "src/lightglue_tpu/kernels/layer_stack.py:974")
    adaptive_kernel_checks(ls, rand, freqs_for, dev, dtypes, fp32_scope,
                           {"bf16": dec_e, "mixed": dec_mixed_e,
                            "fp32": fp32_ents["adaptive_decide"]})
    decide_batch_checks(ls, dev)
    adaptive_stack_checks(ls, weights, rand, freqs_for, dev, dtypes, fp32_scope)
    adaptive_end_to_end(ls, counters, weights, img0, img1, dec_e)

    # ---- the per-block path: 2048-keypoint and pad-to-64 configurations ----
    fused_e = Entry("fused_mha (flash_wgmma_kernel)", "src/lightglue_tpu_torch/csrc/flash_attn.cu",
                    "src/lightglue_tpu/kernels/attention.py:687")
    bidir_e = Entry("bidirectional_cross_attention (bidir_wgmma_kernel)",
                    "src/lightglue_tpu_torch/csrc/bidir_cross.cu",
                    "src/lightglue_tpu/kernels/attention.py:925")
    flash_e = Entry("flash_attention (flash_wgmma_kernel)",
                    "src/lightglue_tpu_torch/csrc/flash_attn.cu",
                    "src/lightglue_tpu/kernels/attention.py:197")
    attention_kernel_checks(at, rand, freqs_for, dev, dtypes, fp32_scope, fused_e, bidir_e, flash_e,
                            fp32_ents)
    per_block_stack_checks(at, weights, rand, freqs_for, dev, dtypes, fp32_scope)
    per_block_end_to_end(at, counters, img0, img1, fused_e, bidir_e)

    # ---- the sequence split: forward_ring on a ring of one card -------------
    step_e = Entry("flash_attention_step (flash_wgmma_kernel)",
                   "src/lightglue_tpu_torch/csrc/flash_attn.cu",
                   "src/lightglue_tpu/kernels/attention.py:422")
    step_kernel_checks(at, dev, fp32_scope, step_e, fp32_ents["flash_attention_step"])
    ring_checks(at, ring, rand, dev, dtypes, fp32_scope)
    ring_inputs = ring_end_to_end(at, counters, img0, img1, step_e,
                                  fp32_ents["flash_attention_step"])
    ring_process_checks(ring_inputs)

    # ---- the conv variants that no path runs --------------------------------
    gen_e = Entry("conv3x3 (generic)", "src/lightglue_tpu_torch/csrc/conv3x3.cu",
                  "src/lightglue_tpu/kernels/conv.py:182")
    gen_fp32_e = Entry("conv3x3 (generic, fp32 operands)", "src/lightglue_tpu_torch/csrc/conv3x3.cu",
                       "src/lightglue_tpu/kernels/conv.py:182")
    chain_e = Entry("conv2_chain", "src/lightglue_tpu_torch/csrc/conv_chain.cu",
                    "src/lightglue_tpu/kernels/conv_chain.py:140")
    chain_fp32_e = Entry("conv2_chain (fp32 operands)", "src/lightglue_tpu_torch/csrc/conv_chain.cu",
                         "src/lightglue_tpu/kernels/conv_chain.py:140")
    generic_conv_checks(conv_k, rand, dev, dtypes, fp32_scope, gen_e, gen_fp32_e)
    conv_chain_checks(conv_k, cc, rand, dev, dtypes, fp32_scope, chain_e, chain_fp32_e)

    # ---- the MIXED and INT8 rungs (and W8A8) on every route ---------------------
    stack_src, stack_ref = "src/lightglue_tpu_torch/csrc/", "src/lightglue_tpu/kernels/"
    rung_ents = {
        "linear mixed": Entry("linear (MIXED: fp32 activations, bf16 products)",
                              stack_src + "linear.cu", stack_ref + "layer_stack.py:801"),
        "linear int8": Entry("linear (INT8 weight-only: int8 weights dequantized as staged)",
                             stack_src + "linear.cu", stack_ref + "layer_stack.py:801"),
        "linear w8a8": Entry("linear (W8A8: int8 x int8 GEMM)", stack_src + "linear.cu",
                             stack_ref + "layer_stack.py:801"),
        "row_quant": Entry("row_quant (W8A8: int8 activation rows)", stack_src + "linear.cu",
                           stack_ref + "layer_stack.py:801"),
        "attention mixed": Entry("attention (MIXED: fp32 stats and out)",
                                 stack_src + "attention.cu", stack_ref + "layer_stack.py:801"),
        "ln_gelu int8": Entry("ln_gelu (INT8: fp32 gamma/beta)", stack_src + "ln_gelu.cu",
                              stack_ref + "layer_stack.py:801"),
        "adaptive_decide mixed": dec_mixed_e,
        "relu_conv1a_shift mixed": stem_fp32_e,
        "conv3x3 mixed": conv_fp32_e,
        "fused_mha mixed": Entry("fused_mha (MIXED: fp32 out, flash_wgmma_kernel)",
                                 stack_src + "flash_attn.cu",
                                 stack_ref + "attention.py:687"),
        "bidirectional_cross_attention mixed": Entry(
            "bidirectional_cross_attention (MIXED: fp32 out, bidir_wgmma_kernel)",
            stack_src + "bidir_cross.cu",
            stack_ref + "attention.py:925"),
        "flash_attention mixed": Entry("flash_attention (MIXED: fp32 out, flash_wgmma_kernel)",
                                       stack_src + "flash_attn.cu", stack_ref + "attention.py:197"),
        **{f"{name} fp32": ent for name, ent in fp32_ents.items()},
    }
    rung_linear_checks(ls, rand, dev, fp32_scope, rung_ents)
    rung_stack_kernel_checks(ls, at, rand, freqs_for, dev, fp32_scope, rung_ents)
    rung_attention_checks(at, ls, rand, freqs_for, dev, fp32_scope, rung_ents)
    rung_stack_checks(ls, weights, rand, freqs_for, dev, fp32_scope)
    rung_end_to_end(ls, at, counters, img0, img1, rung_ents)
    ring_int8(at, counters, img0, img1)

    # ---- the session's per-bucket CUDA graphs on every configuration ---------
    session_graph_checks(weights, img0, img1)

    # ---- the entry points: demo, bench CLI, continuous batcher ---------------
    entry_point_checks(counters)

    # ---- the parallel path: data x model meshes, two processes, NCCL ----------
    tp_ents = {}
    for heads, mesh_txt in ((2, "2 x 2"), (1, "1 x 4")):
        tp_ents[("fused_mha", heads)] = Entry(
            f"fused_mha (TP shard, H={heads} local heads: the {mesh_txt} mesh; flash_wgmma_kernel)",
            src + "flash_attn.cu", ref + "attention.py:687")
        tp_ents[("bidirectional_cross_attention", heads)] = Entry(
            f"bidirectional_cross_attention (TP shard, H={heads} local heads: the {mesh_txt} mesh; "
            "bidir_wgmma_kernel)",
            src + "bidir_cross.cu", ref + "attention.py:925")
    parallel_checks(at, counters + [at.fused_mha, at.bidirectional_cross_attention], fp32_scope,
                    tp_ents)

    # ---- exported programs reloaded in a fresh process -------------------------
    aot_checks(weights, img0, img1, counters + [ls.row_quant, ls.adaptive_decide, at.fused_mha,
                                                at.bidirectional_cross_attention])

    log("the FP32 rows' products at three TF32 products each (495 TFLOP/s dense; their "
        "bound) and on the fp32 FMA units (67 TFLOP/s), per match_pair (flash_attention: per "
        "call; the step: per forward_ring)")
    for name in ("linear", "attention", "fused_mha", "bidirectional_cross_attention",
                 "flash_attention", "flash_attention_step"):
        ent = fp32_ents[name]
        log(f"  {ent.d['name']}: 3xTF32 floor {ent.ops / TF32X3_OP_PER_MS:.4f} ms, fp32 FMA "
            f"floor {ent.ops / FP32_OP_PER_MS:.4f} ms, kernel {ent.d['ms']:.4f} ms")

    entries = (stem_e, conv_e, nms_e, lin_e, att_e, ln_e, dec_e, fused_e, bidir_e, flash_e,
               step_e, gen_e, gen_fp32_e, chain_e, chain_fp32_e, *rung_ents.values(),
               *tp_ents.values())
    log(json.dumps({"kernels": [x.out() for x in entries]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--aot-load"]:  # phase 10's fresh process
        sys.exit(aot_worker(*sys.argv[2:4]))
    sys.exit(main())
