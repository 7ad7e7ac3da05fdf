#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check its kernels.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

It prints the card's name and power limit, builds the CUDA kernels of
``src/lightglue_tpu_torch/csrc`` (one nvcc per source, sm_90a, in
parallel) and checks in their SASS that the bf16 kernels of flash_attn.cu,
attention.cu and linear.cu run on the tensor cores and their fp32 ones do
not. Then, in order; every kernel check is in bf16 and fp32 against
the kernel's plain PyTorch version at the shapes its path gives it, every
path is driven with the launch counts set to 0 just before it and read just
after, and every kernel the JSON line lists is timed beside its bound, its
plain version and, where one exists, a PyTorch call for the same function:

1. The main path (default config: BF16, 9 layers, seed-0 random weights,
   480x640 pair): ``conv3x3`` (its 64->64 calls), ``nms_candidates``,
   ``linear``, ``attention`` and ``ln_gelu`` against their plain versions
   (``linear_plan`` / ``attention_plan`` against the card's launch rules;
   each bf16 ``attention`` case also against the rounding witness and its
   two wrong designs, ``stack_wrong_designs``); the layer stack at 9
   layers; ``MatcherSession(device="cuda").match_pair`` with its launch
   counts (144 / 36 / 36 for linear / attention / ln_gelu) and a profile; a
   small FP32 pair against the port on the CPU.
2. The adaptive path (``depth_confidence=0.95, width_confidence=0.99``):
   ``adaptive_decide`` (masked, unmasked, width with a partly retired keep
   state, pinned and random heads), the keep-masked and liveness operands,
   ``transformer_stack_adaptive`` at 9 layers (random weights, the exit-3
   weights, the pruning weights through the downshift at layer 4), and
   ``match_pair`` in those three weight setups.
3. The per-block path: ``fused_mha``, ``bidirectional_cross_attention`` and
   ``flash_attention`` (masked, ragged, zero lengths, several KV tiles,
   block_k 1000; each bf16-operand flash case also against the rounding
   witness, ``rounding_witness``), the
   per-block ``transformer_layers`` at 9 layers, and ``match_pair`` in the
   2048-keypoint config (``SuperPointConfig(max_num_keypoints=2048)``, a
   2048 bucket) and the pad-to-64 config (``buckets=range(64, 1025, 64)``,
   960 cap), mixed buckets (2048x1024, 960x64) and a two-pair
   ``match_batch``.
4. The sequence split: ``flash_attention_step`` (kv boundary inside the
   block, a block past kv_len and a stripe past q_len passing through
   exactly, 128-row and 120-row stripes, kv_len 0, blocks fitted to
   384-row stripes, unmasked; fp32 and bf16 stats; the witness on the
   finalised rows), ``ring_attention`` on ``[cuda:0] * P``
   for P = 2, 4, 8 against ``reference_attention`` and the plain step, and
   ``forward_ring`` on ``[cuda:0] * 4`` at full width (9 layers, E=256,
   H=4, stripes of 512) on the 2048-keypoint extractions of the pair, then
   ``filter_matches``: BF16 against the same loop on the plain step, with
   its launch counts, graph and eager times and a profile; FP32 against
   ``forward`` and its match set.
5. The conv variants that no path runs: the generic ``conv3x3`` at
   SuperPoint's C >= 128 layer shapes, and ``conv2_chain`` at the conv2
   shape against its plain version and the two-launch ``conv3x3`` chain.

It ends with a ``{"kernels": [...]}`` line (all ten Pallas functions) and
the ``{"ok": true, ...}`` line. Any failure raises and exits non-zero; so
does a missing card or a directory without the package.
"""

from __future__ import annotations

import json
import math
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
N_LAYERS = 9
BUCKET = 1024

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


# source: (its bf16 kernel, on the tensor cores; its fp32 kernel, on the FMA units)
TENSOR_CORE_KERNELS = {
    "flash_attn.cu": ("flash_mma_kernel", "flash_kernel"),
    "attention.cu": ("attention_mma_kernel", "attention_kernel"),
    "linear.cu": ("linear_mma_kernel", "linear_kernel"),
}


def tensor_core_check(build):
    """The bf16 instantiations of csrc/flash_attn.cu, attention.cu and
    linear.cu compute their products on the tensor cores (HMMA in the SASS
    of each), the fp32 ones on the FMA units (no HMMA): ``cuobjdump -sass``
    of the built library."""
    from lightglue_tpu_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build)], check=True, capture_output=True,
                          text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    for src, (bf16_kernel, fp32_kernel) in TENSOR_CORE_KERNELS.items():
        mma = [n for k, n in counts.items() if bf16_kernel in k]
        fma = [n for k, n in counts.items() if fp32_kernel in k]
        log(f"  {src} SASS: HMMA per bf16 kernel {sorted(mma)}, per fp32 kernel {sorted(fma)}")
        if not mma or min(mma) == 0 or not fma or max(fma) != 0:
            raise AssertionError(f"{src}: a bf16 kernel without HMMA or an fp32 one with it")


def rounding_witness(label, got, want, wrong):
    """The rounding-contract witness of the bf16 attention kernels: ``want``
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


def plan_checks(ls, lib):
    """The launch plans the CPU tests hold (``layer_stack.linear_plan``,
    ``attention_plan``) are the ones the card runs (csrc/linear.cu:
    linear_tile, csrc/mma.cuh:fill_row_groups), at every shape of the paths
    through the stack: 128-1024 buckets, one pair or two."""
    import ctypes

    tile = (ctypes.c_int * 2)()
    for m in (128, 256, 512, 768, 1024, 2048):
        for n in (256, 512, 768):
            lib.lg_linear_tile(m, n, tile)
            plan = ls.linear_plan(m, n, 256)
            if (tile[0], tile[1]) != (plan.bm, plan.bn):
                raise AssertionError(f"linear {m}x{n}: the card's tile {tile[0]}x{tile[1]}, "
                                     f"linear_plan's {plan.bm}x{plan.bn}")
    for b in (1, 2):
        for nq in (128, 256, 512, 768, 1024):
            groups = lib.lg_attention_row_groups(b, 4, nq)
            if groups != ls.attention_plan(b, 4, nq, 1024).row_groups:
                raise AssertionError(f"attention B={b} Nq={nq}: the card's {groups} row groups")
    log("  launch plans: linear_plan and attention_plan match the card's at every path shape")


class Entry:
    """Per-kernel accumulator for the ``kernels`` JSON line: times and bounds
    summed over the kernel's launches in one main-path match_pair."""

    def __init__(self, name, source, replaces):
        self.d = dict(name=name, route="cuda", source=source, replaces=replaces,
                      launches=0, max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                      bound_ms=0.0, library_ms=None)
        self._bytes_ms = self._ops_ms = 0.0

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


def profile_breakdown(call, pair_ms, top=12, what="match_pair"):
    """Device time by kernel over one profiled call (a match_pair). The busy
    share is that device time (kernels and copies, overlap ignored) over
    ``pair_ms``, the unprofiled ms per call: the profiler's own overhead
    stretches the profiled call's wall time by a varying amount."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
    rows = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True,
    )
    if not rows:
        log("  profile: no device time recorded (device breakdown not measured)")
        return
    busy = sum(r[0] for r in rows)
    log(f"  profile of one {what}: device_busy_ms {busy:.3f}, busy_share "
        f"{busy / pair_ms:.3f} of the unprofiled {pair_ms:.3f} ms")
    for ms, count, key in rows[:top]:
        log(f"    {ms:8.3f} ms x{count:<4d} {key[:100]}")


def adaptive_kernel_checks(ls, rand, freqs_for, dev, dtypes, fp32_scope, dec_e):
    """adaptive_decide, the keep-masked attention and the liveness operands
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

    for tag, dt in dtypes.items():
        x0, x1 = rand(1, n, e, dtype=dt), rand(1, n, e, dtype=dt)
        zeros = torch.zeros(e, dtype=dt, device=dev)
        spread = torch.randn(e, generator=gen, device=dev).to(dt)
        w_match = ((torch.rand(e, generator=gen, device=dev) * 2 - 1) / 16).to(dt)
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
            if tag == "bf16":
                dec_e.err(max(float((g - w).abs().max()) for g, w in zip(got[1], want[1])))
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
        if tag != "bf16":
            continue
        # timed at the adaptive main path's call: width, 1024/1024, all kept
        full_keep = prefix((n, n))
        kw = dict(w_tok=spread, b_tok=bias(0.0), depth_confidence=0.95, **width)

        def call(fn, layer):
            return lambda: fn(x0, x1, kw["w_tok"], kw["b_tok"], exit1.clone(), layer=layer,
                              n_layers=N_LAYERS, depth_confidence=0.95,
                              w_match=w_match, b_match=kw["b_match"], width_confidence=0.99,
                              keep0=full_keep[0].clone(), keep1=full_keep[1].clone())

        for label, layer, weight in (("mid layer", 4, N_LAYERS - 1), ("last layer", N_LAYERS - 1, 1)):
            ms = cuda_ms(call(ls.adaptive_decide, layer))
            plain = cuda_ms(call(ls.adaptive_decide_plain, layer))
            last = layer == N_LAYERS - 1
            nbytes = 4 if last else 2 * (2 * n * e + 2 * e) + 4 * 2 * (2 * n) + 8 + 4
            ops = 0 if last else 2 * 2 * (2 * n) * e
            # library: none, no single PyTorch call computes the decision
            dec_e.add(f"{label} width 1024x1024 bf16", weight, ms, plain, None, nbytes, ops,
                      FP32_OP_PER_MS)

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
        session.match_pair(img0, img1)  # warm
        for fn in counters:
            fn.launches = 0
        result = session.match_pair(img0, img1)
        launches = {fn.__name__: fn.launches for fn in counters}
        log(f"  launches in one match_pair: {launches}")
        for name, count in launches.items():
            if count < 1:
                raise AssertionError(f"{label}: kernel {name} did not launch")
        if label == "random weights":
            dec_e.d["launches"] = launches["adaptive_decide"]
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
        profile_breakdown(lambda: session.match_pair(img0, img1), pair_ms, top=8)


PB_BUCKET = 2048  # the 2048-keypoint config's cap bucket
PAD64 = 960       # the pad-to-64 config's cap bucket


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
                            flash_e):
    """fused_mha, bidirectional_cross_attention and flash_attention against
    their plain versions at the per-block path's shapes, masked, ragged,
    with zero lengths and with several KV tiles; the bf16 calls of the
    main per-block runs are timed."""
    import torch
    import torch.nn.functional as F

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
            if tag != "bf16":
                continue
            fused_e.err(err)
            if stats or (not weight and "pad-to-64" not in label):
                continue
            ms = cuda_ms(lambda: at.fused_mha(q, k, v, f, ln, **kw))
            plain = cuda_ms(lambda: at.fused_mha_plain(q, k, v, f, ln, **kw))
            lib_ms = cuda_ms(sdpa(q, k, v))
            nbytes = 2 * (b * nq * e + 2 * b * nk * e + b * nq * e) + (4 * b * 2 * nk * hd if rope else 0)
            flops = 4 * b * heads * nq * nk * hd
            if weight:  # library: scaled_dot_product_attention, which does no RoPE
                fused_e.add(f"{label} bf16", weight, ms, plain, lib_ms, nbytes, flops,
                            BF16_FLOP_PER_MS)
            else:
                log(f"  {label} bf16: kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms "
                    f"{lib_ms:.4f} bound_ms {max(nbytes / HBM_BYTES_PER_MS, flops / BF16_FLOP_PER_MS):.4f}"
                    f" x{N_LAYERS} per pad-to-64 match_pair")

    log(f"bidirectional_cross_attention (per pad-to-64 match_pair: 1 launch per layer "
        f"x {N_LAYERS} layers)")
    bidir_cases = [
        # label, B, N0, N1, lengths [n0, n1], per-pair launches
        ("960x960 unmasked", 1, PAD64, PAD64, None, N_LAYERS),
        ("960x960 ragged, n1 0", 2, PAD64, PAD64, [[900, 700], [960, 0]], 0),
        ("960x704 masked, n0 0", 2, PAD64, 704, [[950, 700], [0, 500]], 0),
        ("960x704 unmasked", 1, PAD64, 704, None, 0),
        ("960x64 masked (mixed buckets)", 1, PAD64, 64, [[955, 60]], 0),
    ]
    for label, b, n0, n1, lens, weight in bidir_cases:
        for tag, dt in dtypes.items():
            a0, a1 = rand(b, n0, 2 * e, dtype=dt), rand(b, n1, 2 * e, dtype=dt)
            args = (a0[..., :e], a1[..., :e], a0[..., e:], a1[..., e:])  # [qk | v] slices
            ln = None if lens is None else torch.tensor(lens, **i32)
            kw = dict(num_heads=heads, stat_dtype=dt)
            with fp32_scope():
                got = at.bidirectional_cross_attention(*args, ln, **kw)
                want = at.bidirectional_cross_attention_plain(*args, ln, **kw)
                errs = [compare(f"{label} {tag} o{i}", g, w, **TOL[tag])
                        for i, (g, w) in enumerate(zip(got, want))]
            if lens is not None:
                zero_rows(f"{label} {tag} o0", got[0], lens, True)
                zero_rows(f"{label} {tag} o1", got[1], [x[::-1] for x in lens], True)
            if tag != "bf16":
                continue
            bidir_e.err(max(errs))
            if not weight:
                continue
            ms = cuda_ms(lambda: at.bidirectional_cross_attention(*args, ln, **kw))
            plain = cuda_ms(lambda: at.bidirectional_cross_attention_plain(*args, ln, **kw))
            two = (sdpa(args[0], args[1], args[3]), sdpa(args[1], args[0], args[2]))
            sdpa2 = cuda_ms(lambda: (two[0](), two[1]()))
            log(f"  {label} bf16: two scaled_dot_product_attention calls (one per direction, "
                f"not one call): {sdpa2:.4f} ms")
            nbytes = 2 * (2 * b * (n0 + n1) * e + b * (n0 + n1) * e)
            flops = 6 * b * heads * n0 * n1 * hd  # one S and two P.V products
            # library: none, no single PyTorch call computes both directions
            bidir_e.add(f"{label} bf16", weight, ms, plain, None, nbytes, flops, BF16_FLOP_PER_MS)

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
            if lens is not None:
                zero_rows(f"{label} {tag}", got.transpose(1, 2), lens, True)
            if tag != "bf16":
                continue
            flash_e.err(err)
            if not timed:
                continue
            # the entry point's own path: one call, counted from 0
            for fn in (at.fused_mha, at.bidirectional_cross_attention, at.flash_attention):
                fn.launches = 0
            at.flash_attention(q, k, v, ln, **kw)
            flash_e.d["launches"] = at.flash_attention.launches
            log(f"  generic entry point, one call: flash_attention launches "
                f"{at.flash_attention.launches}")
            ms = cuda_ms(lambda: at.flash_attention(q, k, v, ln, **kw))
            plain = cuda_ms(lambda: at.flash_attention_plain(q, k, v, ln, **kw))
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            nbytes = 2 * (2 * b * heads * nq * hd + 2 * b * heads * nk * hd)
            flops = 4 * b * heads * nq * nk * hd
            flash_e.add(f"{label} bf16", 1, ms, plain, lib_ms, nbytes, flops, BF16_FLOP_PER_MS)


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

    def counted(fn):
        for c in counters:
            c.launches = 0
        out = fn()
        return out, {c.__name__: c.launches for c in counters}

    def check_launches(label, launches, b0, b1, extract):
        want = expected(b0, b1)
        want.update(linear=0, attention=0, ln_gelu=0, adaptive_decide=0, flash_attention=0)
        if want["fused_mha"] == 0:
            raise AssertionError(f"{label}: buckets {b0}x{b1} take the layer stack, not the "
                                 "per-block path")
        if extract:
            want.update(conv3x3=3, nms_candidates=1)
        bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
        if bad:
            raise AssertionError(f"{label}: launches (got, want) {bad}")

    for label, cfg in pb_configs().items():
        log(f"MatcherSession(device='cuda').match_pair, per-block, {label}, 480x640 BF16")
        session = MatcherSession(config=cfg, device="cuda")
        session.match_pair(img0, img1)  # warm
        result, launches = counted(lambda: session.match_pair(img0, img1))
        n0, n1 = result["num_keypoints0"], result["num_keypoints1"]
        bk = tuple(result["scores"].shape)
        log(f"  keypoints {n0}/{n1} buckets {bk[0]}x{bk[1]} matches {len(result['matches'])}")
        log(f"  launches in one match_pair: {launches}")
        check_launches(label, launches, *bk, True)
        if label == "2048-keypoint":
            fused_e.d["launches"] = launches["fused_mha"]
        else:
            bidir_e.d["launches"] = launches["bidirectional_cross_attention"]
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
        profile_breakdown(lambda: session.match_pair(img0, img1), pair_ms, top=8)

        # mixed buckets: image 1 cut to a smaller bucket's count
        ext = session.extract(np.stack([img0, img1]))
        ext0, ext1 = ext.slice(0, 1), ext.slice(1, 2)
        cut = 1000 if label == "2048-keypoint" else 60
        ext1 = ext1._replace(count=torch.clamp(ext1.count, max=cut))
        (out, matches), launches = counted(lambda: session.match_from_extractions(ext0, ext1))
        b0, b1 = out.scores.shape[1:]
        log(f"  mixed buckets {b0}x{b1}: launches {launches}, matches {int(matches.count[0])}")
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


def step_kernel_checks(at, rand, dev, fp32_scope, step_e):
    """flash_attention_step against its plain version at the ring path's
    shapes (B=1, H=4, 512-row stripes of a 2048 bucket): masked with the kv
    boundary inside the block, a block wholly past kv_len and a stripe past
    q_len (pass-through, exact), stripes of 128 rows of which some start
    past q_len, kv_len 0 from the first step's carries, 384-row blocks
    fitted to 192 (two tiles), 120-row stripes (a 960 bucket at ring 8, a
    tile that is not a multiple of 16), and unmasked; all three carries, in bf16 and
    fp32 operands with fp32 and bf16 stats. The main path's call (bf16
    operands, fp32 stats, full lengths) is timed."""
    import torch
    import torch.nn.functional as F

    heads, hd, n = 4, 64, RING_N // RING
    i32 = dict(dtype=torch.int32, device=dev)
    log(f"flash_attention_step (per forward_ring: {STEP_LAUNCHES} launches = {N_LAYERS} layers x "
        f"4 attentions x {RING}^2 ring steps, B=1 H=4 stripes of {n})")
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
                tag = "fp32" if otag == stag == "fp32" else "bf16"
                with fp32_scope():
                    got = at.flash_attention_step(*args, **kw)
                    want = at.flash_attention_step_plain(*args, **kw)
                    errs = [compare(f"{label} {otag} operands {stag} stats {c}", g, w, **TOL[tag])
                            for c, g, w in zip(("m", "l", "acc"), got, want)]
                    if otag == "bf16":  # the witness on the finalised rows
                        rounding_witness(
                            f"{label} {otag} operands {stag} stats, acc / l", finalised(got),
                            finalised(want), fine_block(lambda bk: finalised(
                                at.flash_attention_step_plain(*args, **dict(kw, block_k=bk))),
                                at._fit_block(size, block), size))
                if exact:
                    for c, g, w in zip(("m", "l", "acc"), got, (m, l, acc)):
                        compare(f"{label} {otag}/{stag} {c} passes through", g, w, 0, 0,
                                exact=True)
                if otag == "bf16":
                    step_e.err(max(errs))
    # timed: the main path's call, bf16 operands, fp32 stats, full lengths
    q, k, v = (rand(1, heads, n, hd, dtype=torch.bfloat16) for _ in range(3))
    m, l, acc = rand(1, heads, n, 1), 1.0 + rand(1, heads, n, 1, uniform=True), rand(1, heads, n, hd)
    ln = torch.tensor([[RING_N, RING_N]], **i32)
    args = (q, k, v, m, l, acc, ln, n, 2 * n)
    ms = cuda_ms(lambda: at.flash_attention_step(*args))
    plain = cuda_ms(lambda: at.flash_attention_step_plain(*args))
    sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    log(f"  scaled_dot_product_attention on the same 512x512 block (context; it merges no "
        f"carries): {sdpa:.4f} ms")
    # each operand read once; the three fp32 carries read and written once
    nbytes = 2 * 3 * heads * n * hd + 4 * 2 * (2 * heads * n + heads * n * hd)
    flops = 4 * heads * n * n * hd
    # library: none, no single PyTorch call merges a block into carries
    step_e.add(f"step 1x4x{n}x{n} bf16, fp32 stats", STEP_LAUNCHES, ms, plain, None, nbytes,
               flops, BF16_FLOP_PER_MS, per="forward_ring")


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


def ring_end_to_end(at, counters, img0, img1, step_e):
    """forward_ring at full width on the 2048-keypoint extractions of the
    480x640 pair, devices [cuda:0] * 4 (stripes of 512), 9 layers, then
    filter_matches. BF16: launch counts read from 0 around one call,
    against the same loop on the plain step, graph and eager times. FP32:
    against forward (the per-block route) and its match set at threshold 0."""
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

    for precision in ("bf16", "fp32"):
        session = MatcherSession(config=dataclasses.replace(cfg, precision=Precision(precision)),
                                 device="cuda")
        ext = session.extract(np.stack([img0, img1]))
        ext0, ext1 = ext.slice(0, 1), ext.slice(1, 2)
        n0, n1 = int(ext0.count[0]), int(ext1.count[0])
        if min(n0, n1) < RING_N:
            raise AssertionError(f"ring: keypoints {n0}/{n1}, want both at {RING_N}")
        inputs = (ext0.keypoints_norm[:, :RING_N], ext1.keypoints_norm[:, :RING_N],
                  ext0.descriptors[:, :RING_N], ext1.descriptors[:, :RING_N],
                  torch.clamp(ext0.count, max=RING_N), torch.clamp(ext1.count, max=RING_N))
        kw = dict(config=lgc, policy=session.policy)

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
        if precision == "bf16":
            step_e.d["launches"] = launches["flash_attention_step"]
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


GENERIC_CONVS = [
    # label, H, W, C_in, C_out, pool, relu: SuperPoint's C >= 128 layers at 2x480x640
    ("conv3a 120x160 64->128", 120, 160, 64, 128, False, True),
    ("conv3b 120x160 128->128 + pool", 120, 160, 128, 128, True, True),
    ("convDa 60x80 128->256", 60, 80, 128, 256, False, True),
    ("convDb 60x80 256->256 no ReLU", 60, 80, 256, 256, False, False),
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


def generic_conv_checks(conv_k, rand, dev, dtypes, fp32_scope, gen_e):
    """The generic conv3x3 (JAX conv.py:182) against its plain version at
    SuperPoint's C >= 128 layer shapes for a 2x480x640 batch, in bf16 and
    fp32 and with the other output dtype; the bf16 calls are timed."""
    import torch

    log("conv3x3, generic C_in/C_out (not on a path; the entry point's own calls)")
    for label, h, w, cin, cout, pool, relu in GENERIC_CONVS:
        for tag, dt in dtypes.items():
            x = rand(2, h, w, cin, uniform=True, dtype=dt)
            wt, b = conv_weights(rand, cin, cout, dt)
            other = torch.float32 if dt == torch.bfloat16 else torch.bfloat16
            for out_dt in (dt, other):
                kw = dict(relu=relu, out_dtype=out_dt)
                with fp32_scope():
                    got = conv_k.conv3x3(x, wt, b, pool, **kw)
                    want = conv_k.conv3x3_plain(x, wt, b, pool, **kw)
                    out_tag = "bf16" if torch.bfloat16 in (dt, out_dt) else "fp32"
                    err = compare(f"{label} {tag} -> {str(out_dt)[6:]}", got, want, **TOL[out_tag])
                if tag == "bf16" and out_dt == dt:
                    gen_e.err(err)
    # the entry point's own path: one call per shape, counted from 0
    conv_k.conv3x3.launches = 0
    timed = []
    for label, h, w, cin, cout, pool, relu in GENERIC_CONVS:
        x = rand(2, h, w, cin, uniform=True, dtype=torch.bfloat16)
        wt, b = conv_weights(rand, cin, cout, torch.bfloat16)
        conv_k.conv3x3(x, wt, b, pool, relu=relu)
        timed.append((label, h, w, cin, cout, pool, relu, x, wt, b))
    gen_e.d["launches"] = conv_k.conv3x3.launches
    log(f"  generic entry point, one call per shape: conv3x3 launches {conv_k.conv3x3.launches}")
    for label, h, w, cin, cout, pool, relu, x, wt, b in timed:
        ms = cuda_ms(lambda: conv_k.conv3x3(x, wt, b, pool, relu=relu))
        with fp32_scope():
            plain = cuda_ms(lambda: conv_k.conv3x3_plain(x, wt, b, pool, relu=relu))
        lib = cudnn_conv(wt, b, x.dtype, pool, relu)
        xc = x.permute(0, 3, 1, 2)
        lib_ms = cuda_ms(lambda: lib(xc))
        oh, ow = (h // 2, w // 2) if pool else (h, w)
        nbytes = 2 * (2 * h * w * cin + 9 * cin * cout + 2 * oh * ow * cout) + 4 * cout
        flops = 2 * 2 * h * w * cin * cout * 9
        gen_e.add(f"{label} bf16", 1, ms, plain, lib_ms, nbytes, flops, BF16_FLOP_PER_MS,
                  per="call of the four")


def conv_chain_checks(conv_k, cc, rand, dev, dtypes, fp32_scope, chain_e):
    """conv2_chain (JAX conv_chain.py:140) against its plain version and
    against the port's two-launch conv3x3 chain at the main path's conv2
    shape, 2x240x320x64, in bf16 and fp32, with and without conv2b's ReLU;
    the bf16 call is timed beside the two-launch chain."""
    import torch

    log("conv2_chain (not on a path: the model runs conv3x3 twice; 2x240x320x64)")
    h, w = 240, 320
    for tag, dt in dtypes.items():
        x = rand(2, h, w, 64, uniform=True, dtype=dt)
        wa, ba = conv_weights(rand, 64, 64, dt)
        wb, bb = conv_weights(rand, 64, 64, dt)
        for relu in (True, False):
            with fp32_scope():
                got = cc.conv2_chain(x, wa, ba, wb, bb, relu=relu)
                want = cc.conv2_chain_plain(x, wa, ba, wb, bb, relu=relu)
                err = compare(f"conv2_chain relu={relu} {tag}", got, want, **TOL[tag])
                two = conv_k.conv3x3(conv_k.conv3x3(x, wa, ba), wb, bb, True, relu=relu)
                compare(f"conv2_chain relu={relu} {tag} vs two conv3x3 launches", got, two,
                        **TOL[tag])
            if tag == "bf16":
                chain_e.err(err)
        if tag != "bf16":
            continue
        cc.conv2_chain.launches = 0
        cc.conv2_chain(x, wa, ba, wb, bb)
        chain_e.d["launches"] = cc.conv2_chain.launches
        log(f"  entry point, one call: conv2_chain launches {cc.conv2_chain.launches}")
        ms = cuda_ms(lambda: cc.conv2_chain(x, wa, ba, wb, bb))
        with fp32_scope():
            plain = cuda_ms(lambda: cc.conv2_chain_plain(x, wa, ba, wb, bb))
        two_ms = cuda_ms(lambda: conv_k.conv3x3(conv_k.conv3x3(x, wa, ba), wb, bb, True))
        conv2a, conv2b = (cudnn_conv(wa, ba, dt, False, True), cudnn_conv(wb, bb, dt, True, True))
        xc = x.permute(0, 3, 1, 2)
        lib_ms = cuda_ms(lambda: conv2b(conv2a(xc)))
        log(f"  the port's two-launch conv3x3 chain: {two_ms:.4f} ms")
        nbytes = 2 * (2 * h * w * 64 + 2 * 9 * 64 * 64 + 2 * (h // 2) * (w // 2) * 64) + 8 * 64
        flops = 2 * (2 * 2 * h * w * 64 * 64 * 9)
        # library: two cuDNN convs with bias and ReLU, and the pool
        chain_e.add("conv2a+conv2b+pool 2x240x320x64 bf16", 1, ms, plain, lib_ms, nbytes, flops,
                    BF16_FLOP_PER_MS, per="call")


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
    nms_e = Entry("nms_candidates", "src/lightglue_tpu_torch/csrc/nms.cu",
                  "src/lightglue_tpu/kernels/nms.py:199")
    lin_e = Entry("linear", "src/lightglue_tpu_torch/csrc/linear.cu",
                  "src/lightglue_tpu/kernels/layer_stack.py:801")
    att_e = Entry("attention", "src/lightglue_tpu_torch/csrc/attention.cu",
                  "src/lightglue_tpu/kernels/layer_stack.py:801")
    ln_e = Entry("ln_gelu", "src/lightglue_tpu_torch/csrc/ln_gelu.cu",
                 "src/lightglue_tpu/kernels/layer_stack.py:801")

    def rand(*shape, dtype=torch.float32, scale=1.0, uniform=False):
        f = torch.rand if uniform else torch.randn
        return (f(*shape, generator=gen, device=dev) * scale).to(dtype)

    # ---- conv3x3: conv1b+pool, conv2a, conv2b+pool at 2x480x640 ----------
    log("conv3x3 (per match_pair: conv1b+pool, conv2a, conv2b+pool)")
    conv_cases = [("conv1b+pool", 480, 640, True), ("conv2a", 240, 320, False),
                  ("conv2b+pool", 240, 320, True)]
    for label, h, w, pool in conv_cases:
        for tag, dt in dtypes.items():
            x = rand(2, h, w, 64, uniform=True, dtype=dt)
            wt = ((torch.rand(3, 3, 64, 64, generator=gen, device=dev) * 2 - 1) / 24).to(dt)
            b = (torch.rand(64, generator=gen, device=dev) * 2 - 1) / 24
            with fp32_scope():
                got = conv_k.conv3x3(x, wt, b, pool=pool)
                want = conv_k.conv3x3_plain(x, wt, b, pool)
                err = compare(f"{label} {tag}", got, want, **TOL[tag])
            if tag != "bf16":
                continue
            conv_e.err(err)
            xc = x.permute(0, 3, 1, 2)
            wc = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            bc = b.to(dt)

            def lib():
                y = F.relu(F.conv2d(xc, wc, bc, padding=1))
                return F.max_pool2d(y, 2) if pool else y

            ms = cuda_ms(lambda: conv_k.conv3x3(x, wt, b, pool=pool))
            with fp32_scope():
                plain = cuda_ms(lambda: conv_k.conv3x3_plain(x, wt, b, pool))
            lib_ms = cuda_ms(lib)
            oh, ow = (h // 2, w // 2) if pool else (h, w)
            nbytes = 2 * (2 * h * w * 64 + 9 * 64 * 64 + 2 * oh * ow * 64) + 4 * 64
            flops = 2 * 2 * h * w * 64 * 64 * 9
            conv_e.add(f"{label} bf16", 1, ms, plain, lib_ms, nbytes, flops, BF16_FLOP_PER_MS)

    # ---- nms_candidates: 2x480x640 raw score map with planted ties -------
    log("nms_candidates (per match_pair: one launch over 2x480x640)")
    raw = torch.floor(torch.rand(2, 480, 640, generator=gen, device=dev) * 64) / 4096
    raw[:, 100:108, 200:208] = 0.02  # a plateau: every pixel of a tile tied
    got_v, got_i = nms_k.nms_candidates(raw)
    want_v, want_i = nms_k.nms_candidates_plain(raw)
    compare("nms values", got_v, want_v, 0, 0, exact=True)
    compare("nms indices", got_i, want_i, 0, 0, exact=True)
    ms = cuda_ms(lambda: nms_k.nms_candidates(raw))
    plain = cuda_ms(lambda: nms_k.nms_candidates_plain(raw))
    ncand = got_v.numel()
    # ops: 5 separable radius-4 max-pools (2 x 8 compares each) + 4 rounds
    nms_e.add("2x480x640", 1, ms, plain, None, 4 * raw.numel() + 8 * ncand,
              raw.numel() * (20 * 4 + 4), FP32_OP_PER_MS)

    # ---- linear: every projection of one layer of a 1024x1024 pair -------
    plan_checks(ls, _build.lib())
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
            if tag != "bf16":
                continue
            lin_e.err(err)
            a_cat = a if a2 is None else torch.cat([a, a2], -1)
            ms = cuda_ms(lambda: ls.linear(a, w, b, a2=a2, residual=r))
            plain = cuda_ms(lambda: ls.linear_plain(a, w, b, a2, r))
            lib_ms = cuda_ms(lambda: torch.addmm(b, a_cat[0], w))
            nbytes = 2 * (m * (k1 + k2) + (k1 + k2) * n + n + m * n * (2 if res else 1))
            flops = 2 * m * (k1 + k2) * n
            lin_e.add(f"{label} bf16", per_layer * N_LAYERS, ms, plain, lib_ms, nbytes, flops,
                      BF16_FLOP_PER_MS)

    # ---- attention: self (RoPE) and cross at 1024, masked, length 0 -------
    log(f"attention (per match_pair: 4 launches per layer x {N_LAYERS} layers, N={BUCKET})")
    heads, hd = 4, 64

    def freqs_for(bsz, n):
        ang = rand(bsz, n, hd // 2, scale=2.0)
        emb = torch.stack([torch.cos(ang), torch.sin(ang)], dim=1)
        return torch.cat([emb, emb], dim=-1).contiguous()

    att_cases = [
        # label, Nq, Nk, rope, lengths (q, kv) or None, per-layer launches
        ("self rope", BUCKET, BUCKET, True, None, 2),
        ("cross", BUCKET, BUCKET, False, None, 2),
        ("self masked", 768, 768, True, ([700], [700]), 0),
        ("cross masked 768x1024", 768, BUCKET, False, ([700], [900]), 0),
        ("cross length 0", 256, 512, False, ([0], [0]), 0),
    ]
    for label, nq, nk, rope, lens, per_layer in att_cases:
        for tag, dt in dtypes.items():
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
                got = ls.attention(q, k, v, f, lq, lk, heads, dt)
                want = ls.attention_plain(q, k, v, f, lq, lk, heads, dt)
                err = compare(f"{label} {tag}", got, want, **TOL[tag])
                if tag == "bf16":
                    rounding_witness(f"{label} {tag}", got, want,
                                     stack_wrong_designs(q, k, v, f, lq, lk, heads))
            if lens and lens[0][0] == 0 and float(got.float().abs().max()) != 0.0:
                raise AssertionError(f"{label} {tag}: length-0 rows are not exactly 0")
            if tag != "bf16":
                continue
            att_e.err(err)
            if not per_layer:
                continue
            qh = q.reshape(1, nq, heads, hd).transpose(1, 2)
            kh = k.reshape(1, nk, heads, hd).transpose(1, 2)
            vh = v.reshape(1, nk, heads, hd).transpose(1, 2)
            ms = cuda_ms(lambda: ls.attention(q, k, v, f, lq, lk, heads, dt))
            plain = cuda_ms(lambda: ls.attention_plain(q, k, v, f, lq, lk, heads, dt))
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
            nbytes = 2 * (nq * e + 2 * nk * e + nq * e) + (4 * 2 * nq * hd if rope else 0)
            flops = 4 * heads * nq * nk * hd
            # library: scaled_dot_product_attention, which does no RoPE
            att_e.add(f"{label} bf16", per_layer * N_LAYERS, ms, plain, lib_ms, nbytes, flops,
                      BF16_FLOP_PER_MS)

    # ---- ln_gelu: 1024 rows of 512 ----------------------------------------
    log(f"ln_gelu (per match_pair: 4 launches per layer x {N_LAYERS} layers, N={BUCKET})")
    for tag, dt in dtypes.items():
        h = rand(1, BUCKET, 2 * e, dtype=dt)
        g = (1 + 0.1 * rand(2 * e)).to(dt)
        bb = (0.1 * rand(2 * e)).to(dt)
        with fp32_scope():
            err = compare(f"ln_gelu {tag}", ls.ln_gelu(h, g, bb), ls.ln_gelu_plain(h, g, bb),
                          **TOL[tag])
        if tag != "bf16":
            continue
        ln_e.err(err)
        ms = cuda_ms(lambda: ls.ln_gelu(h, g, bb))
        plain = cuda_ms(lambda: ls.ln_gelu_plain(h, g, bb))
        lib_ms = cuda_ms(lambda: F.gelu(F.layer_norm(h, (2 * e,), g, bb)))
        nbytes = 2 * (2 * h.numel() + 4 * e)
        ln_e.add("1024x512 bf16", 4 * N_LAYERS, ms, plain, lib_ms, nbytes, 20 * h.numel(),
                 FP32_OP_PER_MS)

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
    session.match_pair(img0, img1)  # warm: first launches, allocator
    counters = [conv_k.conv3x3, nms_k.nms_candidates, ls.linear, ls.attention, ls.ln_gelu]
    for fn in counters:
        fn.launches = 0
    result = session.match_pair(img0, img1)
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"  launches in one match_pair: {launches}")
    want = dict(conv3x3=3, nms_candidates=1, linear=16 * N_LAYERS, attention=4 * N_LAYERS,
                ln_gelu=4 * N_LAYERS)
    if launches != want:
        raise AssertionError(f"main path launches {launches}, want {want}")
    for entry in (conv_e, nms_e, lin_e, att_e, ln_e):
        entry.d["launches"] = launches[entry.d["name"]]
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
    profile_breakdown(lambda: session.match_pair(img0, img1), pair_ms)

    # ---- end to end against the port on the CPU, small FP32 pair ----------
    log("match_pair cuda vs cpu, FP32, 96x128, 2 layers, buckets (128, 256), threshold 0")
    cfg = PipelineConfig(superpoint=SuperPointConfig(max_num_keypoints=256),
                         lightglue=LightGlueConfig(n_layers=2), precision=Precision.FP32,
                         buckets=(128, 256), match_threshold=0.0, max_matches=256)
    s0, s1 = smooth_pair(1, 96, 128, 8, 12)
    rg = MatcherSession(config=cfg, seed=3, device="cuda").match_pair(s0, s1)
    rc = MatcherSession(config=cfg, seed=3, device="cpu").match_pair(s0, s1)

    def match_set(r):
        return {(tuple(a), tuple(b)) for a, b in zip(r["matched_kpts0"], r["matched_kpts1"])}

    mg, mc = match_set(rg), match_set(rc)
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
    adaptive_kernel_checks(ls, rand, freqs_for, dev, dtypes, fp32_scope, dec_e)
    adaptive_stack_checks(ls, weights, rand, freqs_for, dev, dtypes, fp32_scope)
    adaptive_end_to_end(ls, counters, weights, img0, img1, dec_e)

    # ---- the per-block path: 2048-keypoint and pad-to-64 configurations ----
    fused_e = Entry("fused_mha", "src/lightglue_tpu_torch/csrc/flash_attn.cu",
                    "src/lightglue_tpu/kernels/attention.py:687")
    bidir_e = Entry("bidirectional_cross_attention", "src/lightglue_tpu_torch/csrc/bidir_cross.cu",
                    "src/lightglue_tpu/kernels/attention.py:925")
    flash_e = Entry("flash_attention", "src/lightglue_tpu_torch/csrc/flash_attn.cu",
                    "src/lightglue_tpu/kernels/attention.py:197")
    attention_kernel_checks(at, rand, freqs_for, dev, dtypes, fp32_scope, fused_e, bidir_e, flash_e)
    per_block_stack_checks(at, weights, rand, freqs_for, dev, dtypes, fp32_scope)
    per_block_end_to_end(at, counters, img0, img1, fused_e, bidir_e)

    # ---- the sequence split: forward_ring on a ring of one card -------------
    step_e = Entry("flash_attention_step", "src/lightglue_tpu_torch/csrc/flash_attn.cu",
                   "src/lightglue_tpu/kernels/attention.py:422")
    step_kernel_checks(at, rand, dev, fp32_scope, step_e)
    ring_checks(at, ring, rand, dev, dtypes, fp32_scope)
    ring_end_to_end(at, counters, img0, img1, step_e)

    # ---- the conv variants that no path runs --------------------------------
    gen_e = Entry("conv3x3 (generic)", "src/lightglue_tpu_torch/csrc/conv3x3.cu",
                  "src/lightglue_tpu/kernels/conv.py:182")
    chain_e = Entry("conv2_chain", "src/lightglue_tpu_torch/csrc/conv_chain.cu",
                    "src/lightglue_tpu/kernels/conv_chain.py:140")
    generic_conv_checks(conv_k, rand, dev, dtypes, fp32_scope, gen_e)
    conv_chain_checks(conv_k, cc, rand, dev, dtypes, fp32_scope, chain_e)

    entries = (conv_e, nms_e, lin_e, att_e, ln_e, dec_e, fused_e, bidir_e, flash_e, step_e,
               gen_e, chain_e)
    log(json.dumps({"kernels": [x.out() for x in entries]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
