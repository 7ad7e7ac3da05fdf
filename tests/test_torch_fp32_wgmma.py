"""The FP32 rung's kernels on Hopper's warpgroup MMA, without a card:
csrc/flash_attn.cu's flash_tf32_wgmma_kernel (fused_mha, flash_attention,
flash_attention_step at fp32 operands) and csrc/linear.cu's
linear_tf32_wgmma_kernel, both in 3xTF32. The launch plans as
kernels/attention.py:flash_plan and kernels/layer_stack.py:linear_plan
mirror them, with their shared memory counted as the kernels lay it out;
the wrappers' refusal of fp32 operands that TMA cannot address; and, in
numpy, the layouts the kernels hand wgmma: fp32 tiles as TMA writes them in
128 B swizzle, read back through the kernels' K-major descriptors (two
32-float halves, a k8 step 32 B along a half), S = Q.K^T through them, and
P.V with P taken from the S accumulator as the register-A operand against V
transposed and split by the consumer in P's key order."""

import numpy as np
import pytest
import torch

from lightglue_tpu_torch.kernels import _build, attention, layer_stack
from tf32_emulation import (a_fragment_matrix, b_operand, p_register, split_rz, tf32_rz,
                            tma_halves, vt_copy, vt_operand)

F32 = torch.float32
GATE = 1e-4  # the fp32 rung's gate (chip_smoke.py TOL["fp32"])

# (batch, heads, nq, block_k): the routes' fp32 shapes (2048 self and cross,
# the TP shards' heads, 960 pad-to-64, the generic entry point, the ring's
# 512-row stripes and its fitted blocks) and chip_smoke.py's edge cases
ROUTE_SHAPES = {
    "2048 self": (2, 4, 2048, 1024),
    "2048 cross": (1, 4, 2048, 1024),
    "2048 self, TP H=2": (2, 2, 2048, 1024),
    "2048 cross, TP H=1": (1, 1, 2048, 1024),
    "960 self": (2, 4, 960, 960),
    "960 cross": (1, 4, 960, 960),
    "ring stripe 512": (1, 4, 512, 512),
    "ring 384 fitted to 192": (1, 4, 384, 192),
    "ring stripe 120": (1, 4, 120, 120),
    "block_k 1000": (2, 4, 1000, 1000),
    "block_k 64": (2, 4, 1024, 64),
    "block_k 4096": (1, 4, 4096, 4096),
    "8 pairs of 2048": (16, 4, 2048, 1024),
}


def _fp32_smem(cluster: bool) -> int:
    """An fp32 block's bytes, counted the way csrc/flash_attn.cu:Smem lays
    them out: Q and its lo copy (64 x 64 fp32 each); four warpgroups'
    regions (one slot of a 32-key piece of K and of V, then K's lo copy and
    V^T hi and lo, 32 x 64 fp32 each); the block's rows of acc and of l; row
    max and sum p per warpgroup; the cluster's row max, each row's
    correction and max; 9 barriers; 1 KB of alignment."""
    ways = 2 if cluster else 1
    piece = 32 * 64 * 4
    region = 2 * piece + 3 * piece
    acc, l = 64 // ways * 64 * 4, 64 // ways * 4
    return 2 * 64 * 64 * 4 + 4 * region + acc + l + 2 * 4 * 64 * 4 + 3 * 64 * 4 + 9 * 8 + 1024


@pytest.mark.parametrize("shape", list(ROUTE_SHAPES))
def test_fp32_smem_formula_matches_the_plan(shape):
    """The fp32 plan is flash_tf32_wgmma_kernel's: a 64-row tile of a head,
    the bf16 kernel's split (one batch entry's shape, never the batch), a
    split of 8 always as a cluster of two blocks, one ring slot a
    warpgroup, pass 2 recomputing S; its shared memory as counted, within
    the SM's, whatever block_k (the pieces stream)."""
    batch, heads, nq, block_k = ROUTE_SHAPES[shape]
    plan = attention.flash_plan(batch, heads, nq, block_k, F32)
    split = attention.flash_split(heads, nq)
    tiles = batch * heads * -(-nq // 64)
    assert plan.kernel == "flash_tf32_wgmma_kernel"
    assert (plan.row_groups, plan.col_split, plan.stages) == (4, split, 1)
    assert plan.cluster == (split == 8) and not plan.store
    assert plan.blocks == tiles * (2 if plan.cluster else 1)
    assert plan.smem == _fp32_smem(plan.cluster) == attention.flash_wgmma_smem(
        False, plan.cluster, F32)
    assert plan.smem <= _build.MAX_DYNAMIC_SMEM
    for sdt in (F32, torch.bfloat16):  # bf16 stats (the ring step) take the same launch
        assert attention.flash_plan(batch, heads, nq, block_k, F32, sdt) == plan
    assert attention._flash_launch("f", F32, batch, heads, nq, block_k) == (4, split, 1)


@pytest.mark.parametrize("heads,nq", [(4, 2048), (4, 1024), (4, 960), (4, 512), (4, 120),
                                      (2, 2048), (1, 2048), (8, 1024), (4, 1088)])
def test_fp32_split_does_not_follow_the_batch(heads, nq):
    """The batch adds blocks and nothing else: the split and the form are
    one batch entry's at B = 1, 2, 4, 8, so a row's fp32 sums run in one
    order at any batch (batch_invariance)."""
    one = attention.flash_plan(1, heads, nq, min(nq, 1024), F32)
    for batch in (2, 4, 8):
        plan = attention.flash_plan(batch, heads, nq, min(nq, 1024), F32)
        assert (plan.col_split, plan.cluster, plan.smem) == (one.col_split, one.cluster,
                                                              one.smem)
        assert plan.blocks == batch * one.blocks


def _meta(numel):
    return torch.empty(numel, dtype=F32, device="meta")


CASES = ["base 8 B off", "row stride off 16 B", "batch or head stride off 16 B"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kernel", ["fused_mha", "flash_attention", "flash_attention_step",
                                    "attention"])
def test_tma_refuses_fp32_operands_off_16_bytes(kernel, case):
    """The fp32 flash kernel and the stack's fp32 attention read q, k and v
    through TMA, which needs 16 B bases and strides (4 floats): each wrapper
    raises a ValueError on any other fp32 operand before a launch, as on
    bf16 ones."""
    with pytest.raises(ValueError, match="TMA"):
        if kernel in ("fused_mha", "attention"):
            flat = _meta(2 * 128 * 776 + 8)
            if case == "base 8 B off":
                qkv = flat[2:2 + 2 * 128 * 768].view(2, 128, 768)
            elif case == "row stride off 16 B":
                qkv = flat[:2 * 128 * 770].view(2, 128, 770)
            else:
                qkv = flat[:2 * 128 * 768 + 2].as_strided((2, 128, 768), (128 * 768 + 2, 768, 1))
            q, k, v = qkv[..., :256], qkv[..., 256:512], qkv[..., 512:768]
            if kernel == "attention":
                layer_stack.attention(q, k, v, None, None, None, 4, F32)
            else:
                attention.fused_mha(q, k, v, num_heads=4, stat_dtype=F32)
            return
        flat = _meta(2 * 4 * 128 * 72 + 8)
        good = flat[:2 * 4 * 128 * 64].view(2, 4, 128, 64)
        if case == "base 8 B off":
            bad = flat[2:2 + 2 * 4 * 128 * 64].view(2, 4, 128, 64)
        elif case == "row stride off 16 B":
            bad = flat[:2 * 4 * 128 * 72].as_strided((2, 4, 128, 64),
                                                     (4 * 128 * 72, 128 * 72, 66, 1))
        else:
            bad = flat[:2 * 4 * 128 * 72].as_strided((2, 4, 128, 64),
                                                     (4 * 128 * 68, 128 * 68 - 2, 64, 1))
        if kernel == "flash_attention":
            attention.flash_attention(good, bad, good, stat_dtype=F32)
        else:
            m = torch.empty(2, 4, 128, 1, device="meta")
            acc = torch.empty(2, 4, 128, 64, device="meta")
            attention.flash_attention_step(good, bad, good, m, m.clone(), acc, stat_dtype=F32)


@pytest.mark.parametrize("case", ["a base 8 B off", "a rows of 250 floats", "w base 8 B off",
                                  "a2 base 8 B off"])
def test_linear_refuses_fp32_operands_off_16_bytes(case):
    """The fp32 GEMM reads a, a2 and w through TMA: a base off 16 B or rows
    of a width that is not a multiple of 4 floats raise a ValueError before
    a launch."""
    flat = _meta(64 * 520 + 8)
    a = flat[:64 * 256].view(64, 256)
    w = torch.empty(256, 256, dtype=F32, device="meta")
    b = torch.empty(256, dtype=F32, device="meta")
    a2 = None
    if case == "a base 8 B off":
        a = flat[2:2 + 64 * 256].view(64, 256)
    elif case == "a rows of 250 floats":
        a, a2 = flat[:64 * 250].view(64, 250), flat[64 * 250:64 * 256].view(64, 6)
    elif case == "w base 8 B off":
        w = flat[2:2 + 256 * 64].view(256, 64)
        b = torch.empty(64, dtype=F32, device="meta")
    else:
        a, a2 = flat[:64 * 128].view(64, 128), flat[64 * 128 + 2:64 * 256 + 2].view(64, 128)
    with pytest.raises(ValueError, match="TMA"):
        layer_stack.linear(a, w, b, a2)


# ---------------------------------------------------------------------------
# the layouts in numpy: TMA's 128 B swizzle, the K-major descriptors
# (tf32_emulation.py), V^T and P as flash_attn.cu writes and takes them
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [64, 32])
def test_swizzled_halves_read_back_through_the_descriptor(rows):
    """Every element of an fp32 K-major tile (Q: 64 rows; a K piece or an
    X chunk of 32 rows) placed by TMA in two 128 B-swizzled halves comes
    back at its (row, k) through the descriptors of the eight k8 steps."""
    tile = np.arange(rows * 64, dtype=np.float64).reshape(rows, 64)
    flat = tma_halves(tile)
    for kk in range(8):
        np.testing.assert_array_equal(b_operand(flat, rows, kk).T, tile[:, 8 * kk:8 * kk + 8])


def test_scores_and_pv_of_a_piece_through_the_layouts():
    """One 32-key piece as a consumer warpgroup computes it: S = Q.K^T with
    Q (64 rows) and K (32 keys) both read through their descriptors; P
    (softmax-like values) from the S accumulator as the register-A operand
    of P.V, against V^T written by the consumer and read through its
    descriptor (one half, four k8 steps). Both agree with float64 products
    up to the sum order."""
    rng = np.random.default_rng(61)
    q = rng.standard_normal((64, 64))
    k = rng.standard_normal((32, 64))
    v = rng.standard_normal((32, 64))
    qf, kf = tma_halves(q), tma_halves(k)
    s = np.zeros((64, 32))
    for kk in range(8):  # A from shared memory: A[row][k] through Q's descriptor
        s += b_operand(qf, 64, kk).T @ b_operand(kf, 32, kk)
    np.testing.assert_allclose(s, q @ k.T, rtol=1e-12, atol=1e-12)
    p = rng.uniform(0, 1, (64, 32))
    vt = vt_copy(v)
    pv = sum(a_fragment_matrix(lambda w, lane, i: p_register(p, w, lane, i, kk))
             @ vt_operand(vt, kk) for kk in range(4))
    np.testing.assert_allclose(pv, p @ v, rtol=1e-12, atol=1e-12)


def test_pv_of_a_piece_in_3xtf32_through_the_layouts():
    """The same P.V in 3xTF32 as the kernel runs it: P split in registers by
    truncation (split_tf32_rz) from the S accumulator, V written transposed
    in P's key order as hi and lo copies, P_hi.V_lo + P_lo.V_hi + P_hi.V_hi
    over the four k8 steps with every operand read truncated by the tensor
    core; within 2^-20 of |P|.|V| of a plain P.V in float64, where one TF32
    product (hi alone) misses the fp32 gate."""
    rng = np.random.default_rng(67)
    p = rng.uniform(0, 1, (64, 32)).astype(np.float32)
    v = rng.standard_normal((32, 64)).astype(np.float32)
    (ph, pl), (vh, vl) = (tuple(t.numpy().astype(np.float64) for t in split_rz(torch.from_numpy(x)))
                          for x in (p, v))
    vth, vtl = vt_copy(vh), vt_copy(vl)
    out3, out1 = np.zeros((64, 64)), np.zeros((64, 64))
    for kk in range(4):
        ah, al = (a_fragment_matrix(lambda w, lane, i: p_register(x, w, lane, i, kk))
                  for x in (ph, pl))
        bh, bl = vt_operand(vth, kk), vt_operand(vtl, kk)
        out3 += ah @ bl + al @ bh + ah @ bh
        out1 += ah @ bh
    want = p.astype(np.float64) @ v.astype(np.float64)
    mag = np.abs(p).astype(np.float64) @ np.abs(v).astype(np.float64)
    assert (np.abs(out3 - want) <= 2.0 ** -20 * mag).all()
    assert np.abs(out1 - want).max() > GATE
    # a raw fp32 word read as its truncation is the split's hi
    x = torch.from_numpy(v)
    assert torch.equal(tf32_rz(x), split_rz(x)[0])
