"""The FP32 rung's 3xTF32 kernels on the CPU: csrc/flash_attn.cu's
flash_tf32_wgmma_kernel (fused_mha, flash_attention, flash_attention_step at
fp32 operands), csrc/linear.cu's linear_tf32_wgmma_kernel and the fp32
attention tile (csrc/attention_tile.cuh, which attention.cu's and
bidir_cross.cu's fp32 kernels run; its tiles are emulated in
tests/test_torch_fp32_stack_bidir.py). The premise of 3xTF32 at the
attention and linear shapes, emulated; the fp32 GEMM's tile through its
wgmma layouts (tests/test_torch_fp32_wgmma.py holds the flash kernel's);
the fp32 launch plans; and the wrappers' CPU path
against JAX at fp32 where tests/test_torch_attention.py, test_torch_ring.py
and test_torch_quant.py do not reach (tiles that end in a short chunk, fp32
operands with bf16 stats, the fp32 projections)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.kernels import attention as jax_attn
from lightglue_tpu.kernels.layer_stack import _dot
from lightglue_tpu_torch.kernels import _build, attention, layer_stack
from tf32_emulation import a_fragment_matrix, acc_at, b_operand, split_rz, tf32, tma_halves

GATE = 1e-4    # the fp32 rung's gate (chip_smoke.py TOL["fp32"])


def _mm3(a, b):
    """a @ b in 3xTF32 as the kernels take it: each operand split by
    truncation (split_tf32_rz), hi*lo + lo*hi + hi*hi in fp32, lo*lo
    dropped."""
    (ah, al), (bh, bl) = split_rz(a), split_rz(b)
    return ah @ bl + al @ bh + ah @ bh


def _mm1(a, b):
    """a @ b in one TF32 product: both operands rounded, the sum in fp32."""
    return tf32(a) @ tf32(b)


# ---------------------------------------------------------------------------
# the premise: 3xTF32 holds the fp32 gate, one TF32 product misses it
# ---------------------------------------------------------------------------

# (B, H, Nq, Nk, lengths): a self and a masked cross call at head dim 64;
# the layer stack's masked 1024 bucket and the pad-to-64 route's 960 x 960
# (the bidirectional kernel, one direction): both on the fp32 attention tile
ATTENTION_PREMISE = {"self 1x4x256": (1, 256, 256, None),
                     "cross 2x4x128x384, masked": (2, 128, 384, [[128, 300], [100, 384]]),
                     "stack 1x4x1024, masked": (1, 1024, 1024, [[1000, 900]]),
                     "bidirectional 1x4x960x960": (1, 960, 960, None)}


@pytest.mark.parametrize("case", list(ATTENTION_PREMISE))
def test_3xtf32_attention_premise(case):
    """softmax(Q.K^T / 8) V with both products in 3xTF32 (P split as the
    kernel splits it, by truncation) agrees with JAX's fp32
    flash_attention within 1e-5;
    with one TF32 product each it misses the fp32 gate of 1e-4 (its max
    error here is 1.8-5.8e-4)."""
    b, nq, nk, lens = ATTENTION_PREMISE[case]
    rng = np.random.default_rng(41)
    q, k, v = (rng.standard_normal((b, 4, n, 64), dtype=np.float32) for n in (nq, nk, nk))
    ln = None if lens is None else np.asarray(lens, np.int32)
    want = np.asarray(jax_attn.flash_attention(*map(jnp.asarray, (q, k, v)),
                                               None if ln is None else jnp.asarray(ln)))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))

    def attend(mm):
        s = mm(qt, kt.transpose(-1, -2)) * 0.125
        if ln is not None:
            s = torch.where(torch.arange(nk) < torch.from_numpy(ln[:, 1]).view(-1, 1, 1, 1), s,
                            -1e30)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        out = mm(p, vt) / p.sum(-1, keepdim=True)
        if ln is not None:
            out = torch.where(torch.arange(nq).view(-1, 1) < torch.from_numpy(ln[:, 0])
                              .view(-1, 1, 1, 1), out, 0.0)
        return out.numpy()

    err3, err1 = (np.abs(attend(mm) - want).max() for mm in (_mm3, _mm1))
    assert err3 < 1e-5
    assert err1 > GATE and err3 < err1 / 50


# the stack's projections at M = 64 rows: (K, N)
LINEAR_PREMISE = [(256, 768), (256, 256), (512, 512), (512, 256), (256, 512)]


@pytest.mark.parametrize("kn", LINEAR_PREMISE, ids=[f"{k}x{n}" for k, n in LINEAR_PREMISE])
def test_3xtf32_linear_premise(kn):
    """x @ w + b in 3xTF32 (split by truncation) agrees with JAX _linear
    at fp32 (_dot at
    Precision.HIGHEST, layer_stack.py:357-375) within 1e-5; one TF32
    product misses the fp32 gate (7.0-7.6e-4 here)."""
    k, n = kn
    rng = np.random.default_rng(43)
    x = rng.standard_normal((64, k), dtype=np.float32)
    w = (rng.uniform(-1, 1, (k, n)) / math.sqrt(k)).astype(np.float32)
    b = (rng.uniform(-1, 1, n) / math.sqrt(k)).astype(np.float32)
    want = np.asarray(_dot(jnp.asarray(x), jnp.asarray(w)) + jnp.asarray(b))
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    err3, err1 = (np.abs((mm(xt, wt) + bt).numpy() - want).max() for mm in (_mm3, _mm1))
    assert err3 < 1e-5
    assert err1 > GATE and err3 < err1 / 50


# ---------------------------------------------------------------------------
# the fp32 GEMM's tile through its wgmma layouts
# ---------------------------------------------------------------------------


def _w_fragment_at(warp, lane, i, kk):
    """The float index in W's chunk of register i of W^T's A fragment of k8
    step kk, as linear.cu:w_frags reads it: row (output column) n = 16 w +
    g + 8 (i & 1), k = 8 kk + t4 + 4 (i >> 1), at float n % 4 of 16 B unit
    (n % 32) / 4 ^ k % 8 of row k of half n / 32 ([64 k][32 n] each)."""
    g, t4 = divmod(lane, 4)
    n, k = 16 * warp + g + 8 * (i & 1), 8 * kk + t4 + 4 * (i >> 1)
    return ((n // 32) * 64 * 128 + k * 128 + (((n % 32) // 4) ^ (k % 8)) * 16 + (n % 4) * 4) // 4


@pytest.mark.parametrize("br", [64, 32])
def test_linear_tile_by_fragments_matches_gemm(br):
    """One tile of linear_tf32_wgmma_kernel over a 64-deep chunk, 64 output
    columns by BR rows, as it computes the transposed product Y^T = W^T .
    X^T: W's chunk as TMA writes it (two 128 B-swizzled [64 k][32 n]
    halves) read into W^T's register-A fragments at w_frags' offsets, X's
    chunk (two [BR][32] halves) read as the K-major B operand through its
    descriptors, eight k8 steps of m64nBRk8, and each accumulator register
    stored where the epilogue puts it (row m0 + its column, column n0 +
    its row). It is the GEMM of the chunk; a warp's fragment loads meet at
    most two to a bank."""
    rng = np.random.default_rng(59)
    x = rng.standard_normal((br, 64))
    w = rng.standard_normal((64, 64))
    wf, xf = tma_halves(w), tma_halves(x)
    acc = sum(a_fragment_matrix(lambda warp, lane, i: wf[_w_fragment_at(warp, lane, i, kk)])
              @ b_operand(xf, br, kk) for kk in range(8))
    y = np.zeros((br, 64))
    for warp in range(4):
        for lane in range(32):
            for e in range(br // 2):
                r, c = acc_at(warp, lane, e)
                y[c, r] = acc[r, c]
    np.testing.assert_allclose(y, x @ w, rtol=1e-12, atol=1e-12)
    for warp in range(4):
        for kk in range(8):
            for i in range(4):
                banks = [_w_fragment_at(warp, lane, i, kk) % 32 for lane in range(32)]
                assert max(banks.count(bk) for bk in banks) <= 2


# ---------------------------------------------------------------------------
# launch plans
# ---------------------------------------------------------------------------

# (B, H, Nq, block_k): every route's fp32 flash shape, block_k 1000 and 4096
FP32_FLASH_PLANS = {
    "2048 self": (2, 4, 2048, 1024),
    "2048 cross": (1, 4, 2048, 1024),
    "960 pad-to-64": (2, 4, 960, 960),
    "block_k 1000": (2, 4, 1000, 1000),
    "ring stripe 512": (1, 4, 512, 512),
    "ring stripe 120": (1, 4, 120, 120),
    "block_k 4096": (1, 4, 4096, 4096),
}


@pytest.mark.parametrize("shape", list(FP32_FLASH_PLANS))
def test_fp32_flash_plan_fits(shape):
    """The fp32 plan is flash_tf32_wgmma_kernel's: 64-row tiles, the split
    of one pair's shape (flash_split, as the bf16 kernel's), a split of 8
    as clusters of two blocks, one 32-key ring slot a consumer warpgroup;
    one block an SM, whose shared memory does not grow with block_k (the
    pieces stream)."""
    batch, heads, nq, block_k = FP32_FLASH_PLANS[shape]
    plan = attention.flash_plan(batch, heads, nq, block_k, torch.float32)
    split = attention.flash_split(heads, nq)
    assert plan.kernel == "flash_tf32_wgmma_kernel" and plan.stages == 1
    assert (plan.row_groups, plan.col_split) == (4, split)
    assert plan.cluster == (split == 8) and not plan.store
    assert plan.blocks == batch * heads * -(-nq // 64) * (2 if plan.cluster else 1)
    assert plan.smem == attention.flash_plan(batch, heads, nq, 64, torch.float32).smem
    assert plan.smem <= _build.MAX_DYNAMIC_SMEM < 2 * plan.smem
    assert attention._flash_launch("f", torch.float32, batch, heads, nq, block_k) == (4, split, 1)


def test_flash_launch_raises_where_the_block_does_not_fit(monkeypatch):
    """_flash_launch refuses a plan past the card's shared memory before any
    launch, in both operand types."""
    monkeypatch.setattr(_build, "MAX_DYNAMIC_SMEM", 32 * 1024)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="exceeds shared memory"):
            attention._flash_launch("f", dtype, 2, 4, 2048, 1024)


@pytest.mark.parametrize("shape", [(1024, 768, 256), (1024, 256, 256), (1024, 512, 512),
                                   (1024, 256, 512), (128, 256, 512), (2048, 768, 256)])
def test_fp32_linear_plan_fits(shape):
    """The fp32 GEMM takes tiles of 64 output columns by 64 rows where one
    pair's rows give 128 blocks, else 32 rows (linear.cu:tf_tile_rows, the
    bf16 rule with the roles swapped), with a ring of slots of X's chunk,
    its lo copy and W's chunk, all fp32 64 deep (csrc/linear.cu:tf_smem):
    four while the launch's blocks fit the 132 SMs (one block an SM), else
    two (two blocks an SM)."""
    m, n, k = shape
    plan = layer_stack.linear_plan(m, n, k, torch.float32)
    bm = 64 if -(-m // 64) * (n // 64) >= 128 else 32
    assert plan.kernel == "linear_tf32_wgmma_kernel" and (plan.bm, plan.bn) == (bm, 64)
    assert plan.blocks == -(-m // plan.bm) * (n // 64)
    assert plan.bk == 64 and plan.chunks == k // 64
    assert plan.stages == (4 if plan.blocks <= 132 else 2)
    assert plan.smem == plan.stages * (2 * 4 * bm * 64 + 4 * 64 * 64 + 16) + 1024
    assert (1 if plan.stages == 4 else 2) * plan.smem <= _build.MAX_DYNAMIC_SMEM


# ---------------------------------------------------------------------------
# the wrappers' CPU path against JAX at fp32
# ---------------------------------------------------------------------------

TOL = dict(atol=1e-5, rtol=1e-5)  # true fp32 on both sides, sums in another order


def _freqs(rng, b, n):
    ang = rng.uniform(-3, 3, (b, n, 32)).astype(np.float32)
    emb = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    return np.concatenate([emb, emb], axis=-1)


# (B, N, block, rope, lengths): tiles that end in a short chunk (100 = 64 +
# 36 keys, 40 < 64), as block_k 1000 does on the card
FP32_FUSED = {"rope, 100-key tiles": (2, 200, 100, True, [[190, 150], [200, 0]]),
              "40-key tiles": (1, 120, 40, False, [[120, 97]])}


@pytest.mark.parametrize("case", list(FP32_FUSED))
def test_fp32_fused_mha_short_chunk_tiles_match_jax(case):
    b, n, block, rope, lens = FP32_FUSED[case]
    rng = np.random.default_rng(61)
    q, k, v = (rng.standard_normal((b, n, 256), dtype=np.float32) for _ in range(3))
    f = _freqs(rng, b, n) if rope else None
    ln = np.asarray(lens, np.int32)
    kw = dict(num_heads=4, block_q=block, block_k=block)
    want = jax_attn.fused_mha(*map(jnp.asarray, (q, k, v)), None if f is None else jnp.asarray(f),
                              jnp.asarray(ln), **kw)
    got = attention.fused_mha(*map(torch.from_numpy, (q, k, v)),
                              None if f is None else torch.from_numpy(f), torch.from_numpy(ln),
                              **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fp32_flash_attention_short_chunk_tiles_match_jax():
    rng = np.random.default_rng(67)
    q, k, v = (rng.standard_normal((2, 4, 240, 64), dtype=np.float32) for _ in range(3))
    ln = np.asarray([[240, 200], [130, 240]], np.int32)
    kw = dict(block_q=120, block_k=120)
    want = jax_attn.flash_attention(*map(jnp.asarray, (q, k, v)), jnp.asarray(ln), **kw)
    got = attention.flash_attention(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(ln), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (n = nk, GLOBAL lengths or None, row0, col0, block cap)
FP32_BF16_STATS_STEP = {"unmasked": (128, None, 0, 128, 64),
                        "masked, 120-row stripes": (120, [[300, 200]], 120, 120, 120)}


@pytest.mark.parametrize("case", list(FP32_BF16_STATS_STEP))
def test_fp32_operands_bf16_stats_step_matches_jax(case):
    """flash_attention_step at fp32 operands with bf16 stats (chip_smoke.py's
    step check runs it): the same rounding points as JAX's step, a different
    fp32 sum order flipping a bf16 rounding here and there."""
    n, lens, row0, col0, block = FP32_BF16_STATS_STEP[case]
    rng = np.random.default_rng(71)
    q, k, v = (rng.standard_normal((1, 2, n, 64), dtype=np.float32) for _ in range(3))
    carries = (rng.uniform(-2, 2, (1, 2, n, 1)).astype(np.float32),
               rng.uniform(0.5, 3, (1, 2, n, 1)).astype(np.float32),
               rng.standard_normal((1, 2, n, 64), dtype=np.float32))
    ln = None if lens is None else np.asarray(lens, np.int32)
    kw = dict(block_q=block, block_k=block)
    want = jax_attn.flash_attention_step(
        *map(jnp.asarray, (q, k, v)), *map(jnp.asarray, carries),
        None if ln is None else jnp.asarray(ln), row0, col0, stat_dtype=jnp.bfloat16, **kw)
    got = attention.flash_attention_step(
        *map(torch.from_numpy, (q, k, v)), *map(torch.from_numpy, carries),
        None if ln is None else torch.from_numpy(ln), row0, col0, stat_dtype=torch.bfloat16,
        **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-2, rtol=2e-2)


# (K1, K2, N, residual, liveness): the ffn1 concat, ffn2 with its residual,
# and a retired pair of the adaptive stack
FP32_LINEAR = {"ffn1 concat": (256, 256, 512, False, False),
               "ffn2 + residual": (512, 0, 256, True, False),
               "ffn2, pair 1 retired": (512, 0, 256, True, True)}


@pytest.mark.parametrize("case", list(FP32_LINEAR))
def test_fp32_linear_matches_jax(case):
    """linear at fp32 against JAX _linear (:357-375 with dt = attn_dtype =
    fp32: _dot at HIGHEST, + bias) and the residual add (:399); a retired
    pair's rows are the residual (the pl.when(live) gate)."""
    k1, k2, n, res, live = FP32_LINEAR[case]
    rng = np.random.default_rng(73)
    a = rng.standard_normal((2, 64, k1), dtype=np.float32)
    a2 = rng.standard_normal((2, 64, k2), dtype=np.float32) if k2 else None
    w = (rng.uniform(-1, 1, (k1 + k2, n)) / math.sqrt(k1 + k2)).astype(np.float32)
    b = (rng.uniform(-1, 1, n) / math.sqrt(k1 + k2)).astype(np.float32)
    r = rng.standard_normal((2, 64, n), dtype=np.float32) if res else None
    x = a if a2 is None else np.concatenate([a, a2], -1)
    want = np.stack([np.asarray(_dot(jnp.asarray(xi), jnp.asarray(w)) + jnp.asarray(b))
                     for xi in x])
    if res:
        want = want + r
        if live:
            want[1] = r[1]
    got = layer_stack.linear(torch.from_numpy(a), torch.from_numpy(w), torch.from_numpy(b),
                             None if a2 is None else torch.from_numpy(a2),
                             None if r is None else torch.from_numpy(r),
                             layer_stack.Live(torch.tensor([9.0, 3.0]), 3) if live else None)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
