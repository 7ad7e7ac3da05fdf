"""Port kernels/attention.py (plain versions on the CPU) against the JAX
fused_mha, flash_attention and bidirectional_cross_attention (Pallas
interpret mode), and the filed fault of the JAX bidirectional kernel on an
empty side."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.kernels import attention as jax_attn
from lightglue_tpu_torch.kernels import attention, layer_stack

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# FP32: true fp32 on both sides, sums in another order. BF16: the same
# rounding points; a different fp32 sum order flips a rounding by an ulp or two
TOL = {"fp32": dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=2e-2, rtol=2e-2)}


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _freqs(rng, b, n):
    ang = rng.uniform(-3, 3, (b, n, 32)).astype(np.float32)
    emb = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    return np.concatenate([emb, emb], axis=-1)


def _both(x, dtype):
    """(JAX, torch) copies of a numpy array (None stays None); float arrays
    in the dtype under test, int arrays as int32."""
    if x is None:
        return None, None
    if x.dtype.kind == "i":
        return jnp.asarray(x, jnp.int32), torch.from_numpy(x.astype(np.int32))
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, dtype):
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])


# (B, Nq, Nk, rope, lengths, block_q/block_k); the 192 cases run three KV tiles
FUSED_CASES = {
    "unmasked": (2, 128, 128, False, None, 1024),
    "ragged lengths, q_len 0, kv_len 0": (3, 192, 192, False,
                                          [[192, 150], [0, 100], [80, 0]], 64),
    "rope, ragged": (2, 192, 192, True, [[150, 100], [192, 0]], 64),
    "rope, unmasked": (1, 128, 128, True, None, 1024),
    "nq != nk": (2, 64, 192, False, [[50, 170], [64, 192]], 64),
    "N=2048 default blocks, rope": (1, 2048, 2048, True, [[2048, 1500]], 1024),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_mha_matches_jax(case, dtype):
    b, nq, nk, rope, lens, block = FUSED_CASES[case]
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (_both(_rand(rng, b, n, 256), dtype) for n in (nq, nk, nk))
    freqs = _freqs(rng, b, nk) if rope else None
    jf, tf = (None, None) if freqs is None else (jnp.asarray(freqs), torch.from_numpy(freqs))
    jl, tl = _both(None if lens is None else np.asarray(lens), dtype)
    kw = dict(num_heads=4, block_q=block, block_k=block)
    want = jax_attn.fused_mha(jq, jk, jv, jf, jl, stat_dtype=DTYPES[dtype][0], **kw)
    got = attention.fused_mha(tq, tk, tv, tf, tl, stat_dtype=DTYPES[dtype][1], **kw)
    _close(got, want, dtype)
    if lens is not None:  # rows past q_len are exactly 0, and so is an empty kv side
        for i, (ql, kl) in enumerate(lens):
            assert not got[i, ql:].any()
            if kl == 0:
                assert not got[i].any()


FLASH_CASES = {
    "unmasked": (2, 128, 128, None, 1024),
    "ragged, three KV tiles": (2, 192, 192, [[100, 70], [0, 192]], 64),
    "nq != nk": (1, 64, 256, [[40, 200]], 64),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_matches_jax(case, dtype):
    b, nq, nk, lens, block = FLASH_CASES[case]
    rng = np.random.default_rng(2)
    (jq, tq), (jk, tk), (jv, tv) = (_both(_rand(rng, b, 4, n, 64), dtype) for n in (nq, nk, nk))
    jl, tl = _both(None if lens is None else np.asarray(lens), dtype)
    kw = dict(block_q=block, block_k=block)
    want = jax_attn.flash_attention(jq, jk, jv, jl, stat_dtype=DTYPES[dtype][0], **kw)
    got = attention.flash_attention(tq, tk, tv, tl, stat_dtype=DTYPES[dtype][1], **kw)
    _close(got, want, dtype)


BIDIR_CASES = {
    "unmasked 128x192": (2, 128, 192, None),
    "ragged 192x128": (2, 192, 128, [[150, 100], [192, 128]]),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(BIDIR_CASES))
def test_bidirectional_cross_matches_jax(case, dtype):
    b, n0, n1, lens = BIDIR_CASES[case]
    rng = np.random.default_rng(3)
    ops = [_both(_rand(rng, b, n, 256), dtype) for n in (n0, n1, n0, n1)]
    jl, tl = _both(None if lens is None else np.asarray(lens), dtype)
    want = jax_attn.bidirectional_cross_attention(
        *[j for j, _ in ops], jl, num_heads=4, stat_dtype=DTYPES[dtype][0])
    got = attention.bidirectional_cross_attention(
        *[t for _, t in ops], tl, num_heads=4, stat_dtype=DTYPES[dtype][1])
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_bidirectional_empty_side_gives_zero_as_fused_mha(dtype):
    """A pair whose kv side has length 0: the port's direction is 0, as JAX's
    two-fused_mha route gives. The JAX bidirectional kernel gives the mean
    of the padded values in FP32 and NaN in BF16 there (ROADMAP queue 3);
    asserting that keeps the fault documented and shows a fix."""
    rng = np.random.default_rng(5)
    lens = np.asarray([[5, 0], [0, 70], [40, 70]], np.int32)
    qk0, qk1, v0, v1 = (_rand(rng, 3, n, 256) for n in (64, 256, 64, 256))
    (jq0, tq0), (jq1, tq1), (jv0, tv0), (jv1, tv1) = (_both(x, dtype) for x in (qk0, qk1, v0, v1))
    jdt, tdt = DTYPES[dtype]
    got = attention.bidirectional_cross_attention(tq0, tq1, tv0, tv1, torch.from_numpy(lens),
                                                  num_heads=4, stat_dtype=tdt)
    two = (jax_attn.fused_mha(jq0, jq1, jv1, None, jnp.asarray(lens), num_heads=4,
                              stat_dtype=jdt),
           jax_attn.fused_mha(jq1, jq0, jv0, None, jnp.asarray(lens[:, ::-1]), num_heads=4,
                              stat_dtype=jdt))
    for g, w in zip(got, two):
        _close(g, w, dtype)
    assert not got[0][0].any() and not got[1][1].any()

    fault = jax_attn.bidirectional_cross_attention(jq0, jq1, jv0, jv1, jnp.asarray(lens),
                                                   num_heads=4, stat_dtype=jdt)
    for o, bi, rows, v in ((fault[0], 0, 5, v1), (fault[1], 1, 70, v0)):
        live = np.asarray(o[bi, :rows], np.float32)
        if dtype == "bf16":
            assert np.isnan(live).all()
        else:  # every live row is the mean of the other image's (all padded) values
            np.testing.assert_allclose(live, np.broadcast_to(v[bi].mean(0), live.shape),
                                       atol=1e-5)


def test_reference_attention_matches_jax():
    rng = np.random.default_rng(6)
    q, k, v = (_rand(rng, 2, 4, n, 64) for n in (96, 128, 128))
    lens = np.asarray([[96, 100], [30, 1]], np.int32)
    for lg in (None, lens):
        want = jax_attn.reference_attention(*map(jnp.asarray, (q, k, v)),
                                            None if lg is None else jnp.asarray(lg))
        got = attention.reference_attention(*map(torch.from_numpy, (q, k, v)),
                                            None if lg is None else torch.from_numpy(lg))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "fn,shapes,blocks",
    [
        ("fused_mha", ((1, 1536, 256),) * 3, (1024, 1024)),
        ("flash_attention", ((1, 1, 200, 64),) * 3, (128, 128)),
    ],
    ids=["fused_mha 1536 bucket", "flash_attention 200 by 128"],
)
def test_seq_not_divisible_by_blocks_raises_as_jax(fn, shapes, blocks):
    """Above 1024 a bucket must be a multiple of 1024 (block_q = min(1024,
    N)): the 2048 bucket runs, a 1536 bucket raises in both packages."""
    arrays = [np.zeros(s, np.float32) for s in shapes]
    kw = dict(block_q=blocks[0], block_k=blocks[1])
    if fn == "fused_mha":
        kw["num_heads"] = 4
    with pytest.raises(ValueError):
        getattr(jax_attn, fn)(*map(jnp.asarray, arrays), **kw)
    with pytest.raises(ValueError):
        getattr(attention, fn)(*map(torch.from_numpy, arrays), **kw)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "call,exc",
    [
        (lambda: attention.fused_mha(_meta(1, 128, 256), _meta(1, 128, 256), _meta(1, 128, 256),
                                     num_heads=2), NotImplementedError),
        (lambda: attention.fused_mha(_meta(1, 128, 256), _meta(1, 128, 256, dtype=torch.float32),
                                     _meta(1, 128, 256), num_heads=4), NotImplementedError),
        (lambda: attention.fused_mha(_meta(1, 128, 256), _meta(1, 128, 256), _meta(1, 128, 256),
                                     _meta(1, 2, 64, 64, dtype=torch.float32), num_heads=4),
         ValueError),
        (lambda: attention.flash_attention(*(_meta(1, 4, 128, 64, dtype=torch.float32),) * 3,
                                           out_dtype=torch.bfloat16),
         NotImplementedError),
        (lambda: attention.bidirectional_cross_attention(
            *(_meta(1, n, 256, dtype=torch.float32) for n in (4096, 64, 4096, 64)),
            num_heads=4, out_dtype=torch.bfloat16), NotImplementedError),
        (lambda: attention.bidirectional_cross_attention(
            _meta(1, 64, 256), _meta(1, 64, 256), _meta(1, 64, 256), _meta(1, 64, 256),
            _meta(1, 3, dtype=torch.int32), num_heads=4), ValueError),
    ],
    ids=["fused_mha head dim", "fused_mha dtypes", "fused_mha rope rows",
         "flash_attention out dtype", "bidirectional fp32 operands, bf16 out",
         "bidirectional lengths shape"],
)
def test_wrappers_reject_malformed_operands_before_launch(call, exc):
    # meta tensors take the kernel branch without a card; the checks run first
    with pytest.raises(exc):
        call()


@pytest.mark.parametrize("stats", ["bf16", "fp32"])
def test_rounding_witness_premise_against_jax(stats):
    """The premise of chip_smoke.py's rounding witness: the plain version at
    the reference's block_k differs from JAX (Pallas interpret mode) only
    where a different fp32 sum order flips a rounding, and at a block_k 8x
    smaller it differs in a large share of elements (m, l and acc rounded
    at other points). bf16 operands, (1, 4, 256, 64), block_k 128."""
    rng = np.random.default_rng(9)
    (jq, tq), (jk, tk), (jv, tv) = (_both(_rand(rng, 1, 4, 256, 64), "bf16") for _ in range(3))
    jdt, tdt = DTYPES[stats]
    want = np.asarray(jax_attn.flash_attention(jq, jk, jv, stat_dtype=jdt, block_q=128,
                                               block_k=128).astype(jnp.float32))

    def share(block_k):
        got = attention.flash_attention(tq, tk, tv, stat_dtype=tdt, block_q=128, block_k=block_k)
        return float(np.mean(got.float().numpy() != want))

    assert share(128) < 0.01
    assert share(16) > 0.20


# (batch, heads, nq, block_k, split, cluster): every flash_attn.cu shape of
# the paths and chip_smoke.py. The bf16 kernel takes a 64-row tile of a head
# per block or cluster; its consumer warpgroups split each tile's chunks 8
# ways where one batch entry's tiles, two blocks each, fit the 132 SMs, else
# 4 (a split that holds at any batch); a split of 8 runs as clusters of two
# blocks while the whole launch's blocks fit the SMs, else as one block a
# tile
PLAN_SHAPES = {
    "2048 self, block_k 1024": (2, 4, 2048, 1024, 4, False),
    "2048 cross, block_k 1024": (1, 4, 2048, 1024, 4, False),
    "960 pad-to-64 self": (2, 4, 960, 960, 8, False),
    "960 pad-to-64 cross": (1, 4, 960, 960, 8, True),
    "1000 / 1000": (2, 4, 1000, 1000, 8, False),
    "ring stripe 512": (1, 4, 512, 512, 8, True),
    "ring stripe 384": (1, 4, 384, 384, 8, True),
    "ring stripe 120": (1, 4, 120, 120, 8, True),
    "block_k 64": (2, 4, 1024, 64, 8, False),
}


@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_flash_launch_plan_fits(shape):
    batch, heads, nq, block_k, split, cluster = PLAN_SHAPES[shape]
    plan = attention.flash_plan(batch, heads, nq, block_k)
    assert plan.kernel == "flash_wgmma_kernel" and plan.row_groups == 4  # a 64-row tile
    assert plan.col_split == split == attention.flash_split(heads, nq)  # one entry's split
    assert plan.cluster == cluster and plan.stages == 2 and plan.store  # bf16 stats, <= 1024
    tiles = batch * heads * -(-nq // 64)
    assert plan.blocks == tiles * (2 if cluster else 1)
    assert plan.blocks <= 132 or not cluster  # clusters only while their blocks fit the SMs
    assert plan.smem <= attention._build.MAX_DYNAMIC_SMEM
    if shape == "ring stripe 512":  # the ring step: eight consumers a tile, one chunk each
        assert plan.cluster and plan.col_split * 64 == 512
    for dtype in (torch.bfloat16, torch.float32):  # neither kernel raises here
        groups_arg, split_arg, stages = attention._flash_launch("f", dtype, batch, heads, nq,
                                                                block_k)
        fp32 = attention.flash_plan(batch, heads, nq, block_k, dtype)
        assert (groups_arg, split_arg, stages) == fp32[:3]
        # a 64-row tile; ring slots of a warpgroup: bf16 two, fp32 one (a 32-key piece)
        assert groups_arg == 4 and stages == (1 if dtype == torch.float32 else 2)
