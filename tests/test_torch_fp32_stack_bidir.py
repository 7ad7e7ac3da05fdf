"""The FP32 rung's 3xTF32 stack attention (csrc/attention.cu:
attention_tf32_kernel) and bidirectional kernel (csrc/bidir_cross.cu:
bidir_tf32_kernel) on the CPU.

A 16-row group of either kernel is emulated as its C warps compute it:
staged rows at the kernel's pitch, Q's, K's, V's and P's fragments read at
the kernel's offsets and placed by the PTX maps of mma.sync m16n8k8
(tests/tf32_emulation.py), every product hi*lo + lo*hi + hi*hi of operands
split by truncation, fp32 sums; pass 1's row max over the chunks that can
be live, the stack's -5e29 clamp or none, pass 2's p, sum p and P.V from the
S accumulator, the warps' meeting and the epilogue. The stack's emulation is
held against ``layer_stack.attention_plain`` at the fp32 gate (keep masks, a
fully pruned keep row, lengths of 0 and a kv length inside a chunk), the
bidirectional one against JAX's ``bidirectional_cross_attention`` at fp32
(Pallas interpret mode), an empty side exactly 0 where JAX gives the mean of
the padded values (ROADMAP queue 3). Also the two fp32 launch plans at the
stack's buckets and the pad-to-64 shapes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.kernels import attention as jax_attn
from lightglue_tpu_torch.kernels import _build, attention, layer_stack
from tf32_emulation import mma_tf32_maps, split_rz

FP = 68       # csrc/mma.cuh:FP, the fp32 row pitch of the staged rows
KC = 64       # csrc/mma.cuh:KC, keys per staged chunk
NEG, DEAD = -1e30, -5e29
GATE = dict(atol=1e-4, rtol=1e-4)  # the fp32 rung's gate (chip_smoke.py TOL["fp32"])

_LANES = np.arange(32)
_G, _T4 = _LANES // 4, _LANES % 4
_AMAP, _BMAP, _CMAP = (np.array([[m[lane, i] for i in range(n)] for lane in range(32)])
                       for m, n in zip(mma_tf32_maps(), (4, 2, 4)))  # (32, regs, 2)


def _split(x):
    """(hi, lo) of fp32 registers as mma.sync reads them (split_tf32_rz)."""
    hi, lo = split_rz(torch.from_numpy(np.ascontiguousarray(x, np.float32)))
    return hi.numpy(), lo.numpy()


def _mma(d, a, b):
    """d (32, 4) + one m16n8k8 product of per-lane registers a (32, 4) and
    b (32, 2), placed by the PTX maps; exact products, one fp32 rounding."""
    am, bm = np.zeros((16, 8)), np.zeros((8, 8))
    am[_AMAP[..., 0], _AMAP[..., 1]] = a
    bm[_BMAP[..., 0], _BMAP[..., 1]] = b
    return (d + (am @ bm)[_CMAP[..., 0], _CMAP[..., 1]]).astype(np.float32)


def _mma3(d, ah, al, b):
    """mma.cuh:mma_3xtf32 with b split as it loads: hi*lo, lo*hi, hi*hi."""
    bh, bl = _split(b)
    return _mma(_mma(_mma(d, ah, bl), al, bh), ah, bh)


def _quad(x, op):
    """mma.cuh:quad_max / quad_sum: lanes xor 1, then xor 2."""
    x = op(x, x[_LANES ^ 1])
    return op(x, x[_LANES ^ 2])


def _group(q, k, v, *, C, live_k, keep_kv=None, clamp):
    """One 16-row group of the 3xTF32 block (rows past the valid ones zero in
    q): the kernel's l and P.V of rows 0..15 before its epilogue, (16,) and
    (16, 64). live_k: the keys that can be live (chunks past them are not
    computed); keep_kv: (Nk,) keep mask (the stack's KEEP) or None; clamp:
    the stack's -5e29 clamp of the row max."""
    nk, kw = k.shape[0], KC // C
    nt, nc = kw // 8, -(-live_k // KC)
    scale = np.float32(1 / 8)
    qs = np.zeros(16 * FP, np.float32)
    for r in range(16):
        qs[r * FP:r * FP + 64] = q[r]
    qh, ql = zip(*(_split(np.stack([qs[_G * FP + kk * 8 + _T4 + off]
                                    for off in (0, 8 * FP, 4, 8 * FP + 4)], 1))
                   for kk in range(8)))

    def chunk(x, c):  # a staged chunk, rows past Nk zero
        buf = np.zeros(KC * FP, np.float32)
        for j in range(min(KC, nk - c * KC)):
            buf[j * FP:j * FP + 64] = x[c * KC + j]
        return buf

    def scores(kbuf, c, part):  # mma.cuh:tf32_scores, then the kernel's masks
        s = np.zeros((nt, 32, 4), np.float32)
        for kk in range(8):
            for n in range(nt):
                kr = (part * kw + n * 8 + _G) * FP + kk * 8 + _T4
                s[n] = _mma3(s[n], qh[kk], ql[kk], np.stack([kbuf[kr], kbuf[kr + 4]], 1))
        col = (c * KC + part * kw + np.arange(nt)[:, None, None] * 8 + 2 * _T4[:, None]
               + np.arange(4) % 2)
        x = s * scale
        if keep_kv is not None or c * KC + KC > live_k:
            pad = col >= nk
            dead = (keep_kv[np.minimum(col, nk - 1)] < 0.5) if keep_kv is not None else col >= live_k
            x = np.where(pad, -np.inf, np.where(dead, NEG, x)).astype(np.float32)
        return x

    kbufs = [chunk(k, c) for c in range(nc)]
    vbufs = [chunk(v, c) for c in range(nc)]
    mx = np.full((C, 32, 2), -np.inf, np.float32)  # pass 1: the row max
    for part in range(C):
        for c in range(nc):
            s = scores(kbufs[c], c, part)
            mx[part] = np.maximum(mx[part], np.stack([s[..., :2].max((0, 2)),
                                                      s[..., 2:].max((0, 2))], 1))
        mx[part] = _quad(mx[part], np.maximum)
    m = mx.max(0)  # meet_max: the same rows in every warp of the group
    if clamp:
        m = np.maximum(m, np.float32(DEAD))
    ps = np.zeros((C, 32, 2), np.float32)  # pass 2: p, sum p and P.V
    pv = np.zeros((C, 8, 32, 4), np.float32)
    for part in range(C):
        for c in range(nc):
            p = np.exp(scores(kbufs[c], c, part) - np.repeat(m, 2, 1)).astype(np.float32)
            for n in range(nt):
                for e in range(4):
                    ps[part, :, e // 2] += p[n, :, e]
            for kk in range(nt):  # mma.cuh:tf32_pv, P unshuffled from the accumulator
                ah, al = _split(p[kk][:, [0, 2, 1, 3]])
                for dn in range(8):
                    vr = (part * kw + kk * 8 + 2 * _T4) * FP + dn * 8 + _G
                    pv[part, dn] = _mma3(pv[part, dn], ah, al,
                                         np.stack([vbufs[c][vr], vbufs[c][vr + FP]], 1))
        ps[part] = _quad(ps[part], np.add)
    l_sum, pv_sum = np.zeros((32, 2), np.float32), np.zeros((8, 32, 4), np.float32)
    for part in range(C):  # meet_sums, in warp order
        l_sum += ps[part]
        pv_sum += pv[part]
    l_rows, pv_rows = np.zeros(16, np.float32), np.zeros((16, 64), np.float32)
    for lane in range(32):
        g, t4 = divmod(lane, 4)
        for i in range(2):
            l_rows[g + 8 * i] = l_sum[lane, i]
            for dn in range(8):
                pv_rows[g + 8 * i, dn * 8 + 2 * t4:dn * 8 + 2 * t4 + 2] = pv_sum[dn, lane,
                                                                                 2 * i:2 * i + 2]
    return l_rows, pv_rows


def _rows(q, k, v, *, C, lq, live_k, keep_q=None, keep_kv=None, clamp):
    """The kernel's output rows of one head (Nq, 64) over its 16-row
    groups: a group wholly past q_len writes zeros; o = P.V / (l == 0 ? 1 :
    l), then the keep multiply (KEEP) or rows past q_len 0."""
    nq = q.shape[0]
    out = np.zeros((nq, 64), np.float32)
    for i0 in range(0, nq, 16):
        if keep_q is None and i0 >= lq:
            continue
        qg = np.zeros((16, 64), np.float32)
        qg[:min(16, nq - i0)] = q[i0:i0 + 16]
        l, pv = _group(qg, k, v, C=C, live_k=live_k, keep_kv=keep_kv, clamp=clamp)
        o = pv / np.where(l == 0, np.float32(1), l)[:, None]
        rows = i0 + np.arange(16)
        o = o * keep_q[np.minimum(rows, nq - 1)][:, None] if keep_q is not None else np.where(
            (rows < lq)[:, None], o, 0)
        n = min(16, nq - i0)
        out[i0:i0 + n] = o[:n]
    return out


def _freqs(rng, n):
    ang = rng.uniform(-3, 3, (1, n, 32)).astype(np.float32)
    emb = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    return torch.from_numpy(np.concatenate([emb, emb], axis=-1))


def _rotate(f, x):
    """x (N, 64) rotated with freqs f, as the kernel's fp32 pre-pass does."""
    return layer_stack.apply_rotary(f, torch.from_numpy(x)[None, None])[0, 0].numpy()


# (Nq, Nk, C, lengths (q, kv) or None, keep: None, "random" or "pruned")
STACK_CASES = {
    "self rope 96x96, unmasked, a short last chunk, C 4": (96, 96, 4, None, None),
    "cross 24x192, kv_len 100 inside a chunk, C 1": (24, 192, 1, (20, 100), None),
    "cross 16x128, kv_len 0, C 2": (16, 128, 2, (16, 0), None),
    "cross 32x64, q_len 0, C 1": (32, 64, 1, (0, 64), None),
    "32x192, keep masked, C 2": (32, 192, 2, None, "random"),
    "cross 16x128, a fully pruned kv keep, C 4": (16, 128, 4, None, "pruned"),
}


@pytest.mark.parametrize("case", list(STACK_CASES))
def test_stack_tf32_block_by_fragments_matches_plain(case):
    """attention_tf32_kernel's 16-row groups, emulated through the PTX maps
    in 3xTF32, agree with ``attention_plain`` (one head, fp32 operands and
    stats) within the fp32 gate 1e-4; rows past q_len, the rows of a kv_len
    of 0 and every row of a fully pruned kv keep vector are exactly 0."""
    nq, nk, c, lens, keep = STACK_CASES[case]
    rng = np.random.default_rng(79)
    q, k, v = (rng.standard_normal((n, 64), dtype=np.float32) for n in (nq, nk, nk))
    f, qe, ke = None, q, k
    if "rope" in case:  # the kernel reads q and k rotated by lg_rope_qk
        f = _freqs(rng, nq)
        qe, ke = _rotate(f, q), _rotate(f, k)
    keep_q = keep_kv = None
    if keep is not None:
        keep_q = (rng.uniform(size=nq) > 0.25).astype(np.float32)
        keep_kv = np.zeros(nk, np.float32) if keep == "pruned" else (
            rng.uniform(size=nk) > 0.3).astype(np.float32)
    lq, lk = lens or (nq, nk)
    got = _rows(qe, ke, v, C=c, lq=lq, live_k=nk if keep else lk, keep_q=keep_q,
                keep_kv=keep_kv, clamp=lens is not None or keep is not None)
    lt = [None, None] if lens is None else [torch.tensor([x], dtype=torch.int32) for x in lens]
    want = layer_stack.attention_plain(
        *(torch.from_numpy(x)[None] for x in (q, k, v)), f, *lt, 1, torch.float32,
        keep_q=None if keep is None else torch.from_numpy(keep_q)[None],
        keep_kv=None if keep is None else torch.from_numpy(keep_kv)[None])[0].numpy()
    np.testing.assert_allclose(got, want, **GATE)
    zero = (np.arange(nq) >= lq) | (lk == 0) | (keep == "pruned")
    assert zero.any() == (lens is not None or keep == "pruned")
    assert not got[zero].any()


# (B, N0, N1, lengths [n0, n1] per pair or None, C)
BIDIR_CASES = {
    "unmasked 32x80, C 4": (1, 32, 80, None, 4),
    "ragged 48x192, kv lengths inside chunks, C 2": (2, 48, 192, [[40, 150], [48, 70]], 2),
    "n1 0 and n0 0, C 1": (3, 32, 128, [[30, 0], [0, 100], [20, 128]], 1),
}


@pytest.mark.parametrize("case", list(BIDIR_CASES))
def test_bidir_tf32_block_by_fragments_matches_jax(case):
    """bidir_tf32_kernel's blocks of both directions, emulated through the
    PTX maps in 3xTF32 ((Q, K, V) = (qk0, qk1, v1) with lengths (n0, n1),
    then (qk1, qk0, v0) with (n1, n0); no clamp), agree with JAX's
    bidirectional_cross_attention at fp32 (H = 1, Pallas interpret mode)
    within the fp32 gate 1e-4; padded rows are exactly 0, and so is every
    row of a direction whose kv side is empty, where JAX gives the mean of
    the padded values (the port's documented departure, ROADMAP queue 3)."""
    b, n0, n1, lens, c = BIDIR_CASES[case]
    rng = np.random.default_rng(83)
    qk0, qk1, v0, v1 = (rng.standard_normal((b, n, 64), dtype=np.float32)
                        for n in (n0, n1, n0, n1))
    ln = np.asarray(lens or [[n0, n1]] * b, np.int32)
    want = jax_attn.bidirectional_cross_attention(
        *map(jnp.asarray, (qk0, qk1, v0, v1)), None if lens is None else jnp.asarray(ln),
        num_heads=1)
    for i in range(b):
        len0, len1 = ln[i]
        for o, (q, k, v, lq, lk) in enumerate(((qk0[i], qk1[i], v1[i], len0, len1),
                                                (qk1[i], qk0[i], v0[i], len1, len0))):
            got = np.zeros((q.shape[0], 64), np.float32)
            if lk:  # an empty kv side: the block writes its zero rows first
                got = _rows(q, k, v, C=c, lq=lq, live_k=lk, clamp=False)
            rows = np.arange(q.shape[0]) >= lq
            assert not got[rows].any()
            if lk == 0:
                assert not got.any()
                continue
            np.testing.assert_allclose(got, np.asarray(want[o][i]), **GATE)


# the stack's buckets (one and two pairs) and the pad-to-64 route's shapes
STACK_BUCKETS = [(b, n) for b in (1, 2) for n in range(128, 1025, 128)]


@pytest.mark.parametrize("shape", STACK_BUCKETS, ids=[f"B{b} N{n}" for b, n in STACK_BUCKETS])
def test_fp32_attention_plan_mirrors_the_row_group_rule(shape):
    """attention_plan's fp32 launch is lg_attention's FP32 launch
    (csrc/attention.cu:tf32_plan, lg_attention_plan), computed here: the
    row groups of mma.cuh:fill_row_groups (256 blocks of four warps for one
    pair, at any batch), the keys of each chunk split 4 / groups ways; where
    that is one group and the batch's 64- or 32-row blocks still number 128,
    four or two groups in one block of sixteen or eight warps.
    Shared memory mma.cuh:tf32_smem, whatever Nk: two four-warp blocks an
    SM, or one eight-warp block."""
    b, n = shape
    groups = next((g for g in (4, 2) if 4 * -(-n // (16 * g)) >= 256), 1)
    split = 4 // groups
    if groups == 1:
        groups = next((g for g in (4, 2) if b * 4 * -(-n // (16 * g)) >= 128), 1)
    for nk in (n, 1024):
        plan = layer_stack.attention_plan(b, 4, n, nk, torch.float32)
        assert (plan.row_groups, plan.col_split) == (groups, split)
        assert plan.blocks == b * 4 * -(-n // (16 * groups))
        assert plan.smem == (4 * (16 * groups + 2 * 64 * 2) * FP
                             + (split > 1) * 4 * groups * split * 16 * 74)
        assert (1 if groups * split > 4 else 2) * plan.smem <= _build.MAX_DYNAMIC_SMEM


# (B, N0, N1) -> fp32 row groups: the pad-to-64 cap, its mixed buckets, two
# pairs (two of one pair's groups in an eight-warp block)
PAD64_PLANS = {(1, 960, 960): 2, (1, 960, 704): 2, (1, 960, 64): 2, (2, 960, 960): 4,
               (2, 960, 64): 4, (1, 128, 64): 1}


@pytest.mark.parametrize("shape", list(PAD64_PLANS), ids=[f"B{b} {n0}x{n1}"
                                                         for b, n0, n1 in PAD64_PLANS])
def test_fp32_bidir_plan_at_pad64_shapes(shape):
    """bidir_plan's fp32 launch at the pad-to-64 route's shapes: both
    directions' 16-row groups aiming for 128 blocks (csrc/bidir_cross.cu:
    BIDIR_FILL_BLOCKS), tf32_smem, two blocks an SM."""
    b, n0, n1 = shape
    groups = PAD64_PLANS[shape]
    plan = attention.bidir_plan(b, 4, n0, n1, torch.float32)
    rows = 16 * groups
    split = attention.bidir_plan(1, 4, n0, n1, torch.float32).col_split  # the pair's
    assert (plan.row_groups, plan.col_split) == (groups, split)
    assert plan.blocks == b * 4 * (-(-n0 // rows) - (-n1 // rows))
    assert groups == 1 or plan.blocks >= 128
    assert plan.smem == layer_stack.tf32_smem(groups, 2, split)
    assert (1 if groups * split > 4 else 2) * plan.smem <= _build.MAX_DYNAMIC_SMEM
