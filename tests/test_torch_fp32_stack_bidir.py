"""The FP32 rung's 3xTF32 stack attention (csrc/attention.cu:
attention_tf32_wgmma_kernel, on Hopper's warpgroup MMA) and bidirectional
kernel (csrc/bidir_cross.cu:bidir_tf32_kernel, on mma.sync) on the CPU.

A 64-row tile of the stack's kernel is emulated as its consumer warpgroups
compute it: Q and 32-key pieces of K as TMA writes them (128 B swizzle) and
their lo copies, read through the kernel's K-major descriptors; P from the S
accumulator as the register-A operand, split; V written transposed in P's
key order as hi and lo copies; every product hi*lo + lo*hi + hi*hi of
operands split by truncation; the consumers' chunks in either split, pass
1's row max, the -5e29 clamp, pass 2's p, sum p and P.V and the meeting in
the kernel's order (tests/tf32_emulation.py). It is held against
``layer_stack.attention_plain`` at the fp32 gate (keep masks, a fully pruned
keep row, lengths of 0 and a kv length inside a chunk). A 16-row group of
the bidirectional kernel is emulated as its C warps compute it: staged rows
at the kernel's pitch, fragments placed by the PTX maps of mma.sync m16n8k8,
held against JAX's ``bidirectional_cross_attention`` at fp32 (Pallas
interpret mode), an empty side exactly 0 where JAX gives the mean of the
padded values (ROADMAP queue 3). Also both fp32 launch plans: the stack's
at its buckets and one to eight pairs, the bidirectional one at the
pad-to-64 shapes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.kernels import attention as jax_attn
from lightglue_tpu_torch.kernels import _build, attention, layer_stack
from tf32_emulation import (a_fragment_matrix, b_operand, index_map, mma_tf32_maps,
                            p_register, split_rz, tf32_rz, tma_halves, vt_copy, vt_operand)

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


# ---------------------------------------------------------------------------
# the stack's fp32 kernel on wgmma (csrc/attention.cu:attention_tf32_wgmma_kernel)
# ---------------------------------------------------------------------------

# the flat indices each layout reads, computed once: a k8 step of a K-major
# tile of 64 (Q) or 32 (a K piece) rows through its descriptor ([kk][8][rows]);
# V^T's copy of a [32][64] piece and its k8 steps; P's register A of a k8
# step from the S accumulator of a piece ([kk][64][8] into the 64 x 32 piece)
_KMAJOR = {rows: np.stack([index_map(lambda f: b_operand(f, rows, kk), rows * 64)
                           for kk in range(8)]) for rows in (64, 32)}
_VT_COPY = index_map(lambda f: vt_copy(f.reshape(32, 64)), 32 * 64)
_VT_READ = np.stack([index_map(lambda f: vt_operand(f, kk), 64 * 32) for kk in range(4)])
_P_REG = np.stack([index_map(lambda f: a_fragment_matrix(
    lambda w, lane, i: p_register(f.reshape(64, 32), w, lane, i, kk)), 64 * 32)
    for kk in range(4)])


def _split_raw(flat):
    """A raw fp32 tile as wgmma reads it in 3xTF32: the raw word read
    truncated as hi, the consumer's lo copy (x - hi at the same offsets)
    read truncated as lo."""
    hi = tf32_rz(torch.from_numpy(flat)).numpy()
    return hi, tf32_rz(torch.from_numpy(flat - hi)).numpy()


def _kmajor(flat, rows, kk):
    """A[row][k] of k8 step kk of a K-major tile through its descriptor."""
    return flat[_KMAJOR[rows][kk]].T.astype(np.float64)


def _wgmma_tile(q, k, v, *, split, live_k, keep_kv=None, clamp):
    """One 64-row tile of attention_tf32_wgmma_kernel in numpy (rows past
    Nq zero in q): Q as TMA writes it (two 32-float halves, 128 B swizzle)
    and its lo copy; consumer gc takes chunks j = gc, gc + split, .. below
    live_k, each as two 32-key pieces: S = Q_hi.K_lo + Q_lo.K_hi + Q_hi.K_hi
    through the K-major descriptors, scaled, pad columns -inf and dead ones
    -1e30; pass 1's row max over the consumers (clamped at -5e29 when
    masked); pass 2's p, sum p and P.V with P split from the S accumulator
    as register A against V^T's hi and lo copies (keys in P's slot order)
    through their descriptors; the consumers' partials met in the kernel's
    order (a split of 8: q_c = p_c + p_{c + 4}, then q_0 .. q_3). Returns
    the tile's l (64,) and P.V (64, 64) before the epilogue."""
    nk = k.shape[0]
    nc = -(-live_k // 64)
    scale = np.float32(1 / 8)
    qh, ql = _split_raw(tma_halves(q))

    def piece(x, row):  # a 32-key piece of K or V as TMA brings it: zeros past Nk
        out = np.zeros((32, 64), np.float32)
        n = max(min(32, nk - row), 0)
        out[:n] = x[row:row + n]
        return out

    def scores(row):
        kh, kl = _split_raw(tma_halves(piece(k, row)))
        s = np.zeros((64, 32))
        for a, b in ((qh, kl), (ql, kh), (qh, kh)):
            for kk in range(8):
                s += _kmajor(a, 64, kk) @ _kmajor(b, 32, kk).T
        x = s.astype(np.float32) * scale
        col = row + np.arange(32)
        if keep_kv is not None or row + 32 > live_k:
            dead = (keep_kv[np.minimum(col, nk - 1)] < 0.5) if keep_kv is not None else (
                col >= live_k)
            x = np.where(col >= nk, -np.inf, np.where(dead, NEG, x)).astype(np.float32)
        return x

    rows_of = [[j * 64 + 32 * hp for j in range(gc, nc, split) for hp in (0, 1)]
               for gc in range(split)]
    mx = np.full(64, -np.inf, np.float32)
    for rows in rows_of:  # pass 1
        for row in rows:
            mx = np.maximum(mx, scores(row).max(1))
    m = np.maximum(mx, np.float32(DEAD)) if clamp else mx
    ps = np.zeros((split, 64), np.float32)
    pv = np.zeros((split, 64, 64), np.float32)
    for gc, rows in enumerate(rows_of):  # pass 2
        acc = np.zeros((64, 64))
        for row in rows:
            p = np.exp(scores(row) - m[:, None]).astype(np.float32)
            ps[gc] += p.sum(1, dtype=np.float32)
            ph, pl = (x.reshape(-1) for x in _split_raw(p))
            vh, vl = (x.reshape(-1)[_VT_COPY] for x in _split_raw(piece(v, row)))
            for kk in range(4):
                ah, al = ph[_P_REG[kk]], pl[_P_REG[kk]]
                bh, bl = vh[_VT_READ[kk]], vl[_VT_READ[kk]]
                acc += ah @ bl + al @ bh + ah @ bh
        pv[gc] = acc.astype(np.float32)
    if split == 8:
        ps, pv = ps[:4] + ps[4:], pv[:4] + pv[4:]
    l_sum, pv_sum = np.zeros(64, np.float32), np.zeros((64, 64), np.float32)
    for c in range(4):
        l_sum += ps[c]
        pv_sum += pv[c]
    return l_sum, pv_sum


def _wgmma_rows(q, k, v, *, split, lq, live_k, keep_q=None, keep_kv=None, clamp):
    """The kernel's output rows of one head (Nq, 64) over its 64-row tiles:
    a tile wholly past q_len writes zeros; o = P.V / (l == 0 ? 1 : l), then
    the keep multiply (KEEP) or rows past q_len 0."""
    nq = q.shape[0]
    out = np.zeros((nq, 64), np.float32)
    for i0 in range(0, nq, 64):
        if keep_q is None and i0 >= lq:
            continue
        qt = np.zeros((64, 64), np.float32)
        qt[:min(64, nq - i0)] = q[i0:i0 + 64]
        l, pv = _wgmma_tile(qt, k, v, split=split, live_k=live_k, keep_kv=keep_kv, clamp=clamp)
        o = pv / np.where(l == 0, np.float32(1), l)[:, None]
        rows = i0 + np.arange(64)
        o = o * keep_q[np.minimum(rows, nq - 1)][:, None] if keep_q is not None else np.where(
            (rows < lq)[:, None], o, 0)
        n = min(64, nq - i0)
        out[i0:i0 + n] = o[:n]
    return out


# (Nq, Nk, split, lengths (q, kv) or None, keep: None, "random" or "pruned")
STACK_CASES = {
    "self rope 96x96, unmasked, a short last chunk, split 8": (96, 96, 8, None, None),
    "cross 24x192, kv_len 100 inside a chunk, split 4": (24, 192, 4, (20, 100), None),
    "cross 16x128, kv_len 0, split 8": (16, 128, 8, (16, 0), None),
    "cross 80x64, q_len 0, split 4": (80, 64, 4, (0, 64), None),
    "72x320, keep masked, split 8": (72, 320, 8, None, "random"),
    "cross 16x128, a fully pruned kv keep, split 4": (16, 128, 4, None, "pruned"),
}


@pytest.mark.parametrize("case", list(STACK_CASES))
def test_stack_tf32_block_by_fragments_matches_plain(case):
    """attention_tf32_wgmma_kernel's 64-row tiles, emulated through the
    kernel's layouts (K-major descriptors over TMA's 128 B swizzle and the
    lo copies, P as register A, V^T hi and lo) in 3xTF32, agree with
    ``attention_plain`` (one head, fp32 operands and stats) within the fp32
    gate 1e-4 in either split; rows past q_len, the rows of a kv_len of 0
    and every row of a fully pruned kv keep vector are exactly 0."""
    nq, nk, split, lens, keep = STACK_CASES[case]
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
    got = _wgmma_rows(qe, ke, v, split=split, lq=lq, live_k=nk if keep else lk, keep_q=keep_q,
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


# the stack's buckets at one to eight pairs
STACK_BUCKETS = [(b, n) for b in (1, 2, 4, 8) for n in range(128, 1025, 128)]


def _tf32_smem() -> int:
    """An fp32 stack-attention block's bytes, counted the way
    csrc/attention.cu:TfSmem lays them out: Q and its lo copy (64 x 64 fp32
    each); four warpgroups' regions (one slot of a 32-key piece of K and of
    V, then K's lo copy and V^T hi and lo, 32 x 64 fp32 each); row max and
    sum p per warpgroup; the cluster's row max; 9 barriers; 1 KB of
    alignment."""
    piece = 32 * 64 * 4
    return 2 * 64 * 64 * 4 + 4 * 5 * piece + 2 * 4 * 64 * 4 + 64 * 4 + 9 * 8 + 1024


@pytest.mark.parametrize("shape", STACK_BUCKETS, ids=[f"B{b} N{n}" for b, n in STACK_BUCKETS])
def test_fp32_attention_plan_mirrors_the_split_rule(shape):
    """attention_plan's fp32 launch is lg_attention's FP32 launch
    (csrc/attention.cu:tf32_split, lg_attention_plan), computed here: a
    64-row tile of a head split 8 ways where one pair's tiles, two blocks
    each, fit the card's 132 SMs (always a cluster of two blocks), else 4
    ways (one block); the split and the form one pair's at B = 1, 2, 4 and 8,
    the batch only adding blocks; shared memory as the kernel lays it out,
    whatever Nk, one block an SM."""
    b, n = shape
    tiles = 4 * -(-n // 64)
    split = 8 if 2 * tiles <= 132 else 4
    one = layer_stack.attention_plan(1, 4, n, n, torch.float32)
    for nk in (n, 1024):
        plan = layer_stack.attention_plan(b, 4, n, nk, torch.float32)
        assert plan.kernel == "attention_tf32_wgmma_kernel"
        assert (plan.row_groups, plan.col_split) == (4, split) == (one.row_groups, one.col_split)
        assert plan.blocks == b * tiles * (2 if split == 8 else 1) == b * one.blocks
        assert plan.smem == _tf32_smem() == layer_stack.wgmma_tf32_attention_smem() == one.smem
        assert plan.smem <= _build.MAX_DYNAMIC_SMEM
        for sdt in (torch.float32, torch.bfloat16):  # bf16 stats take the same launch
            assert layer_stack.attention_plan(b, 4, n, nk, torch.float32, sdt) == plan
    assert layer_stack.tf32_split(4, n) == split
    assert layer_stack.tf32_split(8, 1024) == 4  # 128 tiles of a pair: one block a tile


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
