"""The FP32 rung's 3xTF32 attention tile on Hopper's warpgroup MMA
(csrc/attention_tile.cuh:attention_tf32_tile) on the CPU, as both its
kernels run it: the layer stack's attention (csrc/attention.cu:
attention_tf32_wgmma_kernel) and both cross directions in one grid
(csrc/bidir_cross.cu:bidir_tf32_wgmma_kernel).

A 64-row tile is emulated as its consumer warpgroups compute it: Q and
32-key pieces of K as TMA writes them (128 B swizzle) and their lo copies,
read through the kernel's K-major descriptors; P from the S accumulator as
the register-A operand, split; V written transposed in P's key order as hi
and lo copies; every product hi*lo + lo*hi + hi*hi of operands split by
truncation; the consumers' chunks in either split, pass 1's row max, the
-5e29 clamp where the stack masks, pass 2's p, sum p and P.V and the
meeting in the kernel's order (tests/tf32_emulation.py). The stack's tiles
are held against ``layer_stack.attention_plain`` at the fp32 gate (keep
masks, a fully pruned keep row, lengths of 0 and a kv length inside a
chunk); the bidirectional kernel's tiles of both directions (no clamp, pad
keys past Nk at -inf, an empty kv side's rows written as zeros first)
against JAX's ``bidirectional_cross_attention`` at fp32 (Pallas interpret
mode), an empty side exactly 0 where JAX gives the mean of the padded
values (ROADMAP queue 3); the same tiles without the pad keys' -inf miss
the gate, which is what the emulation guards. Also the bidirectional grid
(each tile of each direction, head and pair once, a cluster's blocks
together) and both fp32 launch plans: the stack's at its buckets and one to
eight pairs, the bidirectional one at the pad-to-64 shapes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.kernels import attention as jax_attn
from lightglue_tpu_torch.kernels import _build, attention, layer_stack
from tf32_emulation import (a_fragment_matrix, b_operand, index_map, p_register, tf32_rz,
                            tma_halves, vt_copy, vt_operand)

NEG, DEAD = -1e30, -5e29
GATE = dict(atol=1e-4, rtol=1e-4)  # the fp32 rung's gate (chip_smoke.py TOL["fp32"])
SMS = 132  # the card's SMs, which a split of 8's clusters of two blocks a tile must fit


def _freqs(rng, n):
    ang = rng.uniform(-3, 3, (1, n, 32)).astype(np.float32)
    emb = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    return torch.from_numpy(np.concatenate([emb, emb], axis=-1))


def _rotate(f, x):
    """x (N, 64) rotated with freqs f, as the kernel's fp32 pre-pass does."""
    return layer_stack.apply_rotary(f, torch.from_numpy(x)[None, None])[0, 0].numpy()


# ---------------------------------------------------------------------------
# the fp32 tile on wgmma (csrc/attention_tile.cuh:attention_tf32_tile)
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


def _wgmma_tile(q, k, v, *, split, live_k, keep_kv=None, clamp, pad=True):
    """One 64-row tile of attention_tf32_tile in numpy (rows past
    Nq zero in q): Q as TMA writes it (two 32-float halves, 128 B swizzle)
    and its lo copy; consumer gc takes chunks j = gc, gc + split, .. below
    live_k, each as two 32-key pieces: S = Q_hi.K_lo + Q_lo.K_hi + Q_hi.K_hi
    through the K-major descriptors, scaled, pad columns -inf and dead ones
    -1e30; pass 1's row max over the consumers (clamped at -5e29 when
    masked); pass 2's p, sum p and P.V with P split from the S accumulator
    as register A against V^T's hi and lo copies (keys in P's slot order)
    through their descriptors; the consumers' partials met in the kernel's
    order (a split of 8: q_c = p_c + p_{c + 4}, then q_0 .. q_3). Returns
    the tile's l (64,) and P.V (64, 64) before the epilogue. ``pad=False``
    is a wrong design: keys past Nk keep the score of TMA's zero rows."""
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
            x = np.where(dead & (col < nk), NEG, x)
            x = np.where((col >= nk) & pad, -np.inf, x).astype(np.float32)
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


def _wgmma_rows(q, k, v, *, split, lq, live_k, keep_q=None, keep_kv=None, clamp, pad=True):
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
        l, pv = _wgmma_tile(qt, k, v, split=split, live_k=live_k, keep_kv=keep_kv, clamp=clamp,
                            pad=pad)
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


def _bidir_rows(qk0, qk1, v0, v1, lens, split, pad=True):
    """Both outputs of one head (H = 1) as bidir_tf32_wgmma_kernel computes
    them, a direction's tiles through _wgmma_rows: direction 0 (Q, K, V) =
    (qk0, qk1, v1) with lengths (n0, n1), direction 1 (qk1, qk0, v0) with
    (n1, n0); no clamp; an empty kv side as a q length of 0 (its tiles write
    their zeros first)."""
    outs = ([], [])
    for i, (len0, len1) in enumerate(lens):
        for o, (q, k, v, lq, lk) in enumerate(((qk0[i], qk1[i], v1[i], len0, len1),
                                                (qk1[i], qk0[i], v0[i], len1, len0))):
            live_k = max(min(lk, k.shape[0]), 0)
            outs[o].append(_wgmma_rows(q, k, v, split=split, lq=lq if live_k else 0,
                                       live_k=live_k, clamp=False, pad=pad))
    return tuple(np.stack(x) for x in outs)


def _bidir_inputs(b, n0, n1, lens, seed=83):
    rng = np.random.default_rng(seed)
    ops = tuple(rng.standard_normal((b, n, 64), dtype=np.float32) for n in (n0, n1, n0, n1))
    ln = np.asarray(lens or [[n0, n1]] * b, np.int32)
    want = jax_attn.bidirectional_cross_attention(
        *map(jnp.asarray, ops), None if lens is None else jnp.asarray(ln), num_heads=1)
    return ops, ln, tuple(np.asarray(w) for w in want)


# (B, N0, N1, lengths [n0, n1] per pair or None, split)
BIDIR_CASES = {
    "unmasked 32x80, split 8": (1, 32, 80, None, 8),
    "ragged 48x192, kv lengths inside chunks, split 4": (2, 48, 192, [[40, 150], [48, 70]], 4),
    "n1 0 and n0 0, split 8": (3, 32, 128, [[30, 0], [0, 100], [20, 128]], 8),
    "masked 80x320, a consumer's second chunk, split 4": (1, 80, 320, [[70, 300]], 4),
    "unmasked 72x600, keys past Nk inside a piece, split 8": (1, 72, 600, None, 8),
}


@pytest.mark.parametrize("case", list(BIDIR_CASES))
def test_bidir_tf32_block_by_fragments_matches_jax(case):
    """bidir_tf32_wgmma_kernel's 64-row tiles of both directions, emulated
    through the wgmma layouts in 3xTF32 ((Q, K, V) = (qk0, qk1, v1) with
    lengths (n0, n1), then (qk1, qk0, v0) with (n1, n0); no clamp; pad keys
    past Nk at -inf, where Nk is no multiple of 64 or 32; chunks past the
    live keys skipped), agree with JAX's bidirectional_cross_attention at
    fp32 (H = 1, Pallas interpret mode) within the fp32 gate 1e-4 at either
    split; padded rows are exactly 0, and so is every row of a direction
    whose kv side is empty, where JAX gives the mean of the padded values
    (the port's documented departure, ROADMAP queue 3)."""
    b, n0, n1, lens, split = BIDIR_CASES[case]
    (qk0, qk1, v0, v1), ln, want = _bidir_inputs(b, n0, n1, lens)
    got = _bidir_rows(qk0, qk1, v0, v1, ln, split)
    for o in (0, 1):
        for i in range(b):
            lq, lk = ln[i, o], ln[i, 1 - o]
            assert not got[o][i, lq:].any()
            if lk == 0:
                assert not got[o][i].any()
                continue
            np.testing.assert_allclose(got[o][i], want[o][i], **GATE)


@pytest.mark.parametrize("shape", [(40, 80), (72, 600)], ids=["32x80", "72x600"])
def test_bidir_pad_keys_past_nk_are_masked(shape):
    """The premise of the pad keys' -inf: without it (TMA brings rows past
    Nk as zeros, whose score is 0), the emulated tiles miss the fp32 gate
    against JAX, unmasked, in the direction whose Nk is no multiple of 64;
    so the emulation above holds the kernel to it."""
    n0, n1 = shape
    (qk0, qk1, v0, v1), ln, want = _bidir_inputs(1, n0, n1, None)
    wrong = _bidir_rows(qk0, qk1, v0, v1, ln, 8, pad=False)
    assert np.abs(wrong[0] - want[0]).max() > 10 * GATE["atol"]


def _grid(batch, heads, n0, n1, split):
    """(pair, head, direction, first row, cluster rank) of each block of
    bidir_tf32_wgmma_kernel's grid as the kernel reads blockIdx: x over
    direction 0's tiles, CLUSTER blocks each, then direction 1's."""
    cluster = 2 if split == 8 else 1
    t0, t1 = -(-n0 // 64), -(-n1 // 64)
    for bz in range(batch):
        for by in range(heads):
            for bx in range(cluster * (t0 + t1)):
                tile = bx // cluster
                dir1 = tile >= t0
                yield bz, by, int(dir1), (tile - t0 if dir1 else tile) * 64, bx % cluster


@pytest.mark.parametrize("shape", [(1, 4, 960, 960), (2, 4, 960, 704), (1, 1, 960, 960),
                                   (1, 2, 960, 64)],
                         ids=lambda s: "B{} H{} {}x{}".format(*s))
def test_bidir_grid_covers_each_tile_once(shape):
    """The plan's grid covers every 64-row tile of both directions, every
    head and pair, once per block of its form (a split of 8's two blocks a
    cluster, consecutive in x, ranks 0 and 1), and no block reaches past its
    direction's rows; the launch's blocks are the plan's."""
    b, h, n0, n1 = shape
    plan = attention.bidir_plan(b, h, n0, n1, torch.float32)
    blocks = list(_grid(b, h, n0, n1, plan.col_split))
    assert len(blocks) == plan.blocks
    cluster = 2 if plan.cluster else 1
    seen = {}
    for bz, by, d, i0, rank in blocks:
        assert i0 < (n0, n1)[d]
        seen.setdefault((bz, by, d, i0), []).append(rank)
    assert all(ranks == list(range(cluster)) for ranks in seen.values())
    assert sorted(seen) == sorted((bz, by, d, i0) for bz in range(b) for by in range(h)
                                  for d, n in enumerate((n0, n1)) for i0 in range(0, n, 64))


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


# (B, N0, N1, H): the pad-to-64 cap, its mixed buckets, two pairs, the TP
# shards' heads
PAD64_PLANS = [(1, 960, 960, 4), (1, 960, 704, 4), (1, 960, 64, 4), (2, 960, 960, 4),
               (1, 960, 960, 2), (1, 960, 960, 1)]


@pytest.mark.parametrize("shape", PAD64_PLANS, ids=[f"B{b} {n0}x{n1} H{h}"
                                                    for b, n0, n1, h in PAD64_PLANS])
def test_fp32_bidir_plan_at_pad64_shapes(shape):
    """bidir_plan's fp32 launch at the pad-to-64 route's shapes is the rule
    of csrc/bidir_cross.cu:bidir_plan, computed here: both directions' 64-row
    tiles a head, split 8 as a cluster of two blocks where one pair's tiles,
    two blocks each, fit the card's 132 SMs, else 4 in one block; the split
    and the form one pair's at B = 1, 2, 4 and 8, the batch only adding
    blocks; the fp32 tile's shared memory (the stack's), whatever N; one
    block an SM."""
    b, n0, n1, h = shape
    tiles = -(-n0 // 64) + -(-n1 // 64)
    split = 8 if 2 * h * tiles <= SMS else 4
    plan = attention.bidir_plan(b, h, n0, n1, torch.float32)
    assert plan.kernel == "bidir_tf32_wgmma_kernel"
    assert (plan.row_groups, plan.col_split, plan.cluster, plan.store) == (4, split, split == 8,
                                                                            False)
    assert plan.blocks == b * h * tiles * (2 if split == 8 else 1)
    assert plan.smem == _tf32_smem() == layer_stack.wgmma_tf32_attention_smem()
    assert plan.smem <= _build.MAX_DYNAMIC_SMEM
    for batch in (1, 2, 4, 8):
        other = attention.bidir_plan(batch, h, n0, n1, torch.float32)
        assert other[:2] == plan[:2] and other.cluster == plan.cluster
        assert other.blocks == batch * plan.blocks // b
    for sdt in (torch.float32, torch.bfloat16):  # bf16 stats take the same launch
        assert attention.bidir_plan(b, h, n0, n1, torch.float32, sdt) == plan
