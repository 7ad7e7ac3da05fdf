"""The W8A8 projection's kernels on the CPU: csrc/linear.cu's row_quant_kernel
and linear_s8_kernel, modelled in numpy as they move data (row_quant's
lanes, loads, butterfly amax and 16-byte q stores; the s8 GEMM's staged
rows of A and the K-major W^T, its ldmatrix fragments fed through the PTX
maps of mma.sync m16n8k32 (csrc/mma.cuh:mma_s8), the liveness gate and the
epilogue in the reference's order), held at error 0 against the plain
versions (``row_quant_plain``, ``linear_plain(w8a8=True)``) and the JAX q8
path (JAX ``_aquant`` / ``_doti8`` / ``_linear``'s q8 branch,
layer_stack.py:339-372, in jax.numpy), at the main path's five projection
shapes at a row count off every tile, with crafted rows (exact .5 ties of
v / sa, an all-zero row, a one-hot row, ffn1's amax in either operand); the
s8 GEMM's launch plan (``s8_plan``) and the INT8 tree's K-major ``w_t``."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lightglue_tpu import quant as jax_quant
from lightglue_tpu.config import LightGlueConfig as JLGC
from lightglue_tpu.runtime import weights as jax_weights
from lightglue_tpu_torch import quant
from lightglue_tpu_torch.kernels import layer_stack
from lightglue_tpu_torch.runtime import weights

BF16 = ml_dtypes.bfloat16
F32 = np.float32
LINEAR_CU = (Path(layer_stack.__file__).resolve().parent.parent / "csrc" / "linear.cu").read_text()


def _cu_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", LINEAR_CU).group(1))


QUANT_WARPS = _cu_int("QUANT_WARPS")  # warps of a row_quant block
S8_KC = _cu_int("S8_KC")              # K bytes of one cp.async group of the s8 GEMM
S8_WARPS = _cu_int("S8_WARPS")        # warps of an s8 GEMM block
# the main path's projections (chip_smoke.py:LIN_CASES): K1, K2 (ffn1's
# message), N, residual
LIN_CASES = {"self qkv": (256, 0, 768, False), "out": (256, 0, 256, False),
             "ffn1 cat": (256, 256, 512, False), "ffn2 +res": (512, 0, 256, True),
             "cross qk_v": (256, 0, 512, False)}
M_OFF = 99  # rows: off the GEMM's 32 / 64-row tiles and row_quant's 2 / 4-row blocks


def _bf16(x):
    return np.asarray(x, F32).astype(BF16).astype(F32)


# ---------------------------------------------------------------------------
# inputs: random rows with crafted ones in front
# ---------------------------------------------------------------------------


def _ties(k):
    """A bf16 row of width ``k`` whose amax gives sa with v / sa an exact .5
    for several v (even and odd halves: round-half-even decides them), and
    those v's quotients: (row, [(index, v / sa)])."""
    for amax in np.arange(96.0, 160.0, 0.5, dtype=F32):
        amax = _bf16(amax)
        sa = F32(np.maximum(amax, F32(1e-6)) * F32(1.0 / 127.0))
        found = []
        for half in np.arange(0.5, 120.0, 1.0, dtype=F32):
            v = _bf16(half * sa)
            if F32(v) / sa == half:
                found.append(v)
        evens = [v for v in found if int(F32(v) / sa) % 2 == 0]
        odds = [v for v in found if int(F32(v) / sa) % 2 == 1]
        if evens and odds:
            row = np.zeros(k, F32)
            row[0] = amax
            picks = (evens[:3] + odds[:3])[: k // 2 - 1]
            for i, v in enumerate(picks):
                row[2 + 2 * i] = v if i % 2 else -v
            return row, [(2 + 2 * i, F32(row[2 + 2 * i]) / sa) for i in range(len(picks))]
    raise AssertionError("no bf16 amax gives exact .5 ties")


def _operands(seed, m, k1, k2, n, res):
    """bf16 rows a (m, k1), a2 (m, k2) or None with crafted rows 0-4, JAX's
    int8 weight and per-channel scale (K, N), fp32 bias, bf16 residual."""
    rng = np.random.default_rng(seed)
    k = k1 + k2
    x = _bf16(rng.standard_normal((m, k)) * rng.uniform(0.05, 4.0, (m, 1)))
    x[0], ties = _ties(k)
    x[1] = 0.0  # all zero: amax clamps at 1e-6
    x[2] = 0.0
    x[2, k // 3] = -3.0  # one-hot
    if k2:  # ffn1: the row's amax in the message (row 3) or in x (row 4)
        x[3, k1 + 5] = 50.0
        x[4, 7] = -50.0
    q = jax_quant.quantize_weight(rng.standard_normal((k, n)) / np.sqrt(k))
    b = (rng.standard_normal(n) / 8).astype(F32)
    r = _bf16(rng.standard_normal((m, n))) if res else None
    return x[:, :k1], (x[:, k1:] if k2 else None), q["w_q"], q["scale"].reshape(-1), b, r, ties


def _t(x, dtype=torch.bfloat16):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


# ---------------------------------------------------------------------------
# the JAX q8 path (layer_stack.py:_aquant :339-346, _doti8 :348-355,
# _linear's q8 branch :368-372, the residual add :399), in jax.numpy
# ---------------------------------------------------------------------------


def _jax_aquant(v):
    vf = jnp.asarray(v, jnp.bfloat16).astype(jnp.float32)
    amax = jnp.max(jnp.abs(vf), axis=-1, keepdims=True)
    sa = jnp.maximum(amax, 1e-6) * (1.0 / 127.0)
    vq = jnp.clip(jnp.round(vf / sa), -127.0, 127.0).astype(jnp.int8)
    return vq, sa


def _jax_q8_linear(x, w_q, scale, b, res):
    vq, sa = _jax_aquant(x)
    acc = jax.lax.dot_general(vq, jnp.asarray(w_q), dimension_numbers=(((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * sa * jnp.asarray(scale)[None]
    y = y.astype(jnp.bfloat16) + jnp.asarray(b).astype(jnp.bfloat16)
    if res is not None:
        y = jnp.asarray(res, jnp.bfloat16) + y
    return np.asarray(y.astype(jnp.float32))


# ---------------------------------------------------------------------------
# row_quant_kernel in numpy: lanes, loads, the butterfly amax, packed stores
# ---------------------------------------------------------------------------


def row_quant_model(a, a2):
    """q (M, K) int8 and sa (M,) as row_quant_kernel computes and stores them:
    a row takes G = 16 lanes where K <= 256, else 32; lane l of a warp owns
    row (block * QUANT_WARPS + warp) * (32 / G) + l / G and the 16 values at
    16 (l % G); amax meets over the row's lanes by xor shuffles; q is packed
    four values a 32-bit word, low byte first, one 16-byte store a lane."""
    m, k1 = a.shape
    k = k1 + (0 if a2 is None else a2.shape[1])
    x = a if a2 is None else np.concatenate([a, a2], 1)
    g = 32 if k > 256 else 16
    rows = QUANT_WARPS * (32 // g)
    q = np.zeros((m, k), np.int8)
    sa = np.full(m, np.nan, F32)
    stores = np.zeros((m, k), int)
    lane = np.arange(32)
    for block in range(-(-m // rows)):
        for warp in range(QUANT_WARPS):
            c0 = 16 * (lane % g)
            row = (block * QUANT_WARPS + warp) * (32 // g) + lane // g
            cols = c0[:, None] + np.arange(16)[None]
            ok = (row[:, None] < m) & (cols < k)
            v = np.where(ok, x[np.minimum(row, m - 1)[:, None], np.minimum(cols, k - 1)], 0.0)
            amax = np.abs(v).max(1).astype(F32)
            o = g // 2
            while o:
                amax = np.maximum(amax, amax[lane ^ o])
                o //= 2
            s = (np.maximum(amax, F32(1e-6)) * F32(1.0 / 127.0)).astype(F32)
            qi = np.clip(np.rint(v.astype(F32) / s[:, None]), -127, 127).astype(np.int64)
            words = np.zeros((32, 4), np.uint32)
            for e in range(16):
                words[:, e // 4] |= ((qi[:, e] & 0xFF) << (8 * (e % 4))).astype(np.uint32)
            packed = words.astype("<u4").view(np.int8)  # (32, 16): the 16-byte store
            for ln in range(32):
                if row[ln] < m and c0[ln] < k:
                    q[row[ln], c0[ln]:c0[ln] + 16] = packed[ln]
                    stores[row[ln], c0[ln]:c0[ln] + 16] += 1
                    if c0[ln] == 0:
                        sa[row[ln]] = s[ln]
    assert (stores == 1).all()  # every element stored once
    return q, sa


# ---------------------------------------------------------------------------
# linear_s8_kernel in numpy: staging, ldmatrix, mma.sync m16n8k32, epilogue
# ---------------------------------------------------------------------------


def _ldsm_x4(smem, addr):
    """ldmatrix .x4 (b16): lanes 8j..8j+7 give the 16-byte rows of matrix j;
    lane l receives, of each matrix, the 4 bytes at row l / 4, bytes 4 (l %
    4)..+3. (4, 32, 4) int8. Rows must start on 16 B, and the eight rows of
    a matrix fall in eight different 16-byte bank groups."""
    assert (addr % 16 == 0).all()
    for j in range(4):
        assert len(set((addr[8 * j:8 * j + 8] // 16) % 8)) == 8, "bank conflict"
    lane = np.arange(32)
    out = np.empty((4, 32, 4), np.int8)
    for j in range(4):
        start = addr[8 * j + lane // 4] + 4 * (lane % 4)
        out[j] = smem[start[:, None] + np.arange(4)[None]]
    return out


def _mma_s8(a, b0, b1):
    """mma.sync m16n8k32 .s8.s8.s32 through the PTX fragment maps
    (csrc/mma.cuh:mma_s8): a (4, 32, 4): a0/a2 row g, a1/a3 row g + 8, k
    4 t4..4 t4 + 3 (a2/a3 + 16); b0, b1 (32, 4): k 4 t4.. (b1 + 16) of column
    g; returns d (32, 4): d0, d1 row g, columns 2 t4, 2 t4 + 1; d2, d3 row g + 8."""
    lane = np.arange(32)
    g, t4 = lane // 4, lane % 4
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    ks = 4 * t4[:, None] + np.arange(4)[None]
    A[g[:, None], ks] = a[0]
    A[g[:, None] + 8, ks] = a[1]
    A[g[:, None], ks + 16] = a[2]
    A[g[:, None] + 8, ks + 16] = a[3]
    B[ks, g[:, None]] = b0
    B[ks + 16, g[:, None]] = b1
    D = A @ B
    return np.stack([D[g, 2 * t4], D[g, 2 * t4 + 1], D[g + 8, 2 * t4], D[g + 8, 2 * t4 + 1]], 1)


def s8_gemm_model(q, sa, w_t, scale, bias, res, tiles, exit_reg=None, layer=0, rows_per_pair=1):
    """y (M, N) as linear_s8_kernel computes and stores it at a block of
    ``tiles`` = (along M, along N) 32 x 32 warp tiles: each block stages its
    W^T rows whole, then its A rows in S8_KC-byte groups, at pitch K32 + 16
    (zero past M and past K, unstaged bytes garbage); warp w of its S8_WARPS sums
    tile w % (WM WN) over the k32 steps s with s % WK == w / (WM WN), from
    ldmatrix fragments through mma.sync m16n8k32, and adds its sums into the
    block's int32 tile; the epilogue takes eight adjacent outputs a thread,
    rounds (float(acc) * sa) * scale to bf16, adds the bias rounded to bf16,
    then the residual. A retired pair's tile (exit <= layer) is the
    residual, or unwritten (NaN) without one."""
    m, k = q.shape
    n = w_t.shape[0]
    wm, wn = tiles
    wk = S8_WARPS // (wm * wn)
    tm, tn = 32 * wm, 32 * wn
    k32 = -(-k // 32) * 32
    p = k32 + 16
    y = np.full((m, n), np.nan, F32)
    stores = np.zeros((m, n), int)
    lane = np.arange(32)
    g, t4, mi, mr = lane // 4, lane % 4, lane // 8, lane % 8
    for by in range(-(-m // tm)):
        for bx in range(n // tn):
            m0, n0 = by * tm, bx * tn
            if exit_reg is not None and exit_reg[m0 // rows_per_pair] <= layer:
                if res is not None:
                    y[m0:m0 + tm, n0:n0 + tn] = res[m0:m0 + tm, n0:n0 + tn]
                    stores[m0:m0 + tm, n0:n0 + tn] += 1
                continue
            smem = np.full((tm + tn) * p, 77, np.int8)  # A rows, then W^T rows

            def copy(base, src, rows, valid, s0, s1):  # s8_copy of A or W^T rows
                for i in range(rows * (s1 - s0)):
                    r, s = i // (s1 - s0), s0 + i % (s1 - s0)
                    d = base + r * p + 16 * s
                    smem[d:d + 16] = (0 if r >= valid or 16 * s >= k
                                      else src[r, 16 * s:16 * s + 16])

            copy(tm * p, w_t[n0:n0 + tn], tn, tn, 0, k32 // 16)  # s8_stage_weights
            nc = -(-k32 // S8_KC)
            for c in range(nc):  # A's cp.async groups, after the prerequisite wait
                copy(0, q[m0:m0 + tm], tm, m - m0, c * (S8_KC // 16),
                     min(k32, (c + 1) * S8_KC) // 16)
            sums = np.zeros((tm, tn + 4), np.int64)
            steps = np.zeros((wm * wn, k32 // 32), int)
            for warp in range(S8_WARPS):
                kw, tile = warp // (wm * wn), warp % (wm * wn)
                at, bt = (tile // wn) * 32 * p, tm * p + (tile % wn) * 32 * p
                acc = np.zeros((2, 4, 32, 4), np.int64)
                for c in range(nc):
                    s0, send = c * (S8_KC // 32), min(k32, (c + 1) * S8_KC) // 32
                    for s in range(s0 + (kw - s0 % wk + wk) % wk, send, wk):
                        steps[tile, s] += 1
                        kb = 32 * s
                        af = [_ldsm_x4(smem, at + (mt * 16 + mr + (mi & 1) * 8) * p + kb
                                       + (mi >> 1) * 16) for mt in range(2)]
                        for npair in range(2):
                            r4 = _ldsm_x4(smem, bt + (npair * 16 + mr + (mi >> 1) * 8) * p + kb
                                          + (mi & 1) * 16)
                            for mt in range(2):
                                acc[mt, 2 * npair] += _mma_s8(af[mt], r4[0], r4[1])
                                acc[mt, 2 * npair + 1] += _mma_s8(af[mt], r4[2], r4[3])
                for mt in range(2):  # the warp's atomic adds into the sum tile
                    for nt in range(4):
                        for e in range(4):
                            rows = (tile // wn) * 32 + mt * 16 + g + 8 * (e // 2)
                            cols = (tile % wn) * 32 + nt * 8 + 2 * t4 + e % 2
                            np.add.at(sums, (rows, cols), acc[mt, nt, :, e])
            assert (steps == 1).all()  # each k32 step of each warp tile, once
            assert np.abs(sums).max() < 2 ** 24  # exact in fp32
            for i in range(tm * tn // 8):  # s8_epilogue: eight outputs a thread
                lm, ln = i // (tn // 8), i % (tn // 8) * 8
                gm, gn = m0 + lm, n0 + ln
                if gm >= m:
                    continue
                cols = np.arange(gn, gn + 8)
                v = (sums[lm, ln:ln + 8].astype(F32) * sa[gm]).astype(F32)
                v = _bf16((v * scale[cols]).astype(F32))
                v = _bf16(v + _bf16(bias[cols]))
                if res is not None:
                    v = _bf16(v + res[gm, cols])
                y[gm, cols] = v
                stores[gm, cols] += 1
    assert stores.max() <= 1  # no output stored twice
    return y


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(LIN_CASES))
def test_row_quant_model_is_plain_and_jax(case):
    """row_quant_kernel's lane layout and stores give q and sa exactly: the
    plain version's and JAX _aquant's, crafted rows included (the ties land
    on their even neighbours)."""
    k1, k2, n, res = LIN_CASES[case]
    a, a2, *_, ties = _operands(1, M_OFF, k1, k2, n, res)
    q, sa = row_quant_model(a, a2)
    pq, psa = layer_stack.row_quant_plain(_t(a), _t(a2))
    np.testing.assert_array_equal(q, pq.numpy())
    np.testing.assert_array_equal(sa, psa.numpy())
    jq, jsa = _jax_aquant(a if a2 is None else np.concatenate([a, a2], 1))
    np.testing.assert_array_equal(q, np.asarray(jq))
    np.testing.assert_array_equal(sa, np.asarray(jsa)[:, 0])
    for i, half in ties:  # round half to even
        assert abs(int(q[0, i])) == 2 * round(float(abs(half)) / 2) and abs(half) % 1 == 0.5
    assert (q[1] == 0).all() and sa[1] == F32(F32(1e-6) * F32(1.0 / 127.0))
    assert abs(int(q[2, (k1 + k2) // 3])) == 127 and np.count_nonzero(q[2]) == 1
    if k2:
        assert q[3, k1 + 5] == 127 and q[4, 7] == -127


@pytest.mark.parametrize("tiles", [(2, 2), (1, 2), (1, 1)], ids=["2x2", "1x2", "1x1"])
@pytest.mark.parametrize("case", list(LIN_CASES))
def test_s8_gemm_model_is_plain_and_jax(case, tiles):
    """linear_s8_kernel at each of s8_plan's blocks (8 warps splitting K 2,
    4 or 8 ways), on the K-major weight, row quantization as
    row_quant_kernel stores it: y exactly the plain version's and the JAX q8
    path's."""
    k1, k2, n, res = LIN_CASES[case]
    a, a2, w_q, scale, b, r, _ = _operands(2, M_OFF, k1, k2, n, res)
    q, sa = row_quant_model(a, a2)
    w_t = np.ascontiguousarray(w_q.T)
    y = s8_gemm_model(q, sa, w_t, scale, b, r, tiles)
    want = layer_stack.linear_plain(_t(a), _t(w_q, torch.int8), _t(b, torch.float32), _t(a2),
                                    _t(r), scale=_t(scale, torch.float32), w8a8=True)
    np.testing.assert_array_equal(y, want.float().numpy())
    x = a if a2 is None else np.concatenate([a, a2], 1)
    np.testing.assert_array_equal(y, _jax_q8_linear(x, w_q, scale, b, r))


def test_s8_gemm_model_at_k_off_the_k32_step():
    """K % 32 == 16 (48): the staged rows' last 16 bytes are zero-filled, and
    y is the plain version's exactly."""
    a, _, w_q, scale, b, r, _ = _operands(3, 70, 48, 0, 64, True)
    q, sa = row_quant_model(a, None)
    y = s8_gemm_model(q, sa, np.ascontiguousarray(w_q.T), scale, b, r, (2, 2))
    want = layer_stack.linear_plain(_t(a), _t(w_q, torch.int8), _t(b, torch.float32),
                                    residual=_t(r), scale=_t(scale, torch.float32), w8a8=True)
    np.testing.assert_array_equal(y, want.float().numpy())


@pytest.mark.parametrize("residual", [True, False], ids=["ffn2 +res", "no residual"])
def test_s8_gemm_model_liveness(residual):
    """Two pairs of 64 rows, pair 0 retired at this layer: with a residual
    its rows are the residual (as the plain version gives), without one they
    are left unwritten; pair 1 is the plain version's exactly."""
    k1, n = (512, 256) if residual else (256, 256)
    a, _, w_q, scale, b, r, _ = _operands(4, 128, k1, 0, n, residual)
    exit_reg = np.array([3.0, 9.0], F32)
    q, sa = row_quant_model(a, None)
    y = s8_gemm_model(q, sa, np.ascontiguousarray(w_q.T), scale, b, r, (2, 2), exit_reg, 3, 64)
    live = layer_stack.Live(torch.from_numpy(exit_reg), 3)
    want = layer_stack.linear_plain(_t(a.reshape(2, 64, k1)), _t(w_q, torch.int8),
                                    _t(b, torch.float32),
                                    residual=None if r is None else _t(r.reshape(2, 64, n)),
                                    live=live, scale=_t(scale, torch.float32),
                                    w8a8=True).float().numpy().reshape(128, n)
    np.testing.assert_array_equal(y[64:], want[64:])
    if residual:
        np.testing.assert_array_equal(y[:64], r[:64])
        np.testing.assert_array_equal(y[:64], want[:64])
    else:
        assert np.isnan(y[:64]).all()


def test_epilogue_order_is_witnessed():
    """The epilogue's order matters on these inputs: (float(acc) * (sa *
    scale)) rounded to bf16 differs from the reference's ((float(acc) * sa)
    * scale) in some outputs, so the exact comparisons above pin it."""
    k1, k2, n, _ = LIN_CASES["ffn1 cat"]
    a, a2, w_q, scale, b, _, _ = _operands(5, M_OFF, k1, k2, n, False)
    q, sa = row_quant_model(a, a2)
    acc = q.astype(np.int64) @ w_q.astype(np.int64)
    ref = _bf16((acc.astype(F32) * sa[:, None]).astype(F32) * scale[None])
    wrong = _bf16(acc.astype(F32) * (sa[:, None] * scale[None]).astype(F32))
    assert (ref != wrong).any()


def test_s8_plan_rules():
    """s8_plan: the first of 2 x 2, 1 x 2, 1 x 1 warp tiles (32 x 32 outputs
    each) that gives 128 blocks, the block's 8 warps splitting K 2, 4 or 8
    ways; a tile's rows divide 64 (a tile holds one pair's rows) and its
    columns divide N (N % 64 == 0); shared memory is the int32 sums at pitch
    bn + 4, the A and W^T rows at pitch K32 + 16, the bf16 residual tile and
    the tile's fp32 scale and bias, at most 93,696 bytes (K = 512), under
    one Hopper block's opt-in limit. At the main path's M =
    1024: 64 x 64 for qkv, ffn1, qk_v, 32 x 64 for out and ffn2, 128-192
    blocks. The mirror's constants are linear.cu's."""
    assert layer_stack._S8_MIN_BLOCKS == _cu_int("S8_MIN_BLOCKS")
    assert layer_stack._S8_MAX_K == _cu_int("S8_MAX_K")
    assert layer_stack._S8_WARPS == S8_WARPS
    table = re.search(r"void s8_plan\(.*?const int tiles\[3\]\[2\] = \{([^;]*)\};", LINEAR_CU,
                      re.DOTALL).group(1)
    assert tuple(tuple(map(int, t)) for t in re.findall(r"\{(\d+), (\d+)\}", table)) == \
        layer_stack._S8_TILES
    path = {768: (64, 64, 192, 2), 256: (32, 64, 128, 4), 512: (64, 64, 128, 2)}
    for n, (bm, bn, blocks, split) in path.items():
        plan = layer_stack.s8_plan(1024, n, 512)
        assert (plan.bm, plan.bn, plan.blocks, plan.k_split) == (bm, bn, blocks, split)
    for m in (1, 31, 99, 128, 512, 1000, 1024, 2048):
        for n in (64, 256, 512, 768):
            for k in (16, 48, 256, 512):
                plan = layer_stack.s8_plan(m, n, k)
                assert 64 % plan.bm == 0 and n % plan.bn == 0
                assert plan.blocks == -(-m // plan.bm) * (n // plan.bn)
                order = [(32 * wm, 32 * wn) for wm, wn in layer_stack._S8_TILES]
                earlier = order[:order.index((plan.bm, plan.bn))]
                assert all(-(-m // bm) * (n // bn) < 128 for bm, bn in earlier)
                assert plan.blocks >= 128 or (plan.bm, plan.bn) == order[-1]
                assert plan.k_split * plan.bm * plan.bn == S8_WARPS * 32 * 32
                assert plan.smem == (4 * plan.bm * (plan.bn + 4)
                                     + (plan.bm + plan.bn) * (-(-k // 32) * 32 + 16)
                                     + 2 * plan.bm * plan.bn + 8 * plan.bn)
                assert plan.smem <= 93_696 <= 232_448


def test_int8_tree_carries_the_k_major_weight():
    """params_from_numpy gives every int8 linear of the layer stack a
    contiguous K-major copy w_t = w_q^T (L, N, K), the s8 GEMM's operand;
    w_q stays (L, K, N) and the JAX tree's values. 1,245,184 bytes a layer
    at E = 256."""
    tree = jax_quant.quantize_lightglue(jax_weights.init_lightglue(0, JLGC(n_layers=2)))
    params = weights.params_from_numpy(tree)
    total = 0
    for block in params["layers"].values():
        for name, node in block.items():
            if not isinstance(node, dict):
                continue
            assert "w_t" in node and node["w_t"].is_contiguous(), name
            assert node["w_t"].dtype == torch.int8
            torch.testing.assert_close(node["w_t"], node["w_q"].transpose(-1, -2), rtol=0, atol=0)
            total += node["w_t"][0].numel()
    assert total == 1_245_184
    assert quant.is_quantized(params["layers"]["self_attn"]["qkv"])
