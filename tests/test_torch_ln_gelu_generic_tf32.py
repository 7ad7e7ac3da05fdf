"""The redesigned csrc/ln_gelu.cu and csrc/conv3x3.cu's generic fp32 conv on
the CPU: ``ln_gelu``'s plain version against the JAX stack's ``_ffn``
LayerNorm + GELU in its three operand modes, with rows where the contract's
statistics (var = E[x^2] - mean^2 in fp32) and Welford's differ; the
kernel's lane -> column map; the generic 3xTF32 conv's launch plan, and one
of its tiles computed through the mma.sync fragment maps as the kernel
addresses them, against JAX ``conv3x3``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.kernels import conv as jax_conv
from lightglue_tpu.kernels.layer_stack import _gelu_exact
from lightglue_tpu_torch.kernels import _build, conv, layer_stack
from tf32_emulation import mma_tf32_maps, split_rz

BF16, F32 = torch.bfloat16, torch.float32
SMS = 132  # an H100's SMs
SM_SMEM = 228 * 1024  # shared memory of an SM; each block also holds 1 KB
# ln_gelu's operand modes: rows, gamma and beta (INT8: bf16 rows, fp32 LayerNorm)
LN_MODES = {"fp32": (F32, F32), "bf16": (BF16, BF16), "int8": (BF16, F32)}
# width -> ones a crafted row holds (8 + m / 16, m one there, 0 elsewhere):
# every sum of x and x^2 exact in fp32 at 512 and 256 (the mean's square
# rounded), so the contract's var and Welford's differ by its rounding
LN_CRAFTED = {512: 16, 256: 8, 200: 7}


def _jax_ffn_ln_gelu(h, g, b, dt):
    """JAX ``_ffn``'s LayerNorm + GELU (lightglue_tpu/kernels/layer_stack.py
    :386-398) in jnp: fp32 statistics, var = E[x^2] - mean^2, eps 1e-5, the
    erf GELU, one cast to the row type."""
    hf = jnp.asarray(h).astype(jnp.float32)
    mean = jnp.mean(hf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(hf), axis=-1, keepdims=True) - jnp.square(mean)
    normed = (hf - mean) * jax.lax.rsqrt(var + 1e-5)
    normed = normed * jnp.asarray(g).astype(jnp.float32) + jnp.asarray(b).astype(jnp.float32)
    return np.asarray(_gelu_exact(normed).astype(dt), np.float32)


def _ln_rows(c, seed):
    """Eight N(0.5, 2) rows and eight crafted rows of width c, fp32."""
    rng = np.random.default_rng(seed)
    m = np.zeros((8, c), np.float32)
    for r in range(8):
        m[r, rng.permutation(c)[:LN_CRAFTED[c]]] = 1
    normal = rng.normal(0.5, 2.0, (8, c)).astype(np.float32)
    return np.concatenate([normal, 8 + m / 16]).astype(np.float32)


@pytest.mark.parametrize("mode", list(LN_MODES))
@pytest.mark.parametrize("c", list(LN_CRAFTED))
def test_ln_gelu_plain_matches_jax_ffn(c, mode):
    """``ln_gelu_plain`` (what the kernel is held to on the card) against
    JAX ``_ffn``'s formula at the stack's width, 256 and a ragged 200, in
    each mode: within 2e-6 in fp32 (JAX's erf is a polynomial good to
    1.5e-7), within one bf16 step otherwise. On the crafted rows (mean 8,
    spread 1/64) Welford's statistics (F.layer_norm in float64) miss the
    formula by over 1e-2 in fp32: these rows pin the statistics contract."""
    dt, gt = LN_MODES[mode]
    rng = np.random.default_rng(c)
    rows = _ln_rows(c, c)
    g = (1 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    b = (0.3 * rng.standard_normal(c)).astype(np.float32)
    h, gq, bq = (torch.from_numpy(a) for a in (rows, g, b))
    h, gq, bq = h.to(dt), gq.to(gt), bq.to(gt)
    got = layer_stack.ln_gelu_plain(h, gq, bq).float().numpy()
    jdt = jnp.float32 if dt == F32 else jnp.bfloat16
    want = _jax_ffn_ln_gelu(h.float().numpy().astype(jdt), gq.float().numpy().astype(
        jnp.float32 if gt == F32 else jnp.bfloat16), bq.float().numpy().astype(
        jnp.float32 if gt == F32 else jnp.bfloat16), jdt)
    if dt == F32:
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
        welford = torch.nn.functional.gelu(torch.nn.functional.layer_norm(
            h.double(), (c,), gq.double(), bq.double())).numpy()
        assert np.abs(welford[8:] - want[8:]).max() > 1e-2
        assert np.abs(welford[:8] - want[:8]).max() < 1e-4  # the normal rows: no cancellation
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=2 ** -7)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32 rows", "bf16 rows"])
@pytest.mark.parametrize("c", [512, 256, 200, 100])
def test_ln_gelu_lane_map_covers_each_column_once(c, dtype):
    """csrc/ln_gelu.cu's map as ``ln_gelu_plan`` mirrors it: lane l of a
    row takes 16-byte vectors l, l + lanes, ..., each of ``columns``
    columns, those below C (a width that is not a multiple of the vector is
    read on the same map element by element: the tail). Every column of
    the row is taken exactly once, each vector whole or not at all where C
    is a multiple of it, and a warp's j-th vector load of a row is one run
    of 16 * lanes contiguous bytes."""
    plan = layer_stack.ln_gelu_plan(dtype)
    assert plan.row_lanes * plan.vectors * plan.columns == layer_stack.LN_MAX_C
    assert plan.columns * torch.empty((), dtype=dtype).element_size() == 16
    assert 32 % plan.row_lanes == 0 and plan.threads % 32 == 0
    seen = np.zeros(c, np.int32)
    for lane in range(plan.row_lanes):
        for j in range(plan.vectors):
            cols = [(lane + plan.row_lanes * j) * plan.columns + e for e in range(plan.columns)]
            taken = [col for col in cols if col < c]
            if c % plan.columns == 0:
                assert len(taken) in (0, plan.columns)
            for col in taken:
                seen[col] += 1
    assert (seen == 1).all()
    for j in range(plan.vectors):
        starts = sorted((lane + plan.row_lanes * j) * 16 for lane in range(plan.row_lanes))
        assert starts == list(range(starts[0], starts[0] + 16 * plan.row_lanes, 16))


# (B, H, W, C_out) -> blocks of the generic fp32 conv's 12 x 16 x 64 tiles:
# SuperPoint's C >= 128 layers at 2x480x640 and chip_smoke.py's two edge
# shapes
FP32_PLANS = {
    "conv3a/conv3b 120x160 -> 128": ((2, 120, 160, 128), 400),
    "convDa/convDb 60x80 -> 256": ((2, 60, 80, 256), 200),
    "edge 60x80 -> 40": ((2, 60, 80, 40), 50),
    "edge 360x488 -> 128": ((2, 360, 488, 128), 3720),
}


@pytest.mark.parametrize("shape", list(FP32_PLANS))
def test_conv_plan_fp32_fits(shape):
    """``conv_plan`` with fp32 operands (csrc/conv3x3.cu:TF32_ROWS and
    TF32_GENERIC_SMEM): 12-row tiles of six warps; two raw ring stages of
    the haloed 14 x 18 tile's 8 channels (12-float pitch) and their taps'
    weights for 64 channels, and one buffer of split (hi, lo) weights at a
    68-pair pitch. Two blocks fit an SM, and SuperPoint's four shapes give
    every SM a block: 200 blocks at convDa and convDb, where 16-row tiles
    would give 160, a second block on only 28 SMs."""
    (b, h, w, cout), blocks = FP32_PLANS[shape]
    plan = conv.conv_plan(b, h, w, cout, F32)
    assert (plan.rows, plan.threads, plan.blocks) == (12, 192, blocks)
    assert plan.blocks == b * -(-h // 12) * -(-w // 16) * -(-cout // 64)
    assert plan.smem == 4 * 2 * (14 * 18 * 12 + 9 * 8 * 64) + 8 * 9 * 8 * 68 == 100_224
    assert plan.smem <= _build.MAX_DYNAMIC_SMEM and 2 * (plan.smem + 1024) <= SM_SMEM
    assert plan.blocks >= SMS or shape.startswith("edge")


# the generic 3xTF32 kernel's pitches: a chunk's input pixel (floats), the
# split weights' row ((hi, lo) pairs), the haloed tile's width
XPA, XPN, HW = 12, 68, 18


def _generic_tile(x, w, rows, y0, split):
    """One block of conv3x3_tf32x3_generic_kernel (output rows y0.. of
    ``rows`` x 16 pixels x 64 channels, image 0) computed as its warps do:
    K in chunks of 8 input channels, the chunk's raw haloed tile at pitch
    XPA (zeros outside the image), its weights zero past C_out and split
    into (hi, lo) pairs at pitch XPN, each A register read at the kernel's
    address and split as it loads, each product placed where the PTX layout
    puts it and each sum stored where the epilogue stores it. ``split``
    (hi, lo) of a float32 array; products summed in float64 as lo-hi,
    hi-lo, hi-hi (``three``) or hi-hi alone (``one``)."""
    _, h, wd, cin = x.shape
    cout = w.shape[-1]
    amap, bmap, cmap = mma_tf32_maps()
    xp = np.zeros((h + 2, wd + 2, cin), np.float32)
    xp[1:-1, 1:-1] = x[0]
    three = np.zeros((rows, 16, 64))
    one = np.zeros((rows, 16, 64))
    for c0 in range(0, cin, 8):
        xs = np.zeros((rows + 2) * HW * XPA, np.float32)
        for p in range((rows + 2) * HW):
            gy, gx = y0 + p // HW, p % HW  # padded coordinates: image row gy - 1
            if gy < h + 2 and gx < wd + 2:
                xs[p * XPA:p * XPA + 8] = xp[gy, gx, c0:c0 + 8]
        wr = np.zeros((9 * 8, 64), np.float32)
        for tap in range(9):
            wr[tap * 8:tap * 8 + 8, :cout] = w[tap // 3, tap % 3, c0:c0 + 8]
        hi, lo = (t.numpy().astype(np.float64) for t in split(torch.from_numpy(wr)))
        ws = np.zeros((9 * 8 * XPN, 2))
        for r in range(9 * 8):
            ws[r * XPN:r * XPN + 64] = np.stack([hi[r], lo[r]], -1)
        xh, xl = (t.numpy().astype(np.float64) for t in split(torch.from_numpy(xs)))
        for warp in range(rows // 2):
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                for m in range(2):
                    a = np.zeros((16, 8, 2))
                    for (lane, i), (row, col) in amap.items():
                        g, t4 = divmod(lane, 4)
                        px = ((2 * warp + m + dy) * HW + dx + g) * XPA + t4
                        off = (0, 8 * XPA, 4, 8 * XPA + 4)[i]
                        a[row, col] = (xh[px + off], xl[px + off])
                    for n in range(8):
                        bm = np.zeros((8, 8, 2))
                        for (lane, i), (k, col) in bmap.items():
                            g, t4 = divmod(lane, 4)
                            bm[k, col] = ws[(tap * 8 + t4) * XPN + g + n * 8 + (0, 4 * XPN)[i]]
                        d1 = a[..., 0] @ bm[..., 0]
                        d3 = a[..., 1] @ bm[..., 0] + a[..., 0] @ bm[..., 1] + d1
                        for (lane, r), (row, col) in cmap.items():
                            g, t4 = divmod(lane, 4)
                            at = (2 * warp + m, g + 8 * (r // 2), n * 8 + 2 * t4 + r % 2)
                            three[at] += d3[row, col]
                            one[at] += d1[row, col]
    return three, one


def test_generic_tf32_kernel_tile_by_fragments_matches_jax():
    """A 12 x 16 image (SAME padding on every side) of the generic fp32
    conv's 24 -> 40 edge case, no ReLU, as one block of the kernel (its 12
    x 16 tile) computes it through the fragment maps: three K chunks
    (C_in = 24), one 64-channel tile of which 24 columns are zero weights
    and never stored (C_out = 40), every operand split by truncation
    (mma.cuh:split_tf32_rz). Plus the fp32 bias, it agrees with JAX
    ``conv3x3`` (fp32, relu=False) within 1e-5, while one TF32 product per
    step (hi * hi alone) misses it by more than 2e-4."""
    rows = conv.conv_plan(2, 60, 80, 40, F32).rows
    rng = np.random.default_rng(41)
    bound = 1 / np.sqrt(9 * 24)
    x = rng.uniform(0, 1, (1, rows, 16, 24)).astype(np.float32)
    w = rng.uniform(-bound, bound, (3, 3, 24, 40)).astype(np.float32)
    b = rng.uniform(-bound, bound, 40).astype(np.float32)
    three, one = _generic_tile(x, w, rows, 0, split_rz)
    want = np.asarray(jax_conv.conv3x3(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                       relu=False), np.float32)[0]
    assert not three[..., 40:].any()  # the dead columns: never stored
    err3 = np.abs(three[..., :40] + b - want).max()
    err1 = np.abs(one[..., :40] + b - want).max()
    assert err3 < 1e-5
    assert err1 > 2e-4

