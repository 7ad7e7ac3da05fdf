"""The generic bf16 conv and the bf16 chain of csrc/conv3x3.cu and
csrc/conv_chain.cu on the CPU: the generic conv's launch plan at the shapes
chip_smoke.py gives it, the premises of chip_smoke.py's rounding witnesses
for both kernels, and the plain versions against JAX at the edge shapes
(tests/test_torch_conv.py covers the others); the fp32 convs' 3xTF32
design: the premise against JAX with the one-TF32 wrong design, the
mma.sync m16n8k8 tf32 fragment maps as the generic fp32 conv addresses them;
and the model's fp32 conv on wgmma: its input tile's bank spread, its launch
plan, and one tile computed through its register-A fragments and K-major
weight planes."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.kernels import conv as jax_conv
from lightglue_tpu.kernels import conv_chain as jax_chain
from lightglue_tpu_torch.kernels import _build, conv, conv_chain
from tf32_emulation import a_fragment_matrix, acc_at, b_operand, mma_tf32_maps, split_rz, tf32

ROOT = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16
SMS = 132  # an H100's SMs


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _share(a, b):
    """The share of elements in which two bf16 outputs differ."""
    assert a.shape == b.shape and a.dtype == b.dtype == BF16
    return float((a != b).float().mean())


def _mean_diff(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
    return float((a - b).abs().mean())


# (B, H, W, C_out) -> (rows, blocks): chip_smoke.py's generic shapes
# (SuperPoint's C >= 128 layers at 2x480x640 and the edge shapes) and maps
# whose grid needs the smaller tiles
CONV_PLANS = {
    "conv3a/conv3b 120x160 -> 128": ((2, 120, 160, 128), (16, 320)),
    "convDa/convDb 60x80 -> 256": ((2, 60, 80, 256), (8, 320)),
    "edge 60x80 -> 40": ((2, 60, 80, 40), (4, 150)),
    "edge 360x488 -> 128": ((2, 360, 488, 128), (16, 2852)),
    "240x320 -> 64 (fp32-out conv2a)": ((2, 240, 320, 64), (16, 600)),
    "one image 60x80 -> 256": ((1, 60, 80, 256), (4, 300)),
    "one image 60x80 -> 64": ((1, 60, 80, 64), (4, 75)),
    "30x40 -> 512": ((1, 30, 40, 512), (4, 192)),
}


@pytest.mark.parametrize("shape", list(CONV_PLANS))
def test_conv_plan_fits(shape):
    (b, h, w, cout), (rows, blocks) = CONV_PLANS[shape]
    plan = conv.conv_plan(b, h, w, cout)
    assert (plan.rows, plan.blocks) == (rows, blocks)
    assert plan.blocks == b * -(-h // rows) * -(-w // 16) * -(-cout // 64)
    assert plan.threads == rows // 2 * 32  # a warp per 2 rows x 64 channels
    # a ring stage: the haloed tile's 16 channels at a 24-element pitch and
    # their nine taps' weights at 72, two stages, bf16
    assert plan.smem == 2 * 2 * ((rows + 2) * 18 * 24 + 9 * 16 * 72)
    assert 2 * plan.smem <= _build.MAX_DYNAMIC_SMEM  # two blocks share an SM
    # two blocks an SM, or the smallest tile where even that cannot fill the card
    assert plan.blocks >= 2 * SMS or rows == 4
    # the largest tile that does: the next larger one would not
    if rows < 16:
        assert b * -(-h // (2 * rows)) * -(-w // 16) * -(-cout // 64) < 2 * SMS


def _conv_inputs(seed, b, h, w, cin, cout):
    """chip_smoke.py's value ranges: inputs in [0, 1), the port's init scale."""
    rng = np.random.default_rng(seed)
    bound = 1 / np.sqrt(9 * cin)
    x = torch.from_numpy(rng.uniform(0, 1, (b, h, w, cin)).astype(np.float32)).to(BF16)
    wt = torch.from_numpy(rng.uniform(-bound, bound, (3, 3, cin, cout)).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-bound, bound, cout).astype(np.float32))
    return x, wt.to(BF16), bias


# label: (H, W, C_in, C_out, pool, relu, out dtype)
GENERIC_WITNESS = {
    "24->40 no ReLU": (16, 32, 24, 40, False, False, BF16),
    "128->128 + pool": (16, 32, 128, 128, True, True, BF16),
    "64->128, fp32 out": (16, 32, 64, 128, False, True, torch.float32),
}


@pytest.mark.parametrize("case", list(GENERIC_WITNESS))
def test_generic_conv_rounding_witness_premise(case):
    """The premise of the generic conv's witness in chip_smoke.py: the plain
    version differs from the same conv with its nine taps summed in reverse
    order in under 0.2 % of elements, and from each of
    ``conv_wrong_designs`` ((a) acc rounded through bf16 before the bias, (b)
    after every tap) in over 10 %. Into fp32 the witness counts by mean
    magnitude: there the reordered sum's mean difference is under a
    hundredth of each wrong design's. bf16 operands, batch 1."""
    h, w, cin, cout, pool, relu, out = GENERIC_WITNESS[case]
    x, wt, b = _conv_inputs(13, 1, h, w, cin, cout)
    want = conv.conv3x3_plain(x, wt, b, pool, relu=relu, out_dtype=out)
    cs = _chip_smoke()
    reordered = cs.conv_epilogue(cs.conv_taps(x, wt, taps=range(8, -1, -1)), b, pool, relu, out)
    wrong = cs.conv_wrong_designs(x, wt, b, pool, relu, out)
    assert len(wrong) == 2
    if out == BF16:
        assert _share(reordered, want) < 0.002
        for name, alt in wrong.items():
            assert _share(alt, want) > 0.10, name
    else:
        for name, alt in wrong.items():
            assert _mean_diff(reordered, want) < _mean_diff(alt, want) / 100, name


def _chain_witness_inputs(seed, b=1, h=16, w=32):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 1, (b, h, w, 64)).astype(np.float32)).to(BF16)
    wa, wb = (torch.from_numpy(rng.uniform(-1 / 24, 1 / 24, (3, 3, 64, 64)).astype(np.float32))
              .to(BF16) for _ in range(2))
    ba, bb = (torch.from_numpy(rng.uniform(-1 / 24, 1 / 24, 64).astype(np.float32))
              for _ in range(2))
    return x, wa, ba, wb, bb


@pytest.mark.parametrize("out", [BF16, torch.float32], ids=["bf16 out", "fp32 out"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no relu"])
def test_chain_rounding_witness_premise(relu, out):
    """The premise of the chain's witness in chip_smoke.py: the plain
    version differs from the same chain with both convs' taps summed in
    reverse order in under 0.5 % of elements (0.03-0.25 % over three seeds:
    a flipped bf16 rounding of one conv2a value reaches the 9 x 64 conv2b
    sums that read it), and from each of ``chain_wrong_designs`` ((a)
    conv2a's output kept in fp32, (b) conv2b's acc rounded through bf16
    before the bias) in over 10 %; into fp32, by mean magnitude, the
    reordered chain's difference is under a tenth of each wrong design's.
    bf16 operands, 1x32x48x64."""
    x, wa, ba, wb, bb = _chain_witness_inputs(17, 1, 32, 48)
    want = conv_chain.conv2_chain_plain(x, wa, ba, wb, bb, relu=relu, out_dtype=out)
    cs = _chip_smoke()
    back = range(8, -1, -1)
    mid = torch.relu(cs.conv_taps(x, wa, taps=back) + ba).to(BF16)
    reordered = cs.conv_epilogue(cs.conv_taps(mid, wb, taps=back), bb, True, relu, out)
    wrong = cs.chain_wrong_designs(x, wa, ba, wb, bb, relu, out)
    assert len(wrong) == 2
    if out == BF16:
        assert _share(reordered, want) < 0.005
        for name, alt in wrong.items():
            assert alt.shape == want.shape
            assert _share(alt, want) > 0.10, name
    else:
        for name, alt in wrong.items():
            assert _mean_diff(reordered, want) < _mean_diff(alt, want) / 10, name


DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
OTHER = {"fp32": "bf16", "bf16": "fp32"}
# label: (B, H, W, C_in, C_out, pool, relu): chip_smoke.py's edge shapes,
# the 488-wide one at 8 rows
GENERIC_EDGES = {
    "24->40 no ReLU": (2, 12, 40, 24, 40, False, False),
    "488 wide + pool": (1, 8, 488, 64, 128, True, True),
}


@pytest.mark.parametrize("other", [False, True], ids=["same out", "other out"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("edge", list(GENERIC_EDGES))
def test_generic_conv_edges_match_jax(edge, dtype, other):
    b, h, w, cin, cout, pool, relu = GENERIC_EDGES[edge]
    out = OTHER[dtype] if other else dtype
    rng = np.random.default_rng(21)
    x = rng.standard_normal((b, h, w, cin), dtype=np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    want = jax_conv.conv3x3(jnp.asarray(x, jdt), jnp.asarray(wt, jdt), jnp.asarray(bias),
                            relu=relu, pool=pool, out_dtype=DTYPES[out][0])
    got = conv.conv3x3(torch.from_numpy(x).to(tdt), torch.from_numpy(wt).to(tdt),
                       torch.from_numpy(bias), pool, relu=relu, out_dtype=DTYPES[out][1])
    assert got.dtype == DTYPES[out][1] and got.shape == want.shape
    # fp32: two frameworks' fp32 sums; bf16: one rounding of the output
    tol = (dict(atol=2e-2, rtol=2e-2) if "bf16" in (dtype, out)
           else dict(atol=1e-5, rtol=1e-5))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no relu"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_conv2_chain_edge_matches_jax(dtype, relu):
    """A map that is no multiple of the kernel's 16x16 tile (12x44, 22 x 2.75
    tiles), as the 360x488 edge's 180x244 conv2 is not."""
    rng = np.random.default_rng(23)
    x = rng.standard_normal((2, 12, 44, 64)).astype(np.float32)
    wa, wb = ((rng.standard_normal((3, 3, 64, 64)) * 0.1).astype(np.float32) for _ in range(2))
    ba, bb = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    jdt, tdt = DTYPES[dtype]
    want = jax_chain.conv2_chain(jnp.asarray(x, jdt), jnp.asarray(wa, jdt), jnp.asarray(ba),
                                 jnp.asarray(wb, jdt), jnp.asarray(bb), relu=relu)
    got = conv_chain.conv2_chain(*(torch.from_numpy(t).to(tdt) for t in (x, wa)),
                                 torch.from_numpy(ba), torch.from_numpy(wb).to(tdt),
                                 torch.from_numpy(bb), relu=relu)
    assert got.dtype == tdt and got.shape == (2, 6, 22, 64)
    # as tests/test_torch_conv.py:test_conv2_chain_matches_jax: a flipped
    # rounding of the bf16 intermediate moves an output by a few hundredths
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "fp32" else dict(atol=5e-2, rtol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _conv_sum(x, w):
    """The fp32 sum of a SAME 3x3 conv, NHWC x HWIO, no bias."""
    return torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                                      padding=1).permute(0, 2, 3, 1)


def test_tf32_rounding_emulation():
    """The emulated cvt.rna: ties away from zero, a carry into the exponent,
    10 mantissa bits kept, signs kept."""
    one = 1.0 + 2.0 ** -10
    cases = {1.0 + 2.0 ** -11: one, -(1.0 + 2.0 ** -11): -one,  # a tie, away from zero
             1.0 + 2.0 ** -11 - 2.0 ** -23: 1.0,  # below the tie
             2.0 - 2.0 ** -23: 2.0, one: one, 0.0: 0.0}  # a carry; exact values stay
    x = torch.tensor(list(cases), dtype=torch.float32)
    assert tf32(x).tolist() == list(cases.values())
    r = tf32(torch.randn(1000, generator=torch.Generator().manual_seed(0)))
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()


# conv2a (64 -> 64) and conv1b+pool at 16x32, SuperPoint-scale values:
# inputs in [0, 1), weights and bias in +-1/24 (chip_smoke.py's)
TF32_CASES = {"conv2a": False, "conv1b+pool": True}


@pytest.mark.parametrize("case", list(TF32_CASES))
def test_3xtf32_conv_premise(case):
    """The premise of csrc/conv3x3.cu's fp32 model conv: each operand split
    into hi = tf32(x) and lo = tf32(x - hi), hi*lo + lo*hi + hi*hi summed in
    fp32 (lo*lo dropped) agrees with JAX's fp32 conv3x3_paired within 1e-5,
    while one TF32 product (hi*hi alone) misses the port's fp32 gate of 1e-4
    (its max error here is 2.4-4.0e-4, mean ~5e-5): the wrong design of
    chip_smoke.py's tf32_witness, which holds the kernel's mean error
    against a float64 conv to under a quarter of that one's."""
    pool = TF32_CASES[case]
    rng = np.random.default_rng(31)
    x = rng.uniform(0, 1, (1, 16, 32, 64)).astype(np.float32)
    w = rng.uniform(-1 / 24, 1 / 24, (3, 3, 64, 64)).astype(np.float32)
    b = rng.uniform(-1 / 24, 1 / 24, 64).astype(np.float32)
    if pool:
        want = jax_conv.conv3x3_paired(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), pool=True,
                                       offset=True)
    else:
        want = jax_conv.conv3x3_paired(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                       offset=True, out_paired=True).reshape(1, 16, 32, 64)
    want = np.asarray(want, np.float32)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    xh, wh = tf32(xt), tf32(wt)
    xl, wl = tf32(xt - xh), tf32(wt - wh)

    def epilogue(acc):
        out = torch.relu(acc + bt)
        if pool:
            out = torch.nn.functional.max_pool2d(out.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        return out.numpy()

    three = epilogue(_conv_sum(xh, wl) + _conv_sum(xl, wh) + _conv_sum(xh, wh))
    one = epilogue(_conv_sum(xh, wh))
    err3, err1 = np.abs(three - want).max(), np.abs(one - want).max()
    assert err3 < 1e-5
    assert 2e-4 < err1 < 1e-3 and err3 < err1 / 50


# csrc/conv3x3.cu's generic 3xTF32 kernel: a chunk's input tile pitch (floats a
# pixel), the split weights' pitch ((hi, lo) pairs a row), the haloed side
XPA, XPN, XH = 12, 68, 18


def _kernel_maps():
    """The same fragments as the kernel addresses them: A register i at
    px[{0, 8 XPA, 4, 8 XPA + 4}[i]] past px = tile + (pixel g) XPA + t4, so
    (pixel, channel) = (g + off // XPA, t4 + off % XPA); B register i at
    wk[{0, 4 XPN}[i]] past wk = split + (k t4) XPN + column g; acc[.][n][2 i
    + j] stored at pixel g + 8 i, channel n 8 + 2 t4 + j."""
    a, b, c = {}, {}, {}
    for lane in range(32):
        g, t4 = divmod(lane, 4)
        for i, off in enumerate((0, 8 * XPA, 4, 8 * XPA + 4)):
            a[lane, i] = (g + off // XPA, t4 + off % XPA)
        for i, off in enumerate((0, 4 * XPN)):
            b[lane, i] = (t4 + off // XPN, g + off % XPN)
        for i in range(2):
            for j in range(2):
                c[lane, 2 * i + j] = (g + 8 * i, 2 * t4 + j)
    return a, b, c


def test_tf32_fragment_maps_cover_each_element_once():
    """The kernel's A, B and C fragment addressing is the PTX layout, and
    each covers its 16 x 8, 8 x 8 and 16 x 8 matrix exactly once; the A
    loads of a warp fall in 32 different banks (pitch 12 floats) and the B
    loads of each half-warp in 16 different bank pairs (pitch 68 pairs)."""
    ptx, kernel = mma_tf32_maps(), _kernel_maps()
    assert ptx == kernel
    for frag, (rows, cols) in zip(ptx, ((16, 8), (8, 8), (16, 8))):
        seen = np.zeros((rows, cols), np.int32)
        for r, col in frag.values():
            seen[r, col] += 1
        assert (seen == 1).all()
    a_words = [g * XPA + t4 for g in range(8) for t4 in range(4)]  # register 0, one warp
    assert len({w % 32 for w in a_words}) == 32
    for half in (range(16), range(16, 32)):
        pairs = [(lane % 4) * XPN + lane // 4 for lane in half]  # B register 0
        assert len({p % 16 for p in pairs}) == 16


# csrc/conv3x3.cu's model fp32 conv on wgmma (conv3x3_tf32_wgmma_kernel): the
# haloed tile's side, a chunk's input channels
WH, WK = 18, 8


def _conv_px(p, ch):
    """conv3x3.cu:conv_px, a chunk's input tile: pixel p's channel ch at
    float p * 8 + ((ch / 4) ^ (p / 4 % 2)) * 4 + ch % 4."""
    return p * WK + ((ch // 4) ^ ((p >> 2) & 1)) * 4 + ch % 4


def _weight_planes(wc):
    """The kernel's split of a chunk's weights wc [tap][8][64] into its hi
    and lo planes: item (tap, 4-channel group kg, co) writes the 16 B unit
    2 (tap % 4) + kg of row co of half tap / 4, at unit ^ co % 8 (128 B
    swizzle); three [64][32] halves each, flat."""
    hi, lo = np.zeros(3 * 64 * 32, np.float32), np.zeros(3 * 64 * 32, np.float32)
    h, l = (t.numpy() for t in split_rz(torch.from_numpy(np.ascontiguousarray(wc))))
    for tap in range(9):
        for kg in range(2):
            unit = 2 * (tap % 4) + kg
            for co in range(64):
                at = tap // 4 * 64 * 32 + co * 32 + (unit ^ (co % 8)) * 4
                hi[at:at + 4] = h[tap, 4 * kg:4 * kg + 4, co]
                lo[at:at + 4] = l[tap, 4 * kg:4 * kg + 4, co]
    return hi, lo


def test_conv_px_spreads_an_a_column_over_the_banks():
    """The input tile's unit swap puts the 32 loads of a warp's A register
    (pixels g of any 8 consecutive ones, channels t4, or t4 + 4) in 32
    different banks, at any tap offset; each pixel's 8 channels stay its own
    32 bytes."""
    for p0 in range(WH * WH - 8):
        for off in (0, 4):
            words = [_conv_px(p0 + g, t4 + off) for g in range(8) for t4 in range(4)]
            assert len({w % 32 for w in words}) == 32
    for p in range(WH * WH):
        assert sorted(_conv_px(p, ch) for ch in range(8)) == list(range(8 * p, 8 * p + 8))


def test_tf32_kernel_tile_by_fragments_matches_conv():
    """One 16 x 16 output tile computed as conv3x3_tf32_wgmma_kernel's two
    warpgroups do: K in chunks of 8 input channels; each tap's register-A
    fragments read from the chunk's haloed tile (conv_px) at the tap's
    offset, warp w's 16 rows the pixels of tile rows 2 w and 2 w + 1 (its
    two m64 products) and split by truncation as they load; B the chunk's
    K-major hi and lo weight planes read through the tap's descriptor
    (hopper.cuh:desc_step_f32, 64 rows); per tap A_hi.B_lo + A_lo.B_hi +
    A_hi.B_hi, each operand read truncated; each accumulator element put
    where the epilogue stores it. It agrees with the conv of that tile (no
    bias, before the epilogue) within 1e-5."""
    rng = np.random.default_rng(37)
    x = rng.uniform(0, 1, (1, 16, 16, 64)).astype(np.float32)
    w = rng.uniform(-1 / 24, 1 / 24, (3, 3, 64, 64)).astype(np.float32)
    xp = np.pad(x[0], ((1, 1), (1, 1), (0, 0)))  # the haloed tile, zeros outside
    # the epilogue stores accumulator element e of lane (g, t4) of warp w at
    # pixel g + 8 (e / 2 % 2), channel 8 (e / 4) + 2 t4 + e % 2: row 16 w +
    # pixel of the m64 product, as wgmma lays the accumulator out
    for w4 in range(4):
        for lane in range(32):
            g, t4 = divmod(lane, 4)
            for e in range(32):
                assert acc_at(w4, lane, e) == (16 * w4 + g + 8 * (e // 2 % 2),
                                               8 * (e // 4) + 2 * t4 + e % 2)

    def a_index(tap, wg, m):  # register A of warpgroup wg's product m at the tap
        dy, dx = divmod(tap, 3)

        def at(w4, lane, i):
            g, t4 = divmod(lane, 4)
            p = (2 * (4 * wg + w4) + m + dy) * WH + dx + g + 8 * (i % 2)
            return _conv_px(p, t4 + 4 * (i // 2))
        return a_fragment_matrix(at).astype(np.int64)

    a_idx = {(tap, wg, m): a_index(tap, wg, m) for tap in range(9) for wg in (0, 1)
             for m in (0, 1)}
    acc = np.zeros((16, 16, 64))
    for c0 in range(0, 64, WK):
        xs = np.zeros(WH * WH * WK, np.float32)  # the chunk's raw input tile
        for p in range(WH * WH):
            for ch in range(WK):
                xs[_conv_px(p, ch)] = xp[p // WH, p % WH, c0 + ch]
        xh, xl = (t.numpy().astype(np.float64) for t in split_rz(torch.from_numpy(xs)))
        wh, wl = _weight_planes(w.reshape(9, 64, 64)[:, c0:c0 + WK])
        for tap in range(9):
            bh, bl = b_operand(wh, 64, tap), b_operand(wl, 64, tap)  # B[ci][co]
            for (t, wg, m), idx in a_idx.items():
                if t != tap:
                    continue
                ah, al = xh[idx], xl[idx]
                d = ah @ bl + al @ bh + ah @ bh  # 64 x 64: row 16 w4 + pixel, column co
                rows = [2 * (4 * wg + w4) + m for w4 in range(4)]
                acc[rows] += d.reshape(4, 16, 64)
    want = _conv_sum(torch.from_numpy(x), torch.from_numpy(w))[0].double().numpy()
    assert np.abs(acc - want).max() < 1e-5


# (B, H, W) -> blocks of the model fp32 conv's launch: the three convs at
# 480x640 and the 360x488 edge tiles, one image and two
MODEL_CONV_PLANS = {
    "conv1b+pool 2x480x640": ((2, 480, 640), 2400),
    "conv2a / conv2b 2x240x320": ((2, 240, 320), 600),
    "conv1b edge 2x360x488": ((2, 360, 488), 1426),
    "conv2a edge 2x180x244": ((2, 180, 244), 384),
    "one image 480x640": ((1, 480, 640), 1200),
}


@pytest.mark.parametrize("case", list(MODEL_CONV_PLANS))
def test_model_fp32_conv_plan_fits(case):
    """model_conv_plan is conv3x3_tf32_wgmma_kernel's launch
    (lg_conv_model_tile): one 256-thread block per 16 x 16 tile of one image
    (the batch only adds blocks: an image's tiles are the same alone), shared
    memory as the kernel lays it out (two raw stages of a chunk's 18 x 18 x 8
    tile and 9 x 8 x 64 weights, the hi and lo planes of three 64 x 32
    halves, 1 KB of alignment), two blocks an SM."""
    (b, h, w), blocks = MODEL_CONV_PLANS[case]
    plan = conv.model_conv_plan(b, h, w)
    stage = 4 * (18 * 18 * 8 + 9 * 8 * 64)
    assert plan == (16, 256, blocks, 2 * stage + 2 * 4 * 3 * 64 * 32 + 1024)
    assert plan.blocks == b * conv.model_conv_plan(1, h, w).blocks
    assert 2 * (plan.smem + 1024) <= 233_472  # two blocks and their reserves an SM
