"""The fp32 conv2_chain of csrc/conv_chain.cu (chain_tf32x3_kernel, 3xTF32)
on the CPU: its launch plan's Python mirror at the shapes chip_smoke.py
gives it, the fp32 chain's plain version against the JAX conv2_chain, and
whole blocks of the kernel computed through its own addressing (the ring's
stages, the split weights, conv2a's row-major m16 tiles over the 18x18
tile, conv2a's fp32 tile at its pitch, conv2b's fragments from it, the
pool epilogue) and the mma.sync m16n8k8 tf32 fragment tables, against the
plain version and float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.kernels import conv_chain as jax_chain
from lightglue_tpu_torch.kernels import _build, conv, conv_chain
from tf32_emulation import mma_tf32_maps, split_rz

# csrc/conv_chain.cu's constants
C, OT = 64, 16
AT, XT = OT + 2, OT + 4
A_PIX = AT * AT
MWARPS = OT // 2
A_MT = -(-A_PIX // 16)
A_MT_WARP = -(-A_MT // MWARPS)
FK = 8
FCHUNKS = C // FK
FPA, FPN, FPT = FK + 4, C + 4, C + 4
FSTAGE = XT * XT * FPA + 9 * FK * C
SMEM_LIMIT = 227 * 1024  # dynamic shared memory of one Hopper block


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hw", [(240, 320), (180, 244)], ids=["240x320", "180x244"])
def test_chain_plan_fits_one_block(hw, dtype):
    plan = conv_chain.chain_plan(2, *hw, dtype)
    assert plan.smem <= SMEM_LIMIT and plan.smem <= _build.MAX_DYNAMIC_SMEM
    assert plan.threads == 32 * MWARPS and plan.tile == OT
    assert plan.tiles == 2 * -(-hw[0] // OT) * -(-hw[1] // OT)
    # the header's reckoning: 202,560 B (fp32), 223,488 B (bf16)
    want = (4 * (A_PIX * FPT + 2 * FSTAGE) + 8 * 9 * FK * FPN if dtype == torch.float32
            else 2 * (2 * 9 * C + XT * XT) * (C + 8))
    assert plan.smem == want == (202_560 if dtype == torch.float32 else 223_488)


def _inputs(seed, b, h, w):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(9 * C)  # the port's init scale
    x = rng.random((b, h, w, C)).astype(np.float32)
    wa, wb = ((rng.random((3, 3, C, C)) * 2 - 1) * bound for _ in range(2))
    ba, bb = ((rng.random(C) * 2 - 1) * bound for _ in range(2))
    return [np.asarray(t, np.float32) for t in (x, wa, ba, wb, bb)]


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16], ids=["fp32 out", "bf16 out"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no relu"])
def test_fp32_chain_matches_jax(relu, out):
    x, wa, ba, wb, bb = _inputs(3, 2, 18, 36)
    want = jax_chain.conv2_chain(*(jnp.asarray(t) for t in (x, wa, ba, wb, bb)), relu=relu,
                                 out_dtype=jnp.bfloat16 if out == torch.bfloat16 else None)
    got = conv_chain.conv2_chain(*(torch.from_numpy(t) for t in (x, wa, ba, wb, bb)),
                                 relu=relu, out_dtype=out)
    assert got.dtype == out and got.shape == (2, 9, 18, C)
    # fp32: two frameworks' fp32 sums; bf16 out: one rounding of the same value
    tol = dict(atol=1e-5, rtol=1e-5) if out == torch.float32 else dict(atol=1e-2, rtol=2 ** -8)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _emulate_block(x, wa, ba, wb, bb, relu, b, by, bx, y):
    """One block of chain_tf32x3_kernel (blockIdx (bx, by, b)) into y (fp32),
    through the kernel's shared-memory layout and lane addressing (each
    loop over a thread's copies or a lane's registers runs as one gather or
    scatter)."""
    amap, bmap, cmap = mma_tf32_maps()
    arow, acol = (torch.tensor([[amap[ln, i][d] for i in range(4)] for ln in range(32)])
                  for d in (0, 1))
    brow, bcol = (torch.tensor([[bmap[ln, i][d] for i in range(2)] for ln in range(32)])
                  for d in (0, 1))
    crow, ccol = (torch.tensor([[cmap[ln, r][d] for r in range(4)] for ln in range(32)])
                  for d in (0, 1))
    _, hh, ww, _ = x.shape
    y0, x0 = by * OT, bx * OT
    raw = torch.zeros(2 * FSTAGE, dtype=torch.float32)
    ws = torch.zeros(9 * FK * FPN, 2, dtype=torch.float32)  # (hi, lo) pairs
    lane = torch.arange(32)
    g, t4 = lane // 4, lane % 4
    xpad = torch.zeros(x.shape[1] + 4, x.shape[2] + 40, C)  # zeros outside the image
    xpad[2:2 + hh, 2:2 + ww] = x[b]

    def stage(c):
        base = c % 2 * FSTAGE
        first = c < FCHUNKS
        c0 = (c if first else c - FCHUNKS) * FK
        if first:  # s = p * (FK / 4) + k4 / 4: every float of the 20x20 tile's 8 channels
            p = torch.arange(XT * XT)
            gy, gx = y0 - 2 + p // XT, x0 - 2 + p % XT
            inside = (gy >= 0) & (gy < hh) & (gx >= 0) & (gx < ww)
            vals = xpad[(gy + 2).clamp(0, hh + 3), (gx + 2).clamp(0, ww + 39), c0:c0 + FK]
            vals = torch.where(inside[:, None], vals, 0.0)
            idx = base + p[:, None] * FPA + torch.arange(FK)[None]
            raw[idx] = vals
        w = (wa if first else wb).reshape(9 * C, C)
        r = torch.arange(9 * FK)  # r = tap * FK + channel in chunk
        wr = base + XT * XT * FPA
        raw[wr + r[:, None] * C + torch.arange(C)[None]] = w[r // FK * C + c0 + r % FK]

    def split_weights(c):
        wr = raw[c % 2 * FSTAGE + XT * XT * FPA:][:9 * FK * C].reshape(9 * FK, C)
        hi, lo = split_rz(wr)
        ws.view(9 * FK, FPN, 2)[:, :C, 0] = hi
        ws.view(9 * FK, FPN, 2)[:, :C, 1] = lo

    def b_frags(tap):
        """B (8 x 64) of one tap in hi and lo, from the lanes' ws loads."""
        bh, bl = torch.zeros(8, C), torch.zeros(8, C)
        n = torch.arange(C // 8)
        for i in range(2):  # b0 at k t4, b1 at k t4 + 4
            pair = ws[(tap * FK + t4[:, None] + 4 * i) * FPN + g[:, None] + n[None] * 8]
            rows = brow[:, i, None].expand(32, C // 8)
            cols = n[None] * 8 + bcol[:, i, None]
            bh[rows, cols], bl[rows, cols] = pair[..., 0], pair[..., 1]
        return bh.double(), bl.double()

    def mma3(acc, vals, bh, bl):
        """acc (16 x 64) += A B in 3xTF32, A from each lane's four registers."""
        ah, al = torch.zeros(16, 8, dtype=torch.float64), torch.zeros(16, 8, dtype=torch.float64)
        hi, lo = split_rz(vals)
        ah[arow, acol], al[arow, acol] = hi.double(), lo.double()
        acc += ah @ bl + al @ bh + ah @ bh

    # conv2a: m16 tile warp + MWARPS * j; fragment rows g and g + 8 at tile
    # pixel q (clamped into the tile), input-tile pixel a_in for tap (0, 0)
    live = [(warp, j) for warp in range(MWARPS) for j in range(A_MT_WARP)
            if j < 2 or warp + MWARPS * 2 < A_MT]
    acc = torch.zeros(MWARPS, A_MT_WARP, 16, C, dtype=torch.float64)
    a_in = {}
    for warp, j in live:
        for i in range(2):
            q = torch.clamp(16 * (warp + MWARPS * j) + g + 8 * i, max=A_PIX - 1)
            a_in[warp, j, i] = q // AT * XT + q % AT
    stage(0)
    for c in range(FCHUNKS):
        stage(c + 1)
        split_weights(c)
        xs = raw[c % 2 * FSTAGE:]
        for tap in range(9):
            shift = tap // 3 * XT + tap % 3
            bh, bl = b_frags(tap)
            for warp, j in live:
                p0 = (a_in[warp, j, 0] + shift) * FPA + t4
                p1 = (a_in[warp, j, 1] + shift) * FPA + t4
                vals = torch.stack([xs[p0], xs[p1], xs[p0 + 4], xs[p1 + 4]], 1)
                mma3(acc[warp, j], vals, bh, bl)
    # relu(acc + ba), 0 outside the image, at tile pixel p and channels
    # n * 8 + 2 t4 + {0, 1}, row p of mid (the lanes' C registers)
    mid = torch.zeros(A_PIX * FPT, dtype=torch.float32)
    n = torch.arange(C // 8)
    for warp, j in live:
        p = 16 * (warp + MWARPS * j) + crow  # (lane, reg)
        ch = n[None, None] * 8 + ccol[..., None]  # (lane, reg, n)
        gy, gx = y0 - 1 + p // AT, x0 - 1 + p % AT
        inside = (gy >= 0) & (gy < hh) & (gx >= 0) & (gx < ww)
        v = torch.clamp_min(acc[warp, j][crow[..., None], ch].float() + ba[ch], 0.0)
        v = torch.where(inside[..., None], v, 0.0)
        keep = (p < A_PIX)[..., None].expand_as(ch)
        mid[(p[..., None] * FPT + ch)[keep]] = v[keep]
    # conv2b: output rows 2 warp + m, A fragments from mid
    acc2 = torch.zeros(MWARPS, 2, 16, C, dtype=torch.float64)
    for c in range(FCHUNKS, 2 * FCHUNKS):
        if c + 1 < 2 * FCHUNKS:
            stage(c + 1)
        split_weights(c)
        k0 = (c - FCHUNKS) * FK
        for tap in range(9):
            dy, dx = tap // 3, tap % 3
            bh, bl = b_frags(tap)
            for warp in range(MWARPS):
                for m in range(2):
                    px = ((2 * warp + m + dy) * AT + dx + g) * FPT + k0 + t4
                    vals = torch.stack([mid[px], mid[px + 8 * FPT], mid[px + 4],
                                        mid[px + 8 * FPT + 4]], 1)
                    mma3(acc2[warp, m], vals, bh, bl)
    # fp32 bb, [ReLU,] the pool max over the thread's two rows and the lane 4
    # apart (__shfl_xor_sync(..., 4)), stored by the even-g lanes
    ho, wo = hh // 2, ww // 2
    acc2 = acc2.float()
    for warp in range(MWARPS):
        oy = y0 // 2 + warp
        for i in range(2):  # fragment rows g and g + 8
            ch = n[None, :, None] * 8 + 2 * t4[:, None, None] + torch.arange(2)  # (lane, n, k)
            row = (g + 8 * i)[:, None, None]
            top, bot = acc2[warp, 0][row, ch] + bb[ch], acc2[warp, 1][row, ch] + bb[ch]
            if relu:
                top, bot = torch.clamp_min(top, 0.0), torch.clamp_min(bot, 0.0)
            v = torch.maximum(top, bot)
            v = torch.maximum(v, v[lane ^ 4])
            ox = x0 // 2 + (g + 8 * i) // 2
            for ln in range(32):
                if not g[ln] & 1 and oy < ho and ox[ln] < wo:
                    y[b, oy, ox[ln]].view(C // 8, 8)[:, 2 * t4[ln]:2 * t4[ln] + 2] = v[ln]


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no relu"])
@pytest.mark.parametrize("shape", [(1, 16, 16), (1, 18, 36)], ids=["one tile", "edge tiles"])
def test_chain_tf32x3_blocks_through_the_kernels_addressing(shape, relu):
    """Every block of a small map, as chain_tf32x3_kernel addresses it: the
    edge tiles (18x36 runs 2x3 tiles, conv2a's tile past the image) hold
    the fp32 gate against the plain version, and the error against float64
    stays under a tenth of an emulated one-TF32 chain's."""
    b, h, w = shape
    x, wa, ba, wb, bb = (torch.from_numpy(t) for t in _inputs(5, b, h, w))
    y = torch.full((b, h // 2, w // 2, C), float("nan"))
    for bz in range(b):
        for by in range(-(-h // OT)):
            for bx in range(-(-w // OT)):
                _emulate_block(x, wa, ba, wb, bb, relu, bz, by, bx, y)
    want = conv_chain.conv2_chain_plain(x, wa, ba, wb, bb, relu=relu)
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
    xd = x.double().permute(0, 3, 1, 2)
    mid = torch.relu(torch.nn.functional.conv2d(xd, wa.double().permute(3, 2, 0, 1), padding=1)
                     + ba.double()[None, :, None, None])
    f64 = torch.nn.functional.conv2d(mid, wb.double().permute(3, 2, 0, 1), padding=1)
    f64 = f64 + bb.double()[None, :, None, None]
    f64 = torch.nn.functional.max_pool2d(torch.relu(f64) if relu else f64, 2).permute(0, 2, 3, 1)
    tf32 = lambda t: split_rz(t)[0]  # noqa: E731
    one_mid = conv.conv3x3_plain(tf32(x), tf32(wa), ba)
    one = conv.conv3x3_plain(tf32(one_mid), tf32(wb), bb, True, relu=relu)
    err = float((y.double() - f64).abs().mean())
    assert err < 0.1 * float((one.double() - f64).abs().mean()), err
