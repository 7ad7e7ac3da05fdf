"""TF32 on the CPU, for the tests of the port's 3xTF32 kernels
(csrc/conv3x3.cu's fp32 model conv, the fp32 attention kernels,
csrc/flash_attn.cu's and csrc/linear.cu's fp32 kernels on wgmma): the
rounding of cvt.rna.tf32.f32, the truncating split, the fragment layout of
mma.sync m16n8k8 with tf32 operands, and the layouts the wgmma kernels hand
m64nNk8: fp32 K-major tiles as TMA writes them in 128 B swizzle, read back
through the kernels' descriptors, the register-A fragment and the
accumulator, V's transposed copy and P taken from the S accumulator."""

import numpy as np
import torch


def tf32(t):
    """fp32 values rounded to TF32 as cvt.rna.tf32.f32 does on finite values:
    to nearest on the 10-bit mantissa, ties away from zero (the rounding of
    the magnitude's bits: add half of the 13 dropped bits' unit, cut them)."""
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_rz(t):
    """fp32 values truncated to TF32 (the low 13 bits cleared): what
    mma.sync reads of a .tf32 operand register."""
    return (t.view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_rz(t):
    """The 3xTF32 split of mma.cuh:split_tf32_rz as mma.sync sees it: hi = t
    truncated, lo = t - hi (exact), read truncated in turn."""
    hi = tf32_rz(t)
    return hi, tf32_rz(t - hi)


def mma_tf32_maps():
    """(row, col) of each (lane, register) of mma.sync m16n8k8's tf32 A (16 x
    8, row-major), B (8 x 8, k x n) and C (16 x 8) fragments, from the PTX
    ISA's tables, with g = lane / 4 and t4 = lane % 4."""
    a, b, c = {}, {}, {}
    for lane in range(32):
        g, t4 = divmod(lane, 4)
        for i in range(4):
            a[lane, i] = (g + 8 * (i % 2), t4 + 4 * (i // 2))
            c[lane, i] = (g + 8 * (i // 2), 2 * t4 + i % 2)
        for i in range(2):
            b[lane, i] = (t4 + 4 * i, g)
    return a, b, c


def tma_halves(tile):
    """A K-major fp32 tile [rows][64] as the kernels' TMA boxes write it:
    two [rows][32] halves (32-float boxes), each row's 16 B unit c at c ^
    row % 8 (128 B swizzle); a flat float array, half 1 rows * 32 floats
    on."""
    rows = tile.shape[0]
    flat = np.zeros(rows * 64, tile.dtype)
    for half in range(2):
        for r in range(rows):
            for c in range(32):
                at = half * rows * 128 + r * 128 + ((c // 4) ^ (r % 8)) * 16 + (c % 4) * 4
                flat[at // 4] = tile[r, 32 * half + c]
    return flat


def kmajor_read(flat, start, r, k):
    """Element (row r, k) of the k8 step whose descriptor starts at byte
    `start` of a K-major 128 B-swizzled tile, as wgmma reads it: rows in
    groups of eight at SBO = 1024 B, 128 B a row, the swizzle XORing
    address bits 4-6 with bits 7-9."""
    logical = start + (r // 8) * 1024 + (r % 8) * 128 + 4 * k
    return flat[(logical ^ (((logical >> 7) & 7) << 4)) // 4]


def desc_read(flat, rows, kk, r, k):
    """... through hopper.cuh:desc_step_f32's descriptor of k8 step kk
    (0..7) of a tile of `rows` rows: half kk / 4, 32 B per step inside it."""
    return kmajor_read(flat, (kk // 4) * rows * 128 + 32 * (kk % 4), r, k)


def b_operand(flat, rows, kk):
    """B (8 x rows) of k8 step kk read through the descriptor: B[k][n] is
    row n's k-th value of the step."""
    return np.array([[desc_read(flat, rows, kk, n, k) for n in range(rows)] for k in range(8)])


def a_fragment_matrix(reg):
    """The 64 x 8 A operand of m64nNk8 from registers: reg(warp, lane, i)
    is register i of lane (g, t4) of warp w, the m16n8k8 tf32 A fragment of
    rows 16 w..: a0 (g, t4), a1 (g + 8, t4), a2 (g, t4 + 4), a3 (g + 8, t4 +
    4)."""
    a = np.zeros((64, 8))
    for w in range(4):
        for lane in range(32):
            g, t4 = divmod(lane, 4)
            for i in range(4):
                a[16 * w + g + 8 * (i % 2), t4 + 4 * (i // 2)] = reg(w, lane, i)
    return a


def acc_at(w, lane, e):
    """(row, column) of accumulator register e of lane (g, t4) of warp w."""
    g, t4 = divmod(lane, 4)
    return 16 * w + g + 8 * ((e // 2) % 2), 8 * (e // 4) + 2 * t4 + e % 2


def vt_copy(v):
    """The fp32 attention kernels' V^T writer (flash_attn.cu, attention.cu) for one 32-key piece v [32][64] (land):
    item = tid + 128 it, d = item % 64, 16 B unit u = item / 64 of row d,
    at u ^ d % 8, holding keys key0, +2, +4, +6 with key0 = 8 (u / 2) + u %
    2: position 8 j + q of row d is key 8 j + 2 q (q < 4) or 8 j + 2 (q -
    4) + 1. A flat [64][32] array."""
    flat = np.zeros(64 * 32, v.dtype)
    for tid in range(128):
        for it in range(4):
            item = tid + 128 * it
            d, u = item % 64, item // 64
            key0 = 8 * (u // 2) + u % 2
            at = d * 128 + ((u ^ (d % 8)) * 16)
            for e in range(4):
                flat[at // 4 + e] = v[key0 + 2 * e, d]
    return flat


def p_register(p, w, lane, i, kk):
    """P's A register i of k step kk, taken from the S accumulator of the
    piece as the fp32 attention kernels take it: registers 4 kk, 4 kk + 2, 4 kk + 1,
    4 kk + 3 (keys 8 kk + 2 t4 and + 1 of rows g and g + 8)."""
    r, c = acc_at(w, lane, 4 * kk + (0, 2, 1, 3)[i])
    return p[r, c]


def vt_operand(vt, kk):
    """B (8 x 64) of P.V's k8 step kk read from a V^T copy through its
    descriptor (one half, 32 B a step)."""
    return np.array([[kmajor_read(vt, 32 * kk, d, kq) for d in range(64)] for kq in range(8)])


def index_map(read, size):
    """What a layout function reads, as flat indices: ``read`` applied to
    np.arange(size) (a flat array, or its reshape where the function takes a
    matrix), so the layout is computed once and applied by fancy indexing."""
    return np.asarray(read(np.arange(size)), np.int64)
