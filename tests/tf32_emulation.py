"""TF32 on the CPU, for the tests of the port's 3xTF32 kernels
(csrc/conv3x3.cu's fp32 model conv, csrc/flash_attn.cu's and
csrc/linear.cu's fp32 kernels): the rounding of cvt.rna.tf32.f32, the
truncating split of the latter two, and the fragment layout of mma.sync
m16n8k8 with tf32 operands."""

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
