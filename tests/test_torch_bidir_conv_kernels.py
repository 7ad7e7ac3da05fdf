"""The bf16 tensor-core kernels of csrc/bidir_cross.cu and csrc/conv3x3.cu on
the CPU: the launch plan of the bidirectional kernel (its fp32 kernel's
too) at the shapes the paths and chip_smoke.py give it, and the premises of
chip_smoke.py's rounding witnesses for both kernels."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from lightglue_tpu_torch.kernels import _build, attention, conv, layer_stack

ROOT = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _share(a, b):
    """The share of elements in which two outputs differ."""
    assert a.shape == b.shape and a.dtype == b.dtype == BF16
    return float((a != b).float().mean())


# (batch, n0, n1) -> (row groups, blocks) of the bf16 kernel, H = 4: the
# pad-to-64 path's 960 cap, its mixed buckets, two pairs (two of one pair's
# row groups in an eight-warp block, each with the pair's split), and a size
# past what the old fp32 kernel's S slab held in shared memory
BIDIR_PLANS = {
    "960x960": ((1, 960, 960), (2, 240)),
    "960x704": ((1, 960, 704), (2, 208)),
    "960x64 mixed buckets": ((1, 960, 64), (2, 128)),
    "two pairs 960x960": ((2, 960, 960), (4, 240)),
    "two pairs 960x704": ((2, 960, 704), (4, 208)),
    "two pairs 960x64": ((2, 960, 64), (4, 128)),
    "4096x4096": ((1, 4096, 4096), (4, 512)),
    "128x64, one row group a block": ((1, 128, 64), (1, 48)),
}


@pytest.mark.parametrize("shape", list(BIDIR_PLANS))
def test_bidir_plan_fits(shape):
    (b, n0, n1), (groups, blocks) = BIDIR_PLANS[shape]
    plan = attention.bidir_plan(b, 4, n0, n1)
    assert (plan.row_groups, plan.blocks) == (groups, blocks)
    assert plan.col_split == attention.bidir_plan(1, 4, n0, n1).col_split  # the pair's split
    assert plan.row_groups * plan.col_split in (4, 8, 16)
    rows = 16 * groups  # both directions' row blocks
    assert plan.blocks == b * 4 * (-(-n0 // rows) - (-n1 // rows))
    assert groups == 1 or plan.blocks >= 128  # larger blocks only while a wave stays full
    assert plan.smem == layer_stack.mma_smem(groups, 2, plan.col_split) <= _build.MAX_DYNAMIC_SMEM
    # the fp32 (3xTF32) kernel: the same blocks, fp32 chunks streamed
    # through two buffers, two four-warp blocks an SM (one larger one)
    fp32 = attention.bidir_plan(b, 4, n0, n1, torch.float32)
    assert fp32[:3] == plan[:3]
    assert fp32.smem == layer_stack.tf32_smem(groups, 2, plan.col_split)
    assert (1 if groups * plan.col_split > 4 else 2) * fp32.smem <= _build.MAX_DYNAMIC_SMEM


def test_bidir_plan_refuses_the_fp32_slab_past_shared_memory():
    """The fp32 plan keeps no S slab any more: at 4096 x 64, where the FMA
    kernel's 16 x 4096 slab exceeded shared memory and the plan raised, the
    rows stream through the two chunk buffers, and the block's shared memory
    is tf32_smem at its row groups, whatever N (two blocks an SM)."""
    plan = attention.bidir_plan(1, 4, 4096, 64, torch.float32)
    assert (plan.row_groups, plan.blocks) == (4, 4 * (64 + 1))
    assert plan.smem == layer_stack.tf32_smem(4, 2) <= _build.MAX_DYNAMIC_SMEM // 2
    for n0 in (64, 1024, 16384):
        at_n = attention.bidir_plan(1, 4, n0, 64, torch.float32)
        assert at_n.smem == layer_stack.tf32_smem(at_n.row_groups, 2) <= _build.MAX_DYNAMIC_SMEM // 2


# (n0, n1, (n0_len, n1_len) or None)
BIDIR_WITNESS = {
    "unmasked 256x256": (256, 256, None),
    "masked 192x256": (192, 256, (180, 200)),
}


@pytest.mark.parametrize("direction", [0, 1], ids=["o0", "o1"])
@pytest.mark.parametrize("case", list(BIDIR_WITNESS))
def test_bidirectional_rounding_witness_premise(case, direction):
    """The premise of the bidirectional kernel's witness in chip_smoke.py:
    the plain version differs from a copy of itself that sums over the keys
    in another order (each side's live rows reversed) in under 0.2 % of
    elements, and from each of ``stack_wrong_designs`` applied to the
    direction ((qk0, qk1, v1) with lengths (n0, n1), (qk1, qk0, v0) with
    (n1, n0)) in over 15 %. bf16 operands and stats, H = 4."""
    n0, n1, lens = BIDIR_WITNESS[case]
    rng = np.random.default_rng(7)
    qk0, qk1, v0, v1 = (torch.from_numpy(rng.standard_normal((1, n, 256), dtype=np.float32))
                        .to(BF16) for n in (n0, n1, n0, n1))
    ln = None if lens is None else torch.tensor([lens], dtype=torch.int32)
    kw = dict(num_heads=4, stat_dtype=BF16)
    want = attention.bidirectional_cross_attention_plain(qk0, qk1, v0, v1, ln, **kw)[direction]

    live0, live1 = lens or (n0, n1)
    p0, p1 = (torch.cat([torch.arange(live).flip(0), torch.arange(live, n)])
              for live, n in ((live0, n0), (live1, n1)))
    reordered = attention.bidirectional_cross_attention_plain(
        qk0[:, p0], qk1[:, p1], v0[:, p0], v1[:, p1], ln, **kw)[direction]
    reordered = reordered[:, (p0, p1)[direction]]  # each permutation is its own inverse
    assert _share(reordered, want) < 0.002

    len0, len1 = (None, None) if ln is None else (ln[:, 0], ln[:, 1])
    q, k, v, lq, lk = ((qk0, qk1, v1, len0, len1), (qk1, qk0, v0, len1, len0))[direction]
    wrong = _chip_smoke().stack_wrong_designs(q, k, v, None, lq, lk, 4)
    assert len(wrong) == 2
    for name, alt in wrong.items():
        assert _share(alt, want) > 0.15, name


@pytest.mark.parametrize("pool", [False, True], ids=["no pool", "pool"])
def test_conv_rounding_witness_premise(pool):
    """The premise of the model conv's witness in chip_smoke.py: the plain
    version differs from the same conv with its nine taps summed in reverse
    order in under 0.2 % of elements, and from each of ``conv_wrong_designs``
    ((a) acc rounded through bf16 before the bias, (b) after every tap) in
    over 10 %. ReLU zeroes about half of the outputs, where no design can
    differ, so (a) differs in ~14 % without the pool and ~19 % with it,
    (b) in 31-40 %. bf16 operands, 1x32x48x64 -> 64, chip_smoke.py's value
    ranges (the port's init scale, 1/sqrt(9 C_in))."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 32, 48, 64)).astype(np.float32)).to(BF16)
    w = torch.from_numpy(rng.uniform(-1 / 24, 1 / 24, (3, 3, 64, 64)).astype(np.float32)).to(BF16)
    b = torch.from_numpy(rng.uniform(-1 / 24, 1 / 24, 64).astype(np.float32))
    want = conv.conv3x3_plain(x, w, b, pool)
    cs = _chip_smoke()
    reordered = cs.conv_epilogue(cs.conv_taps(x, w, taps=range(8, -1, -1)), b, pool)
    assert _share(reordered, want) < 0.002
    wrong = cs.conv_wrong_designs(x, w, b, pool)
    assert len(wrong) == 2
    for name, alt in wrong.items():
        assert alt.shape == want.shape
        assert _share(alt, want) > 0.10, name
