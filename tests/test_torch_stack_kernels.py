"""The layer stack's bf16 kernels on the CPU: the launch plans of
csrc/linear.cu and csrc/attention.cu at the shapes the paths and
chip_smoke.py give them, and the premise of chip_smoke.py's rounding witness
for the stack attention."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from lightglue_tpu_torch.kernels import _build, layer_stack

ROOT = Path(__file__).resolve().parents[1]

# (m, n, k) -> the tile: every projection of a layer at the 1024 bucket (one
# pair), at the downshift's half width (512 rows), and for two pairs
LINEAR_SHAPES = {
    "qkv 1024": ((1024, 768, 256), (64, 32)),
    "out 1024": ((1024, 256, 256), (32, 32)),
    "ffn1 1024": ((1024, 512, 512), (64, 32)),
    "ffn2 1024": ((1024, 256, 512), (32, 32)),
    "qk_v 1024": ((1024, 512, 256), (64, 32)),
    "qkv 512": ((512, 768, 256), (32, 32)),
    "out 512": ((512, 256, 256), (32, 32)),
    "ffn1 512": ((512, 512, 512), (32, 32)),
    "ffn2 512": ((512, 256, 512), (32, 32)),
    "out 2x1024": ((2048, 256, 256), (64, 32)),
}


@pytest.mark.parametrize("shape", list(LINEAR_SHAPES))
def test_linear_plan_fills_the_card(shape):
    (m, n, k), tile = LINEAR_SHAPES[shape]
    plan = layer_stack.linear_plan(m, n, k)
    assert (plan.bm, plan.bn) == tile
    assert plan.blocks == -(-m // plan.bm) * (n // plan.bn) >= 128
    if m >= 1024:
        assert plan.blocks >= 256  # two blocks per SM where the rows allow it
    assert 64 % plan.bm == 0 and n % plan.bn == 0  # no tile straddles two pairs
    assert plan.smem <= _build.MAX_DYNAMIC_SMEM
    assert plan.chunks * plan.bk >= k and plan.stages >= 2


def test_linear_plan_of_the_smallest_bucket_is_the_smallest_tile():
    # 128 rows cannot give 256 blocks: the plan takes its smallest tile
    for n in (256, 512, 768):
        plan = layer_stack.linear_plan(128, n, 512)
        assert (plan.bm, plan.bn) == (32, 32) and plan.blocks == 4 * (n // 32)


# (batch, nq, nk) -> (row groups, blocks): the bf16 calls of the stack and
# of chip_smoke.py's attention cases, H = 4
ATTENTION_SHAPES = {
    "1024x1024 self or cross": ((1, 1024, 1024), (1, 256)),
    "768 self, masked": ((1, 768, 768), (1, 192)),
    "768x1024 cross, masked": ((1, 768, 1024), (1, 192)),
    "256x512 cross, length 0": ((1, 256, 512), (1, 64)),
    "128 bucket": ((1, 128, 128), (1, 32)),
    "512 half width": ((1, 512, 512), (1, 128)),
    "two pairs 1024": ((2, 1024, 1024), (2, 256)),
}


@pytest.mark.parametrize("shape", list(ATTENTION_SHAPES))
def test_attention_plan_fits(shape):
    (b, nq, nk), (groups, blocks) = ATTENTION_SHAPES[shape]
    plan = layer_stack.attention_plan(b, 4, nq, nk)
    assert (plan.row_groups, plan.blocks) == (groups, blocks)
    assert plan.row_groups * plan.col_split == 4
    assert plan.smem == layer_stack.mma_smem(groups, 2) <= _build.MAX_DYNAMIC_SMEM
    fp32 = layer_stack.attention_plan(b, 4, nq, nk, torch.float32)  # the FMA kernel's slab
    assert fp32.blocks == b * 4 * -(-nq // 16) and fp32.smem <= _build.MAX_DYNAMIC_SMEM


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_past_the_stack_gate_is_refused(dtype):
    with pytest.raises(ValueError):
        layer_stack.attention_plan(1, 4, 1024, 1152, dtype)
    meta = [torch.empty(1, n, 256, dtype=dtype, device="meta") for n in (128, 2048, 2048)]
    with pytest.raises(ValueError):  # the wrapper checks before it launches
        layer_stack.attention(*meta, None, None, None, 4, dtype)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# (nq, nk, rope, (q_len, kv_len) or None)
WITNESS_CASES = {
    "self rope 256": (256, 256, True, None),
    "cross masked 192x256": (192, 256, False, (180, 200)),
}


@pytest.mark.parametrize("case", list(WITNESS_CASES))
def test_stack_rounding_witness_premise(case):
    """The premise of the stack attention's witness in chip_smoke.py: the
    plain version differs from a copy of itself that sums in another order
    (the live keys reversed, q and k rotated first) in under 0.2 % of
    elements, and from each wrong design (``stack_wrong_designs``: (a) an
    online softmax per Nk / 8 keys, (b) acc rounded through bf16 before the
    division) in over 15 %. So a kernel that differs only in sum order
    meets the quarter rule, and one built on either design misses it. bf16
    operands and stats, H = 4."""
    nq, nk, rope, lens = WITNESS_CASES[case]
    bf16 = torch.bfloat16
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, n, 256), dtype=np.float32)).to(bf16)
               for n in (nq, nk, nk))
    f = lq = lk = None
    if rope:
        ang = rng.uniform(-2, 2, (1, nq, 32)).astype(np.float32)
        emb = np.stack([np.cos(ang), np.sin(ang)], axis=1)
        f = torch.from_numpy(np.concatenate([emb, emb], axis=-1))
    if lens:
        lq, lk = (torch.tensor([x], dtype=torch.int32) for x in lens)
    want = layer_stack.attention_plain(q, k, v, f, lq, lk, 4, bf16)

    qr, kr = q, k
    if rope:  # rotated first, so the keys can move without their positions
        def heads(t):
            return t.reshape(1, nq, 4, 64).transpose(1, 2)

        def merge(t):
            return t.transpose(1, 2).reshape(1, nq, 256)

        qr, kr = (merge(layer_stack.apply_rotary(f, heads(t))) for t in (q, k))
    live = lens[1] if lens else nk
    order = torch.cat([torch.arange(live).flip(0), torch.arange(live, nk)])
    reordered = layer_stack.attention_plain(qr, kr[:, order], v[:, order], None, lq, lk, 4, bf16)
    assert float((reordered != want).float().mean()) < 0.002

    wrong = _chip_smoke().stack_wrong_designs(q, k, v, f, lq, lk, 4)
    assert len(wrong) == 2
    for name, alt in wrong.items():
        assert alt.shape == want.shape and alt.dtype == bf16
        assert float((alt != want).float().mean()) > 0.15, name
