"""The layer stack's bf16 kernels on the CPU: the launch plans of
csrc/linear.cu and csrc/attention.cu (its fp32 kernel's too) at the shapes
the paths and chip_smoke.py give them, and the premise of chip_smoke.py's
rounding witness for the stack attention."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from lightglue_tpu_torch.kernels import _build, layer_stack

ROOT = Path(__file__).resolve().parents[1]

# (m, n, k, rows of one pair) -> the BF16 tile: every projection of a layer
# at the 1024 bucket (one pair), at the downshift's half width (512 rows),
# and for two pairs (one pair's tile: the batch only adds blocks)
LINEAR_SHAPES = {
    "qkv 1024": ((1024, 768, 256, 1024), (64, 64)),
    "out 1024": ((1024, 256, 256, 1024), (64, 32)),
    "ffn1 1024": ((1024, 512, 512, 1024), (64, 64)),
    "ffn2 1024": ((1024, 256, 512, 1024), (64, 32)),
    "qk_v 1024": ((1024, 512, 256, 1024), (64, 64)),
    "qkv 512": ((512, 768, 256, 512), (64, 32)),
    "out 512": ((512, 256, 256, 512), (64, 32)),
    "ffn1 512": ((512, 512, 512, 512), (64, 32)),
    "ffn2 512": ((512, 256, 512, 512), (64, 32)),
    "out 2x1024": ((2048, 256, 256, 1024), (64, 32)),
}


@pytest.mark.parametrize("shape", list(LINEAR_SHAPES))
def test_linear_plan_fills_the_card(shape):
    (m, n, k, rows), tile = LINEAR_SHAPES[shape]
    plan = layer_stack.linear_plan(m, n, k, rows=rows)
    assert (plan.bm, plan.bn) == tile and plan.kernel == "linear_wgmma_kernel"
    assert plan.blocks == -(-m // plan.bm) * (n // plan.bn) >= 64
    if rows >= 1024:
        assert plan.blocks >= 128  # about one block per SM where one pair's rows allow it
    assert 64 % plan.bm == 0 and n % plan.bn == 0  # no tile straddles two pairs
    assert plan.smem <= _build.MAX_DYNAMIC_SMEM
    assert plan.chunks * plan.bk >= k and plan.stages >= 2


def test_linear_plan_of_the_smallest_bucket_is_the_smallest_tile():
    # 128 rows cannot give 128 blocks: the plan takes its narrowest tile
    for n in (256, 512, 768):
        plan = layer_stack.linear_plan(128, n, 512)
        assert (plan.bm, plan.bn) == (64, 32) and plan.blocks == 2 * (n // 32)


# the stack's projections (K1, K2 the second operand, N) at E = 256
STACK_PROJECTIONS = {"qkv": (256, 0, 768), "out": (256, 0, 256), "ffn1": (256, 256, 512),
                     "ffn2": (512, 0, 256), "qk_v": (256, 0, 512)}


@pytest.mark.parametrize("rows", range(128, 1025, 128))
@pytest.mark.parametrize("proj", list(STACK_PROJECTIONS))
def test_wgmma_plans_on_the_ladder(proj, rows):
    """The bf16-product launches of every stack projection (ffn1's two
    operands included; BF16, MIXED and INT8) and of the stack attention on
    the 128-step bucket ladder:
    64-row tiles whose columns divide N, a block within the card's shared
    memory, one pair's tile and attention split at 1, 2, 4 and 8 pairs."""
    k1, k2, n = STACK_PROJECTIONS[proj]
    one = layer_stack.linear_plan(rows, n, k1 + k2)
    for b in (1, 2, 4, 8):
        # BF16, MIXED (fp32 activations) and INT8 (int8 weights): one kernel
        for dt, wdt in ((torch.bfloat16, None), (torch.float32, torch.bfloat16),
                        (torch.bfloat16, torch.int8)):
            plan = layer_stack.linear_plan(b * rows, n, k1 + k2, dt, wdt, rows=rows)
            assert plan.bm == 64 and n % plan.bn == 0 and plan.kernel == "linear_wgmma_kernel"
            assert plan.smem <= _build.MAX_DYNAMIC_SMEM
            assert plan.chunks == -(-k1 // 64) - (-k2 // 64)  # ffn1: A's chunks, then A2's
            assert plan[:2] == one[:2] and plan.blocks == b * one.blocks
        for stats in (torch.bfloat16, torch.float32):
            attn = layer_stack.attention_plan(b, 4, rows, rows, torch.bfloat16, stats)
            assert attn[:2] == layer_stack.attention_plan(1, 4, rows, rows)[:2] == (4, 8)
            tiles = b * 4 * rows // 64  # clusters of two blocks while they fit 132 SMs
            assert attn.blocks == tiles * (2 if 2 * tiles <= 132 else 1)
            assert attn.smem <= _build.MAX_DYNAMIC_SMEM


# (batch, nq, nk) -> (bf16 blocks, fp32 split, fp32 blocks): the calls of
# the stack and of chip_smoke.py's attention cases, H = 4. bf16: eight
# consumers splitting each row's keys, a cluster of two blocks per 64 rows
# of a head while the launch fits 132 SMs, else one block (two pairs).
# fp32: the split from one pair's shape (eight at every bucket of H = 4:
# 128 tiles' blocks at most), a split of eight always a cluster of two
ATTENTION_SHAPES = {
    "1024x1024 self or cross": ((1, 1024, 1024), (128, 8, 128)),
    "768 self, masked": ((1, 768, 768), (96, 8, 96)),
    "768x1024 cross, masked": ((1, 768, 1024), (96, 8, 96)),
    "256x512 cross, length 0": ((1, 256, 512), (32, 8, 32)),
    "128 bucket": ((1, 128, 128), (16, 8, 16)),
    "512 half width": ((1, 512, 512), (64, 8, 64)),
    "two pairs 1024": ((2, 1024, 1024), (128, 8, 256)),
}


@pytest.mark.parametrize("shape", list(ATTENTION_SHAPES))
def test_attention_plan_fits(shape):
    (b, nq, nk), (blocks, split, fp32_blocks) = ATTENTION_SHAPES[shape]
    plan = layer_stack.attention_plan(b, 4, nq, nk)
    cluster = b == 1
    assert plan == (4, 8, blocks, layer_stack.wgmma_attention_smem(True, cluster),
                    "attention_wgmma_kernel")
    # MIXED (fp32 stats) recomputes S in pass 2: no s kept, K and V in a slot
    mixed = layer_stack.attention_plan(b, 4, nq, nk, torch.bfloat16, torch.float32)
    assert mixed[:3] == plan[:3]
    assert mixed.smem == layer_stack.wgmma_attention_smem(False, cluster)
    assert max(mixed.smem, plan.smem) <= _build.MAX_DYNAMIC_SMEM
    # the fp32 (3xTF32) kernel on wgmma: 32-key pieces through one ring slot
    # a warpgroup, one pair's split at every batch, one block an SM
    fp32 = layer_stack.attention_plan(b, 4, nq, nk, torch.float32)
    assert fp32[:3] == (4, split, fp32_blocks) and fp32.kernel == "attention_tf32_wgmma_kernel"
    assert fp32.col_split == layer_stack.tf32_split(4, nq)
    assert fp32.smem == layer_stack.wgmma_tf32_attention_smem() <= _build.MAX_DYNAMIC_SMEM


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_past_the_stack_gate_is_refused(dtype):
    with pytest.raises(ValueError):
        layer_stack.attention_plan(1, 4, 1024, 1152, dtype)
    meta = [torch.empty(1, n, 256, dtype=dtype, device="meta") for n in (128, 2048, 2048)]
    with pytest.raises(ValueError):  # the wrapper checks before it launches
        layer_stack.attention(*meta, None, None, None, 4, dtype)


@pytest.mark.parametrize("kernel", ["linear", "attention"])
def test_tma_refuses_operands_off_16_bytes(kernel):
    """The BF16 kernels read their operands through TMA, which needs 16 B
    bases and strides: the wrappers raise a ValueError on any other operand
    before a launch (meta tensors carry the offsets, no card needed)."""
    bf16 = torch.bfloat16
    flat = torch.empty(64 * 776 + 8, dtype=bf16, device="meta")
    if kernel == "linear":
        a = flat[4:4 + 64 * 256].view(64, 256)  # 8 B past a 16 B base
        w, b = (torch.empty(s, dtype=bf16, device="meta") for s in ((256, 256), (256,)))
        with pytest.raises(ValueError, match="TMA"):
            layer_stack.linear(a, w, b)
        with pytest.raises(ValueError, match="TMA"):  # ffn1's second operand 8 B off
            layer_stack.linear(flat[:64 * 248].view(64, 248), w, b,
                               a2=flat[4:4 + 64 * 8].view(64, 8))
    else:
        qkv = flat[4:4 + 64 * 776].view(1, 64, 776)
        with pytest.raises(ValueError, match="TMA"):
            layer_stack.attention(qkv[..., :256], qkv[..., 256:512], qkv[..., 512:768], None,
                                  None, None, 4, bf16)
        rows = flat[:64 * 772].view(1, 64, 772)  # row stride of 772: 1544 B
        with pytest.raises(ValueError, match="TMA"):
            layer_stack.attention(rows[..., :256], rows[..., 256:512], rows[..., 512:768], None,
                                  None, None, 4, bf16)


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
