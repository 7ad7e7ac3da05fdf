"""The launch of csrc/flash_attn.cu's bf16 kernel (flash_wgmma_kernel) as
kernels/attention.py:flash_plan mirrors it, and the wrappers' refusal of
bf16 operands that TMA cannot address (tests/test_torch_fp32_wgmma.py holds
the fp32 kernel's). No card needed: the plan is arithmetic,
and meta tensors carry the offsets to the wrappers' checks."""

import pytest
import torch

from lightglue_tpu_torch.kernels import _build, attention

BF16 = torch.bfloat16
TILE = 2 * 64 * 64  # a 64 x 64 bf16 box, bytes
SMS = 132

# (batch, heads, nq, block_k): the routes' shapes (2048 self and cross, the
# TP shards' heads, 960 pad-to-64 self and cross, the generic entry point,
# the ring's 512-row stripes and its fitted blocks) and chip_smoke.py's
# edge cases (block_k 1000, 120, 64, past 1024)
ROUTE_SHAPES = {
    "2048 self": (2, 4, 2048, 1024),
    "2048 cross": (1, 4, 2048, 1024),
    "2048 self, TP H=2": (2, 2, 2048, 1024),
    "2048 cross, TP H=1": (1, 1, 2048, 1024),
    "960 self": (2, 4, 960, 960),
    "960 cross": (1, 4, 960, 960),
    "generic (2, 4, 2048, 64)": (2, 4, 2048, 1024),
    "ring stripe 512": (1, 4, 512, 512),
    "ring 384 fitted to 192": (1, 4, 384, 192),
    "ring stripe 120": (1, 4, 120, 120),
    "block_k 1000": (2, 4, 1000, 1000),
    "block_k 64": (2, 4, 1024, 64),
    "block_k 2048": (1, 4, 2048, 2048),
    "8 pairs of 2048": (16, 4, 2048, 1024),
}
STATS = {"bf16 stats": BF16, "fp32 stats": torch.float32}


def _smem(store: bool, cluster: bool) -> int:
    """A block's bytes, counted the way csrc/flash_attn.cu:Smem lays them
    out: Q; four warpgroups' regions (two ring slots, then the stored s of
    a warpgroup's chunks of a 1024-key tile, or a 64 x 64 fp32 partial);
    the block's rows of acc and of l; row max and sum p per warpgroup; the
    cluster's row max, each row's correction and max; 17 barriers; 1 KB of
    alignment."""
    ways = 2 if cluster else 1
    slot = TILE if store else 2 * TILE  # K (then V), or K and V together
    chunks = 1024 // 64 // (4 * ways)  # a warpgroup's share of a 1024-key tile
    region = 2 * slot + (chunks * TILE if store else 64 * 64 * 4)
    acc, l = 64 // ways * 64 * 4, 64 // ways * 4
    return TILE + 4 * region + acc + l + 2 * 4 * 64 * 4 + 3 * 64 * 4 + 17 * 8 + 1024


@pytest.mark.parametrize("stats", list(STATS))
@pytest.mark.parametrize("shape", list(ROUTE_SHAPES))
def test_bf16_smem_formula_matches_the_plan(shape, stats):
    batch, heads, nq, block_k = ROUTE_SHAPES[shape]
    plan = attention.flash_plan(batch, heads, nq, block_k, BF16, STATS[stats])
    assert plan.smem == _smem(plan.store, plan.cluster)
    assert plan.smem == attention.flash_wgmma_smem(plan.store, plan.cluster)
    assert plan.smem <= _build.MAX_DYNAMIC_SMEM  # one block an SM, in every form
    if plan.store:  # a warpgroup's consumers' stored s fits, and so the first's P.V partial
        ways = 2 if plan.cluster else 1
        kept = 1024 // 64 // (4 * ways)  # chunks of s a warpgroup stores
        consumers = plan.col_split // (4 * ways)  # consumers a warpgroup runs
        assert -(-(-(-block_k // 64)) // plan.col_split) * consumers <= kept
        assert kept // consumers * TILE >= 64 * 64 * 4


@pytest.mark.parametrize("stats", list(STATS))
@pytest.mark.parametrize("block_k", [64, 120, 512, 960, 1000, 1024, 1088, 2048])
def test_stored_s_or_recompute(block_k, stats):
    """Pass 1 keeps its rounded s for pass 2 only at bf16 stats (the
    contract rounds s there, so reading it back is exact) and only while a
    consumer's chunks of the tile fit (block_k <= 1024); fp32 stats and
    longer tiles recompute S. Either way the block fits the SM."""
    nk = block_k * 2
    plan = attention.flash_plan(1, 4, nk, block_k, BF16, STATS[stats])
    assert plan.store == (stats == "bf16 stats" and block_k <= 1024)
    assert plan.smem == _smem(plan.store, plan.cluster) <= _build.MAX_DYNAMIC_SMEM
    # the fp32 kernel never stores (a split of 8 is its cluster form), and
    # its block does not grow with block_k
    fp32 = attention.flash_plan(1, 4, nk, block_k, torch.float32, STATS[stats])
    assert not fp32.store and fp32.cluster == (fp32.col_split == 8)
    assert fp32.smem == attention.flash_plan(1, 4, nk, 64, torch.float32).smem


@pytest.mark.parametrize("heads,nq", [(4, 2048), (4, 1024), (4, 960), (4, 512), (4, 120),
                                      (2, 2048), (1, 2048), (8, 1024), (4, 1088)])
def test_split_and_form(heads, nq):
    """The split reads one batch entry's shape: 8 where its tiles, two blocks
    each, fit the card's SMs, else 4; the batch picks the form only:
    clusters of two blocks while the launch's blocks fit the SMs (a split
    of 4 is always one block a tile)."""
    tiles = heads * -(-nq // 64)
    split = attention.flash_split(heads, nq)
    assert split == (8 if 2 * tiles <= SMS else 4)
    for batch in (1, 2, 4, 8):
        plan = attention.flash_plan(batch, heads, nq, min(nq, 1024))
        assert plan.col_split == split
        assert plan.cluster == (split == 8 and 2 * batch * tiles <= SMS)
        assert plan.blocks == batch * tiles * (2 if plan.cluster else 1)


def _meta(numel):
    return torch.empty(numel, dtype=BF16, device="meta")


def _fused_operands(case):
    """(q, k, v) in the (B, N, H*64) layout as fused_mha takes them: column
    slices of one projection, or one of them off."""
    flat = _meta(2 * 128 * 776 + 8)
    if case == "base 8 B off":
        qkv = flat[4:4 + 2 * 128 * 768].view(2, 128, 768)
    elif case == "row stride off 16 B":
        qkv = flat[:2 * 128 * 772].view(2, 128, 772)
    else:  # batch stride off 16 B
        qkv = flat[:2 * 128 * 768 + 4].as_strided((2, 128, 768), (128 * 768 + 4, 768, 1))
    return qkv[..., :256], qkv[..., 256:512], qkv[..., 512:768]


def _heads_operands(case):
    """(q, k, v) in the (B, H, N, 64) layout, one of them off."""
    flat = _meta(2 * 4 * 128 * 72 + 8)
    good = flat[:2 * 4 * 128 * 64].view(2, 4, 128, 64)
    if case == "base 8 B off":
        bad = flat[4:4 + 2 * 4 * 128 * 64].view(2, 4, 128, 64)
    elif case == "row stride off 16 B":
        bad = flat[:2 * 4 * 128 * 72].as_strided((2, 4, 128, 64), (4 * 128 * 72, 128 * 72, 68, 1))
    else:  # head stride off 16 B
        bad = flat[:2 * 4 * 128 * 72].as_strided((2, 4, 128, 64), (4 * 128 * 68, 128 * 68 - 4, 64,
                                                                     1))
    return good, bad, good


CASES = ["base 8 B off", "row stride off 16 B", "batch or head stride off 16 B"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kernel", ["fused_mha", "flash_attention", "flash_attention_step"])
def test_tma_refuses_operands_off_16_bytes(kernel, case):
    """The bf16 kernel reads q, k and v through TMA, which needs 16 B bases
    and strides: each wrapper raises a ValueError on any other operand
    before a launch, and never routes it elsewhere."""
    with pytest.raises(ValueError, match="TMA"):
        if kernel == "fused_mha":
            attention.fused_mha(*_fused_operands(case), num_heads=4)
        elif kernel == "flash_attention":
            attention.flash_attention(*_heads_operands(case))
        else:
            q, k, v = _heads_operands(case)
            m = torch.empty(2, 4, 128, 1, device="meta")
            acc = torch.empty(2, 4, 128, 64, device="meta")
            attention.flash_attention_step(q, k, v, m, m.clone(), acc)


def test_tma_check_passes_the_routes_layouts():
    """The layouts the routes give the kernel pass the check: qkv and [qk |
    v] column slices (row strides 3E, 2E), the rotated scratch, the ring's
    (B, H, N, 64) views of a (B, N, H*64) projection and its stripes, and
    contiguous heads."""
    e = 256
    qkv = _meta(2 * 2048 * 3 * e).view(2, 2048, 3 * e)
    kv = _meta(2048 * 2 * e).view(1, 2048, 2 * e)
    heads = _meta(2 * 4 * 2048 * 64).view(2, 4, 2048, 64)
    ring = qkv[..., :e].reshape(2, 2048, 4, 64).transpose(1, 2)  # (B, H, N, 64), hs < rs
    attention._check_tma_rows("f", qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:],
                              kv[..., :e], kv[..., e:], heads, ring, ring[:, :, 512:1024],
                              heads[:1, :1])
