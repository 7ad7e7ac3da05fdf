"""The bf16 tensor-core kernels of csrc/bidir_cross.cu and csrc/conv3x3.cu on
the CPU: the launch plan of the bidirectional kernel (its fp32 kernel's
too) at the shapes the paths and chip_smoke.py give it, its wrapper's
refusal of operands TMA cannot address, and the premises of chip_smoke.py's
rounding witnesses for both kernels."""

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


SMS = 132  # the card's SMs, which a launch's clusters of two blocks a tile must fit


def _bf16_smem(store, cluster):
    """A bf16 attention tile's block, bytes, counted the way
    csrc/attention_tile.cuh:Smem lays it out: Q (64 x 64 bf16); four
    warpgroups' regions, each two ring slots (K, then V, where s is kept;
    K and V where pass 2 recomputes S), then the warpgroup's chunks of kept
    s (1024 keys over eight consumers) or, in one block, room for its first
    consumer's 64 x 64 fp32 partial; row max and sum p per warpgroup; the
    block's row max; 17 barriers; 1 KB of alignment."""
    tile = 64 * 64 * 2
    virt = 1 if cluster else 2
    extra = 16 // 8 * virt * tile if store else (0 if cluster else 64 * 64 * 4)
    region = 2 * (tile if store else 2 * tile) + extra
    return tile + 4 * region + 2 * 4 * 64 * 4 + 64 * 4 + 17 * 8 + 1024


# (batch, n0, n1, heads): the pad-to-64 path's 960 cap, its mixed buckets,
# two pairs, the TP shards' heads, and sizes past the 1024 keys whose s
# pass 1 keeps (the wrapper's contract: any N fits)
BIDIR_PLANS = {
    "960x960": (1, 960, 960, 4),
    "960x704": (1, 960, 704, 4),
    "960x64 mixed buckets": (1, 960, 64, 4),
    "two pairs 960x960": (2, 960, 960, 4),
    "960x960 at H = 2": (1, 960, 960, 2),
    "960x960 at H = 1": (1, 960, 960, 1),
    "4096x4096": (1, 4096, 4096, 4),
    "1280x64, one side past 1024 keys": (1, 1280, 64, 4),
}


@pytest.mark.parametrize("shape", list(BIDIR_PLANS))
def test_bidir_plan_fits(shape):
    """bidir_plan's bf16 launch is the rule of csrc/bidir_cross.cu:bidir_plan,
    computed here: both directions' 64-row tiles a head, eight consumers
    splitting each row's chunks, a cluster of two blocks a tile while the
    launch's blocks fit the card's 132 SMs, else one block (the same sums:
    the batch may pick the form, and the split is one pair's at B = 1, 2, 4
    and 8); at bf16 stats pass 1 keeps s while both sides have at most 1024
    rows, else pass 2 recomputes S; shared memory as the tile lays it out,
    whatever N, one block an SM. The fp32 launch: split 8 as a cluster where
    one pair's tiles, two blocks each, fit the SMs, else 4 in one block."""
    b, n0, n1, h = BIDIR_PLANS[shape]
    tiles = -(-n0 // 64) + -(-n1 // 64)
    for batch in (1, 2, 4, 8):
        bb = batch * b
        cluster = 2 * bb * h * tiles <= SMS
        for sdt in (torch.bfloat16, torch.float32):
            store = sdt == torch.bfloat16 and max(n0, n1) <= 1024
            plan = attention.bidir_plan(bb, h, n0, n1, torch.bfloat16, sdt)
            assert plan.kernel == "bidir_wgmma_kernel"
            assert (plan.row_groups, plan.col_split, plan.cluster, plan.store) == (
                4, 8, cluster, store)
            assert plan.blocks == bb * h * tiles * (2 if cluster else 1)
            assert plan.smem == _bf16_smem(store, cluster) == layer_stack.wgmma_attention_smem(
                store, cluster) <= _build.MAX_DYNAMIC_SMEM
        split = 8 if 2 * h * tiles <= SMS else 4  # one pair's tiles, never the batch
        fp32 = attention.bidir_plan(bb, h, n0, n1, torch.float32)
        assert (fp32.kernel, fp32.col_split, fp32.cluster) == ("bidir_tf32_wgmma_kernel", split,
                                                               split == 8)
        assert fp32.blocks == bb * h * tiles * (2 if split == 8 else 1)
        assert fp32.smem == layer_stack.wgmma_tf32_attention_smem() <= _build.MAX_DYNAMIC_SMEM


def test_bidir_plan_refuses_the_fp32_slab_past_shared_memory():
    """No plan keeps a slab that grows with N: at 4096 x 64, where the FMA
    kernel's 16 x 4096 slab exceeded shared memory, and at any N the fp32
    block is the fp32 tile's (its one-slot rings stream the keys) and the
    bf16 block the tile's at its form; past 1024 keys on either side the
    bf16 kernel recomputes S at bf16 stats instead of keeping s, so its
    block does not grow either."""
    fp32 = layer_stack.wgmma_tf32_attention_smem()
    for n0 in (64, 1024, 4096, 16384):
        plan = attention.bidir_plan(1, 4, n0, 64, torch.float32)
        assert plan.smem == fp32 <= _build.MAX_DYNAMIC_SMEM
        bf16 = attention.bidir_plan(1, 4, n0, 64, torch.bfloat16)
        assert bf16.store == (n0 <= 1024)
        assert bf16.smem == layer_stack.wgmma_attention_smem(bf16.store, bf16.cluster)
        assert bf16.smem <= _build.MAX_DYNAMIC_SMEM
    assert attention.bidir_plan(1, 4, 4096, 64, torch.float32).blocks == 4 * (64 + 1)


def _meta(numel, dtype=BF16):
    return torch.empty(numel, dtype=dtype, device="meta")


@pytest.mark.parametrize("operand", ["qk0", "qk1", "v0", "v1"])
def test_bidir_refuses_operands_off_16_bytes(operand, monkeypatch):
    """Both kernels read qk0, qk1, v0 and v1 through TMA, which needs 16 B
    bases and strides: the card's wrapper raises a ValueError on any other
    operand before a launch (meta tensors carry the offsets; the library is
    never reached), for either operand dtype, and passes the routes' [qk |
    v] column slices."""
    monkeypatch.setattr(_build, "lib", lambda: pytest.fail("a launch was reached"))
    for dt in (BF16, torch.float32):
        e = 256
        sides = {"0": _meta(2 * 960 * 2 * e + 8, dt)[:2 * 960 * 2 * e].view(2, 960, 2 * e),
                 "1": _meta(2 * 704 * 2 * e + 8, dt)[:2 * 704 * 2 * e].view(2, 704, 2 * e)}
        ops = {f"qk{i}": t[..., :e] for i, t in sides.items()}
        ops.update({f"v{i}": t[..., e:] for i, t in sides.items()})
        attention._check_tma_rows("f", *ops.values())  # the routes' slices pass
        flat = _meta(2 * 960 * 2 * e + 8, dt)
        side = operand[-1]
        n = 960 if side == "0" else 704
        off = flat[4:4 + 2 * n * 2 * e].view(2, n, 2 * e)  # 8 B (bf16) or 16 B past a 16 B base
        ops[operand] = off[..., :e] if operand.startswith("qk") else off[..., e:]
        if dt == torch.float32:  # 16 B off is on 16 B: a row stride of 2E + 2 floats is not
            rows = _meta(2 * n * (2 * e + 2), dt).view(2, n, 2 * e + 2)
            ops[operand] = rows[..., :e] if operand.startswith("qk") else rows[..., e:2 * e]
        with pytest.raises(ValueError, match="TMA"):
            attention.bidirectional_cross_attention(*ops.values(), num_heads=4)


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
