"""A pair's result is a function of that pair, its bucket pair and its full
flag only: never of the batch it runs in (JAX tests/test_e2e.py:163).

On the card the attention kernels' warps split each 64-key chunk and their
partial sums meet in shared memory, so the split sets the order of a row's
fp32 sums. The launch plans below must take that split from one pair's
shape at every batch (they may only add blocks); ``chip_smoke.py:
batch_invariance`` holds the kernels themselves to it on the card. On the
CPU the session runs the plain versions, and ``match_batch`` must give each
pair ``match_pair``'s arrays bit for bit."""

import numpy as np
import pytest
import torch

from lightglue_tpu_torch.config import LightGlueConfig, PipelineConfig, SuperPointConfig
from lightglue_tpu_torch.kernels import attention, layer_stack
from lightglue_tpu_torch.precision import Precision
from lightglue_tpu_torch.runtime import weights
from lightglue_tpu_torch.runtime.session import MatcherSession

from test_torch_superpoint import smooth_images

HEADS = 4
BATCHES = (2, 4, 8)
# the routes' query lengths: the stack's and pad-to-64's buckets, 2048
SEQS = [*range(64, 1025, 64), 2048]
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _split_at_every_batch(plan_of):
    one = plan_of(1).col_split
    assert [plan_of(b).col_split for b in BATCHES] == [one] * len(BATCHES)
    for b in BATCHES:  # a larger batch adds blocks, one pair's worth each
        assert plan_of(b).blocks % b == 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [n for n in SEQS if n <= layer_stack.MAX_SEQ])
def test_stack_attention_split_is_the_pairs(n, dtype):
    _split_at_every_batch(lambda b: layer_stack.attention_plan(b, HEADS, n, n, DTYPES[dtype]))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", SEQS + [(960, 704), (960, 64)],
                         ids=lambda n: f"{n[0]}x{n[1]}" if isinstance(n, tuple) else str(n))
def test_bidirectional_split_is_the_pairs(n, dtype):
    n0, n1 = n if isinstance(n, tuple) else (n, n)
    _split_at_every_batch(lambda b: attention.bidir_plan(b, HEADS, n0, n1, DTYPES[dtype]))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,block_k", [(n, min(n, attention.DEFAULT_BLOCK_K)) for n in SEQS]
                         + [(512, 512)], ids=lambda v: str(v))
def test_flash_split_is_the_pairs(n, block_k, dtype):
    """``fused_mha`` and ``flash_attention`` at the routes' shapes, and the
    ring step at its 512-row stripes (block_k 512)."""
    _split_at_every_batch(lambda b: attention.flash_plan(b, HEADS, n, block_k, DTYPES[dtype]))


def test_stack_blocks_keep_the_pairs_split():
    """Both stack attention kernels keep one pair's split at every batch:
    64 rows, eight consumers splitting each row's keys, the bf16 one in a
    cluster of two blocks or in one block (the same sums), the fp32 one
    always in a cluster (its form, like its split, from one pair's shape);
    the batch only adds blocks. The bf16 projection keeps its tile (one
    pair's rows)."""
    for dtype, form in ((torch.float32, (2, 2, 2)), (torch.bfloat16, (2, 2, 1))):
        plans = [layer_stack.attention_plan(b, HEADS, 512, 512, dtype) for b in (1, 2, 4)]
        assert [p[:2] for p in plans] == [(4, 8)] * 3
        assert [p.blocks // (b * HEADS * 8) for b, p in zip((1, 2, 4), plans)] == list(form)
    tiles = [layer_stack.linear_plan(b * 512, 256, 256, rows=512)[:2] for b in BATCHES]
    assert tiles == [layer_stack.linear_plan(512, 256, 256)[:2]] * len(BATCHES)


MODES = {"fixed": {}, "depth-only": dict(depth_confidence=0.95),
         "width": dict(depth_confidence=0.95, width_confidence=0.99)}


@pytest.mark.parametrize("mode", list(MODES))
def test_match_batch_rows_are_match_pair_bit_for_bit(mode):
    """Four distinct pairs at one bucket pair: each ``match_batch`` row
    equals that pair's ``match_pair`` in every array, bit for bit
    (threshold 0, so the matches are every mutual nearest neighbour; random
    weights leave few), and the LightGlue output behind it, whose log
    assignment holds every score, equals its row of the four's."""
    cfg = PipelineConfig(superpoint=SuperPointConfig(max_num_keypoints=256),
                         lightglue=LightGlueConfig(n_layers=2, **MODES[mode]),
                         precision=Precision.FP32, buckets=(128, 256), match_threshold=0.0,
                         max_matches=256)
    session = MatcherSession(weights.init_superpoint(31), weights.init_lightglue(32, cfg.lightglue),
                             config=cfg, device="cpu")
    imgs = smooth_images(9, 4, 112, 152)  # each pair: a field and a shifted crop of it
    images0, images1 = imgs[:, :96, :128], imgs[:, 16:112, 24:152]
    batch = session.match_batch(images0, images1)
    buckets = {tuple(cfg.bucket_for(r[f"num_keypoints{k}"]) for k in (0, 1)) for r in batch}
    assert len(buckets) == 1, buckets
    for i, row in enumerate(batch):
        single = session.match_pair(images0[i], images1[i])
        assert len(row["matches"]) >= 1
        for key, value in row.items():
            np.testing.assert_array_equal(value, single[key], err_msg=f"pair {i} {key}")
            assert np.asarray(value).dtype == np.asarray(single[key]).dtype, key
    ext = session.extract(np.concatenate([images0, images1]))
    together = session.match_from_extractions(ext.slice(0, 4), ext.slice(4, 8))
    for i in range(4):
        alone = session.match_from_extractions(ext.slice(i, i + 1), ext.slice(4 + i, 5 + i))
        for name, got, want in zip(alone[0]._fields + alone[1]._fields, (*alone[0], *alone[1]),
                                   (*together[0], *together[1])):
            want = want if want.dim() == 0 else want[i:i + 1]
            assert torch.equal(got, want), f"pair {i} {name}"
