"""Port conv1a tap stem (plain version on the CPU) against the JAX package's
``_relu_conv1a_shift``, and the wrapper's checks before any launch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.models import superpoint as jax_sp
from lightglue_tpu_torch.kernels import stem

# Tolerance: none. Both sum the nine rounded products in the same order in
# fp32, add the bias and round once to the dtype, and XLA on the CPU keeps
# each product and its add apart (no FMA), so the outputs agree bit for bit.
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed, b, h, w):
    rng = np.random.default_rng(seed)
    x = rng.random((b, h, w, 1)).astype(np.float32)
    wt = (rng.uniform(-1, 1, (3, 3, 1, stem.C_OUT)) / 3).astype(np.float32)
    bias = rng.uniform(-0.25, 0.25, stem.C_OUT).astype(np.float32)
    return x, wt, bias


@pytest.mark.parametrize("tag", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 16, 24), (2, 24, 40)])
def test_relu_conv1a_shift_matches_jax(shape, tag):
    tdt, jdt = DTYPES[tag]
    x, wt, bias = _inputs(sum(shape), *shape)
    # the tree is cast to the activation dtype, as the sessions cast it
    want = jax_sp._relu_conv1a_shift(
        {"w": jnp.asarray(wt).astype(jdt), "b": jnp.asarray(bias).astype(jdt)},
        jnp.asarray(x).astype(jdt))
    got = stem.relu_conv1a_shift(torch.from_numpy(x).to(tdt), torch.from_numpy(wt).to(tdt),
                                 torch.from_numpy(bias).to(tdt))
    assert got.dtype == tdt and got.shape == (*shape, stem.C_OUT)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_cpu_path_counts_no_launch():
    x, wt, bias = _inputs(3, 1, 16, 16)
    stem.relu_conv1a_shift.launches = 0
    stem.relu_conv1a_shift(*(torch.from_numpy(a) for a in (x, wt, bias)))
    assert stem.relu_conv1a_shift.launches == 0


@pytest.mark.parametrize("image,w,b", [
    ((1, 16, 16, 2), (3, 3, 1, 64), (64,)),   # two channels
    ((1, 12, 16, 1), (3, 3, 1, 64), (64,)),   # H not a multiple of 8
    ((1, 16, 20, 1), (3, 3, 1, 64), (64,)),   # W not a multiple of 8
    ((1, 16, 16, 1), (3, 3, 1, 32), (32,)),   # not conv1a's 64 channels
    ((1, 16, 16, 1), (3, 3, 1, 64), (32,)),   # bias of another width
], ids=["channels", "height", "width", "weights", "bias"])
def test_malformed_stem_raises_before_launch(image, w, b):
    # a meta tensor takes the kernel branch without a card; the checks run first
    args = [torch.empty(s, device="meta") for s in (image, w, b)]
    before = stem.relu_conv1a_shift.launches
    with pytest.raises(ValueError):
        stem.relu_conv1a_shift(*args)
    assert stem.relu_conv1a_shift.launches == before
