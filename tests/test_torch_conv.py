"""Port conv3x3 (plain version on the CPU) against the JAX conv3x3_paired
variants the model calls and against superpoint._relu_conv."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.kernels import conv as jax_conv
from lightglue_tpu.models import superpoint as jax_sp
from lightglue_tpu_torch.kernels import conv

# fp32: both sides accumulate in fp32, in another order; bf16: one bf16
# rounding of the output, so a flipped rounding is at most one bf16 ulp
TOL = {"fp32": 1e-5, "bf16": 2e-2}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, b=1, h=16, w=32):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (b, h, w, 64)).astype(np.float32)
    wt = rng.uniform(-1 / 24, 1 / 24, (3, 3, 64, 64)).astype(np.float32)
    bias = rng.uniform(-1 / 24, 1 / 24, (64,)).astype(np.float32)
    return x, wt, bias


def _jax_variant(variant, x, w, b):
    bsz, h, wd, _ = x.shape
    if variant == "conv1b offset+pool":
        return jax_conv.conv3x3_paired(x, w, b, pool=True, offset=True)
    if variant == "conv2a offset, paired out":
        out = jax_conv.conv3x3_paired(x, w, b, offset=True, out_paired=True)
        return out.reshape(bsz, h, wd, 64)
    if variant == "conv2b paired in + pool":
        return jax_conv.conv3x3_paired(
            x.reshape(bsz, h, wd // 2, 128), w, b, x_paired=True, pool=True
        )
    return jax_sp._relu_conv({"w": w, "b": b}, x, pool=variant.endswith("pool"))


VARIANTS = ["conv1b offset+pool", "conv2a offset, paired out", "conv2b paired in + pool",
            "_relu_conv", "_relu_conv + pool"]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_conv3x3_matches_jax(variant, dtype):
    jdt, tdt = DTYPES[dtype]
    x, w, b = _inputs(VARIANTS.index(variant))
    xj = jnp.asarray(x, jdt)
    want = np.asarray(_jax_variant(variant, xj, jnp.asarray(w), jnp.asarray(b)), np.float32)
    pool = "pool" in variant
    got = conv.conv3x3(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt), torch.from_numpy(b), pool=pool
    )
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype], rtol=0)


def test_conv3x3_cpu_launches_nothing():
    x, w, b = _inputs(0)
    before = conv.conv3x3.launches
    conv.conv3x3(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert conv.conv3x3.launches == before  # the plain version ran


@pytest.mark.parametrize(
    "x_shape,w_shape,pool",
    [((1, 8, 16, 32), (3, 3, 32, 32), False),  # not 64 channels
     ((1, 9, 16, 64), (3, 3, 64, 64), True)],  # odd H with pool
)
def test_conv3x3_rejects_malformed_operands_before_launch(x_shape, w_shape, pool):
    # meta tensors take the kernel branch without a card; the checks run first
    x = torch.empty(x_shape, device="meta")
    w = torch.empty(w_shape, device="meta")
    with pytest.raises(ValueError):
        conv.conv3x3(x, w, torch.empty(w_shape[-1], device="meta"), pool=pool)
