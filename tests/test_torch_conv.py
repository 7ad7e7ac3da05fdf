"""Port conv3x3 (plain version on the CPU) against the JAX conv3x3_paired
variants the model calls, against superpoint._relu_conv and against the
generic JAX conv3x3; and conv2_chain against the JAX conv2_chain."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.kernels import conv as jax_conv
from lightglue_tpu.kernels import conv_chain as jax_chain
from lightglue_tpu.models import superpoint as jax_sp
from lightglue_tpu_torch.kernels import conv, conv_chain

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
    [((1, 8, 16, 12), (3, 3, 12, 12), False),  # channels not a multiple of 8
     ((1, 9, 16, 64), (3, 3, 64, 64), True)],  # odd H with pool
)
def test_conv3x3_rejects_malformed_operands_before_launch(x_shape, w_shape, pool):
    # meta tensors take the kernel branch without a card; the checks run first
    x = torch.empty(x_shape, device="meta")
    w = torch.empty(w_shape, device="meta")
    with pytest.raises(ValueError):
        conv.conv3x3(x, w, torch.empty(w_shape[-1], device="meta"), pool=pool)


# the generic conv: test_superpoint.py:138-180's shape, values up to ~8, so
# bf16 is held to an ulp relative to the value as well
GENERIC_TOL = {"fp32": dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=2e-2, rtol=2e-2)}
OTHER = {"fp32": "bf16", "bf16": "fp32"}
GENERIC_CASES = {
    # label: relu, pool, out dtype the other one of the pair
    "relu": (True, False, False),
    "relu + pool": (True, True, False),
    "no relu": (False, False, False),
    "relu + pool, other out_dtype": (True, True, True),
}


def _generic_inputs(seed, b=2, h=16, w=32, cin=8, cout=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, cin), dtype=np.float32),
            (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32),
            rng.standard_normal(cout).astype(np.float32))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(GENERIC_CASES))
def test_generic_conv3x3_matches_jax(case, dtype):
    relu, pool, other = GENERIC_CASES[case]
    out = OTHER[dtype] if other else dtype
    x, w, b = _generic_inputs(3)
    want = jax_conv.conv3x3(jnp.asarray(x, DTYPES[dtype][0]), jnp.asarray(w, DTYPES[dtype][0]),
                            jnp.asarray(b), relu=relu, pool=pool, out_dtype=DTYPES[out][0])
    got = conv.conv3x3(torch.from_numpy(x).to(DTYPES[dtype][1]),
                       torch.from_numpy(w).to(DTYPES[dtype][1]), torch.from_numpy(b), pool,
                       relu=relu, out_dtype=DTYPES[out][1])
    assert got.dtype == DTYPES[out][1] and got.shape == want.shape
    tol = GENERIC_TOL["bf16" if "bf16" in (dtype, out) else "fp32"]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_supports_matches_jax():
    shapes = [(480, 640, 64, 64), (120, 160, 64, 128), (60, 80, 128, 256), (16, 32, 8, 16),
              (15, 32, 8, 16), (16, 36, 8, 16), (16, 32, 12, 16), (2, 8, 8, 8), (4000, 4000, 512, 8)]
    for dt in ("fp32", "bf16"):
        for shape in shapes:
            assert conv.supports(*shape, DTYPES[dt][1]) == jax_conv.supports(*shape,
                                                                             DTYPES[dt][0]), shape


def _chain_inputs(seed=9):
    # test_superpoint.py:255-277's inputs
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 32, 64, 64)).astype(np.float32)
    wa = (rng.standard_normal((3, 3, 64, 64)) * 0.1).astype(np.float32)
    ba = rng.standard_normal(64).astype(np.float32)
    wb = (rng.standard_normal((3, 3, 64, 64)) * 0.1).astype(np.float32)
    bb = rng.standard_normal(64).astype(np.float32)
    return x, wa, ba, wb, bb


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no relu"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_conv2_chain_matches_jax(dtype, relu):
    x, wa, ba, wb, bb = _chain_inputs()
    jdt, tdt = DTYPES[dtype]
    want = jax_chain.conv2_chain(jnp.asarray(x, jdt), jnp.asarray(wa, jdt), jnp.asarray(ba),
                                 jnp.asarray(wb, jdt), jnp.asarray(bb), relu=relu)
    tx, twa, twb = (torch.from_numpy(t).to(tdt) for t in (x, wa, wb))
    got = conv_chain.conv2_chain(tx, twa, torch.from_numpy(ba), twb, torch.from_numpy(bb),
                                 relu=relu)
    assert got.dtype == tdt and got.shape == (2, 16, 32, 64)
    # fp32: two frameworks' fp32 sums (values up to ~20). bf16: a flipped
    # rounding of the bf16 intermediate moves an output by a few hundredths,
    # and the output's own rounding is an ulp (measured: 0.0625, one ulp at 8-16)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "fp32" else dict(atol=5e-2, rtol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    # the port's own two-launch chain is the plain version, bit for bit on the CPU
    two = conv.conv3x3(conv.conv3x3(tx, twa, torch.from_numpy(ba)), twb, torch.from_numpy(bb),
                       True, relu=relu)
    assert torch.equal(got, two)


def test_conv2_chain_out_dtype_and_cpu_launches_nothing():
    x, wa, ba, wb, bb = (torch.from_numpy(t) for t in _chain_inputs())
    before = conv_chain.conv2_chain.launches
    got = conv_chain.conv2_chain(x, wa, ba, wb, bb, out_dtype=torch.bfloat16)
    assert conv_chain.conv2_chain.launches == before  # the plain version ran
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, conv_chain.conv2_chain(x, wa, ba, wb, bb).to(torch.bfloat16))


@pytest.mark.parametrize(
    "x_shape,w_shape",
    [((1, 8, 16, 32), (3, 3, 32, 32)), ((1, 9, 16, 64), (3, 3, 64, 64))],
    ids=["not 64 channels", "odd H"],
)
def test_conv2_chain_rejects_malformed_operands_before_launch(x_shape, w_shape):
    x, w = torch.empty(x_shape, device="meta"), torch.empty(w_shape, device="meta")
    b = torch.empty(w_shape[-1], device="meta")
    with pytest.raises(ValueError):
        conv_chain.conv2_chain(x, w, b, w, b)
