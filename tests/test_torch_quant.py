"""Port quant.py against the JAX quant.py (numpy in, numpy out, bit for bit),
the int8 tree through runtime/weights.py:params_from_numpy, and the plain
versions of the stack GEMM's int8 modes against a numpy transcription of
JAX ``_take_linear`` / ``_aquant`` / ``_doti8`` / ``_linear``."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lightglue_tpu import quant as jax_quant
from lightglue_tpu.config import LightGlueConfig as JLGC
from lightglue_tpu.runtime import weights as jax_weights
from lightglue_tpu_torch import quant
from lightglue_tpu_torch.kernels import layer_stack
from lightglue_tpu_torch.models.lightglue import _weight
from lightglue_tpu_torch.runtime import weights

BF16 = ml_dtypes.bfloat16


@pytest.mark.parametrize("shape", [(256, 512), (3, 3, 64, 64), (2, 256, 1)],
                         ids=["linear", "stacked components", "one output"])
def test_quantize_weight_is_the_jax_function(shape):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    w[..., :1] = 0.0  # an all-zero output channel takes scale 1
    got, want = quant.quantize_weight(w), jax_quant.quantize_weight(w)
    for key in ("w_q", "scale"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_dequantize_is_the_jax_function(dtype):
    q = jax_quant.quantize_weight(np.random.default_rng(1).standard_normal((4, 64, 96)))
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    got = quant.dequantize(q, tdt)
    want = np.asarray(jax_quant.dequantize({k: jnp.asarray(v) for k, v in q.items()}, jdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_quantize_lightglue_is_the_jax_function():
    tree = jax_weights.init_lightglue(0, JLGC(n_layers=2))
    got, want = dict(_leaves(quant.quantize_lightglue(tree))), dict(_leaves(
        jax_quant.quantize_lightglue(tree)))
    assert got.keys() == want.keys()
    for key in want:
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg="/".join(key))
    quantized = {k[:-1] for k in want if k[-1] == "w_q"}
    assert len(quantized) == 10  # 4 self + 5 cross linears and the match head's proj
    for path in quantized:
        node = quant.quantize_lightglue(tree)
        for k in path:
            node = node[k]
        assert quant.is_quantized(node) and jax_quant.is_quantized(node)
    assert not quant.is_quantized(tree["layers"]["self_attn"]["qkv"])


def test_int8_tree_layout_dequantizes_to_the_float_layout():
    """The port's int8 tree (``params_from_numpy``), dequantized in fp32 by
    the models' ``_weight``, equals the port layout of JAX's dequantized
    tree exactly: w_q and scale take the qkv and [qk | v] layout changes w
    takes, and everything that is not a linear weight stays fp32."""
    tree = jax_weights.init_lightglue(0, JLGC(n_layers=2))
    qtree = jax_quant.quantize_lightglue(tree)

    def dequantized(node):
        if jax_quant.is_quantized(node):
            return {"w": np.asarray(jax_quant.dequantize(node, jnp.float32)), "b": node["b"]}
        return {k: dequantized(v) if isinstance(v, dict) else v for k, v in node.items()}

    got = weights.params_from_numpy(quant.quantize_lightglue(tree))
    want = weights.params_from_numpy(dequantized(qtree))
    nodes = 0

    def walk(g, w, path):
        nonlocal nodes
        if "w_q" in g:
            nodes += 1
            assert g["w_q"].dtype == torch.int8 and g["scale"].dtype == torch.float32
            assert g["scale"].shape == g["b"].shape, path
            torch.testing.assert_close(_weight(g, torch.float32), w["w"], rtol=0, atol=0)
            torch.testing.assert_close(g["b"], w["b"], rtol=0, atol=0)
            return
        for k in w:
            if isinstance(w[k], dict):
                walk(g[k], w[k], path + (k,))
            else:
                assert g[k].dtype == torch.float32, path + (k,)
                torch.testing.assert_close(g[k], w[k], rtol=0, atol=0)

    walk(got, want, ())
    assert nodes == 9  # 4 self, 4 cross ([qk | v] fused) and proj


# ---------------------------------------------------------------------------
# the plain versions of the stack GEMM's int8 modes
# ---------------------------------------------------------------------------


def _bf16(x):
    return np.asarray(x, np.float32).astype(BF16).astype(np.float32)


def _aquant(v):
    """JAX _aquant (layer_stack.py:339-346) in numpy fp32."""
    vf = np.asarray(v, np.float32)
    amax = np.max(np.abs(vf), axis=-1, keepdims=True)
    sa = np.maximum(amax, np.float32(1e-6)) * np.float32(1.0 / 127.0)
    return np.clip(np.round(vf / sa), -127, 127).astype(np.int8), sa


def _operands(seed, m=96, k1=256, k2=256, n=256):
    rng = np.random.default_rng(seed)
    a = _bf16(rng.standard_normal((m, k1)))
    a2 = _bf16(rng.standard_normal((m, k2)))
    q = jax_quant.quantize_weight(rng.standard_normal((k1 + k2, n)) / 16)
    b = (rng.standard_normal(n) / 16).astype(np.float32)
    res = _bf16(rng.standard_normal((m, n)))
    return a, a2, q, b, res


def _torch(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def test_row_quant_plain_is_jax_aquant():
    a, a2, *_ = _operands(3)
    a[5] = 0.0  # an all-zero row: amax clamps at 1e-6
    q, sa = layer_stack.row_quant_plain(_torch(a), _torch(a2))
    want_q, want_sa = _aquant(np.concatenate([a, a2], -1))
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_array_equal(sa.numpy(), want_sa[:, 0])


def test_linear_plain_w8a8_is_jax_q8_linear_exactly():
    """JAX _linear's q8 branch (:368-372) on [x | message] with the residual
    in bf16 (:399): y = (float(int32 sum) * sa) * scale, rounded to bf16, +
    bias in bf16, + residual in bf16. The int32 sum is below 2^24, so the
    plain version's fp32 product of integers is exact and the two agree bit
    for bit."""
    a, a2, q, b, res = _operands(4)
    xq, sa = _aquant(np.concatenate([a, a2], -1))
    acc = xq.astype(np.int64) @ q["w_q"].astype(np.int64)
    assert np.abs(acc).max() < 2 ** 24
    y = _bf16(acc.astype(np.float32) * sa * q["scale"][0])
    want = _bf16(_bf16(y + _bf16(b)) + res)
    got = layer_stack.linear_plain(_torch(a), torch.from_numpy(q["w_q"]), torch.from_numpy(b),
                                   _torch(a2), _torch(res), scale=torch.from_numpy(q["scale"][0]),
                                   w8a8=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_linear_plain_int8_weights_is_jax_take_linear():
    """Weight-only INT8 (``_take_linear`` :245-249, then ``_linear``
    :373-375): bf16(w_q * scale) products summed in fp32, rounded to bf16,
    + the fp32 bias rounded to bf16. fp32 sums in another order: a rounding
    may flip by one bf16 ulp."""
    a, a2, q, b, _ = _operands(5, k2=0)
    w = _bf16(q["w_q"].astype(np.float32) * q["scale"])
    want = _bf16(_bf16(a.astype(np.float64) @ w.astype(np.float64)) + _bf16(b))
    got = layer_stack.linear_plain(_torch(a), torch.from_numpy(q["w_q"]), torch.from_numpy(b),
                                   scale=torch.from_numpy(q["scale"][0]))
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 ** -7 * 4, rtol=2 ** -7)
    assert np.mean(got.float().numpy() != want) < 0.01


def test_linear_plain_mixed_is_jax_linear():
    """MIXED (``_linear`` :373-375 with dt fp32, attn_dtype bf16): bf16
    operands, fp32 sums and result, + fp32 bias, + fp32 residual; the qkv
    projection's bf16 output is that result rounded once."""
    rng = np.random.default_rng(6)
    a, a2 = rng.standard_normal((2, 64, 256)).astype(np.float32)
    w = (rng.standard_normal((512, 256)) / 16).astype(np.float32)
    b, = rng.standard_normal((1, 256)).astype(np.float32) / 16
    res = rng.standard_normal((64, 256)).astype(np.float32)
    x = _bf16(np.concatenate([a, a2], -1)).astype(np.float64)
    y = (x @ _bf16(w).astype(np.float64)).astype(np.float32) + b
    got = layer_stack.linear_plain(torch.from_numpy(a), _torch(w), torch.from_numpy(b),
                                   torch.from_numpy(a2), torch.from_numpy(res))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), y + res, atol=1e-5, rtol=1e-5)
    out = layer_stack.linear_plain(torch.from_numpy(a), _torch(w[:256]), torch.from_numpy(b),
                                   out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    y1 = (_bf16(a).astype(np.float64) @ _bf16(w[:256]).astype(np.float64)).astype(np.float32) + b
    np.testing.assert_allclose(out.float().numpy(), _bf16(y1), atol=2 ** -7, rtol=2 ** -7)
