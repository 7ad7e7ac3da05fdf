"""Port transformer_stack (plain versions on the CPU) against the JAX
transformer_stack (Pallas interpret mode) at 2 layers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.config import LightGlueConfig as JaxLightGlueConfig
from lightglue_tpu.kernels import layer_stack as jax_stack
from lightglue_tpu.runtime import weights as jax_weights
from lightglue_tpu_torch.kernels import layer_stack
from lightglue_tpu_torch.runtime import weights

N_LAYERS = 2
# FP32: both sides are true fp32 and differ in the order of sums. BF16: the
# gate golden/bf16_layer_err_r05.txt derives from its measured envelope (max
# |difference| between two summation orders of the JAX bf16 stack), twice
# the envelope, at 2 layers: 2 x 0.0563. The port and JAX round at the same
# points; the first sum-order flip propagates through the next product, so
# about half of all elements differ by one bf16 ulp after a layer, and one
# ulp at |x| >= 8 (0.0625) already exceeds the envelope itself.
TOL = {"fp32": 1e-4, "bf16": 2 * 0.0563}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

CASES = {
    "128x128 unmasked": (1, 128, 128, None),
    "128x256 masked mixed": (1, 128, 256, ([100], [230])),
    "length-0 pair": (2, 128, 256, ([0, 90], [256, 0])),
}


def make_inputs(seed, b, n0, n1, wr):
    """Descriptors and RoPE freqs (the posenc of random keypoints)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (n0, n1):
        d = rng.standard_normal((b, n, 256), dtype=np.float32)
        ang = rng.uniform(-1, 1, (b, n, 2)).astype(np.float32) @ wr
        emb = np.stack([np.cos(ang), np.sin(ang)], axis=1)
        out.append((d, np.concatenate([emb, emb], axis=-1).astype(np.float32)))
    return out


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_transformer_stack_matches_jax(case, dtype):
    b, n0, n1, lens = CASES[case]
    jdt, tdt = DTYPES[dtype]
    tree = jax_weights.init_lightglue(0, JaxLightGlueConfig(n_layers=N_LAYERS))
    (d0, f0), (d1, f1) = make_inputs(1, b, n0, n1, tree["posenc"]["wr"])
    l0 = l1 = None
    if lens:
        l0, l1 = (np.asarray(x, np.int32) for x in lens)

    stat = jdt
    want = jax_stack.transformer_stack(
        jax_weights.to_jax(tree, jdt)["layers"],
        jnp.asarray(d0, jdt), jnp.asarray(d1, jdt), jnp.asarray(f0), jnp.asarray(f1),
        None if l0 is None else jnp.asarray(l0), None if l1 is None else jnp.asarray(l1),
        num_heads=4, head_dim=64, stat_dtype=stat, attn_dtype=jdt,
    )
    got = layer_stack.transformer_stack(
        weights.params_from_numpy(tree, "cpu", tdt)["layers"],
        torch.from_numpy(d0).to(tdt), torch.from_numpy(d1).to(tdt),
        torch.from_numpy(f0), torch.from_numpy(f1),
        None if l0 is None else torch.from_numpy(l0),
        None if l1 is None else torch.from_numpy(l1),
        num_heads=4, head_dim=64, stat_dtype=tdt, attn_dtype=tdt,
    )
    for g, w in zip(got, want):
        assert g.dtype == tdt and g.shape == w.shape
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(w, np.float32), atol=TOL[dtype], rtol=0
        )


def test_supports_is_the_jax_gate():
    for n0, n1 in ((128, 128), (256, 1024), (1024, 1152), (200, 256), (128, 64)):
        for dt_t, dt_j in ((torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16)):
            assert layer_stack.supports(None, n0, n1, dt_t) == jax_stack.supports(
                None, n0, n1, dt_j, None)
    assert not layer_stack.supports(None, 128, 128, torch.bfloat16, tp_axis="model")


def test_quantized_layers_are_refused():
    """int8 weights run beside bf16 activations only (the INT8 rung): under
    fp32 activations, or as W8A8 past K = 512, the card refuses them before
    any launch (meta tensors take the kernel branch without a card)."""
    w, scale = _meta(256, 256, dtype=torch.int8), _meta(256, dtype=torch.float32)
    b = _meta(256, dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        layer_stack.linear(_meta(8, 256, dtype=torch.float32), w, b, scale=scale)
    with pytest.raises(NotImplementedError):
        layer_stack.linear(_meta(8, 1024), _meta(1024, 256, dtype=torch.int8), b, scale=scale,
                           w8a8=True)
    with pytest.raises(ValueError):  # an int8 weight without its scale
        layer_stack.linear(_meta(8, 256), w, b)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "call,exc",
    [
        (lambda: layer_stack.linear(_meta(8, 100), _meta(100, 64), _meta(64)), ValueError),
        (lambda: layer_stack.linear(_meta(8, 64), _meta(64, 64, dtype=torch.float32),
                                    _meta(64)), NotImplementedError),
        (lambda: layer_stack.attention(_meta(1, 128, 256), _meta(1, 128, 256),
                                       _meta(1, 128, 256), None, None, None, 2,
                                       torch.bfloat16), ValueError),
        (lambda: layer_stack.attention(*(_meta(1, 128, 256, dtype=torch.float32),) * 3,
                                       None, None, None, 4, torch.float32, torch.bfloat16),
         NotImplementedError),
        (lambda: layer_stack.ln_gelu(_meta(8, 1024), _meta(1024), _meta(1024)), ValueError),
    ],
    ids=["linear K%16", "linear dtypes", "attention head dim", "attention out dtype",
         "ln_gelu width"],
)
def test_wrappers_reject_malformed_operands_before_launch(call, exc):
    # meta tensors take the kernel branch without a card; the checks run first
    with pytest.raises(exc):
        call()
