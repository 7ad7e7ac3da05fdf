"""The layer stack on the MIXED and INT8 rungs (and INT8's W8A8 mode): the
port's transformer_stack (plain versions on the CPU) against the JAX
transformer_stack (Pallas interpret mode) at 2 layers, and the two premises
the card's checks rest on: the cross block's direction 1 at MIXED sums p
after its cast to bf16, and INT8 is not BF16 with dequantized weights."""

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu import quant as jax_quant
from lightglue_tpu.config import LightGlueConfig as JLGC
from lightglue_tpu.kernels import layer_stack as jax_stack
from lightglue_tpu.runtime import weights as jax_weights
from lightglue_tpu_torch import quant
from lightglue_tpu_torch.kernels import layer_stack
from lightglue_tpu_torch.runtime import weights

from test_torch_layer_stack import make_inputs

N_LAYERS = 2
# the gates the JAX package's own tests use for these comparisons:
# MIXED 5e-3 x max|ref| and W8A8 0.02 x max|ref| (tests/test_layer_stack.py:
# 149-156), INT8 weight-only the 2-layer bf16 gate of
# golden/bf16_layer_err_r05.txt (2 x 0.0563), as the BF16 stack test uses
RUNGS = {
    # rung: (activation dtypes (JAX, torch), stat dtypes, W8A8, gate (atol, share of max|ref|))
    "mixed": ((jnp.float32, torch.float32), (jnp.float32, torch.float32), False, (0.0, 5e-3)),
    "int8": ((jnp.bfloat16, torch.bfloat16), (jnp.bfloat16, torch.bfloat16), False,
             (2 * 0.0563, 0.0)),
    "w8a8": ((jnp.bfloat16, torch.bfloat16), (jnp.bfloat16, torch.bfloat16), True, (0.0, 0.02)),
}
CASES = {
    # label: (N0, N1, lengths or None)
    "128x128 unmasked": (128, 128, None),
    "128x128 masked": (128, 128, ([100], [77])),
    "128x256 unmasked": (128, 256, None),
    "128x256 masked": (128, 256, ([100], [230])),
}


@contextlib.contextmanager
def _w8a8(on: bool):
    """LGTPU_W8A8 for both packages. JAX reads it when the stack is traced,
    so the trace caches are cleared on the way in and out."""
    old = os.environ.get("LGTPU_W8A8")
    os.environ["LGTPU_W8A8"] = "1" if on else "0"
    jax.clear_caches()
    try:
        yield
    finally:
        if old is None:
            del os.environ["LGTPU_W8A8"]
        else:
            os.environ["LGTPU_W8A8"] = old
        jax.clear_caches()


def _tree(ln_seed=None):
    """The 2-layer random tree; with ``ln_seed``, LayerNorm gamma/beta drawn
    off the bf16 grid (the init's ones and zeros are bf16-exact)."""
    tree = jax_weights.init_lightglue(0, JLGC(n_layers=N_LAYERS))
    if ln_seed is not None:
        rng = np.random.default_rng(ln_seed)
        tree = dict(tree, layers={k: dict(v) for k, v in tree["layers"].items()})
        for blk in ("self_attn", "cross_attn"):
            for key, base in (("ln_g", 1.0), ("ln_b", 0.0)):
                shape = tree["layers"][blk][key].shape
                tree["layers"][blk][key] = (base + 0.3 * rng.standard_normal(shape)).astype(
                    np.float32)
    return tree


def _inputs(tree, case):
    n0, n1, lens = CASES[case]
    (d0, f0), (d1, f1) = make_inputs(1, 1, n0, n1, tree["posenc"]["wr"])
    if lens is None:
        return d0, d1, f0, f1, None, None
    return (d0, d1, f0, f1, *(np.asarray(x, np.int32) for x in lens))


def _jax_layers(rung, tree):
    if rung == "mixed":
        return jax_weights.to_jax(tree, jnp.float32)["layers"]
    return jax_weights.to_jax(jax_quant.quantize_lightglue(tree))["layers"]


def _port_layers(rung, tree):
    """MIXED: the fp32 tree. INT8: the quantized tree, not cast (the
    session's INT8 branch): int8 w_q, fp32 scales, biases and LayerNorm."""
    if rung == "mixed":
        return weights.params_from_numpy(tree, "cpu", torch.float32)["layers"]
    return weights.params_from_numpy(quant.quantize_lightglue(tree))["layers"]


@functools.lru_cache(maxsize=None)
def _jax_stack(rung, case, ln_seed=None, cross_transposed=None):
    (jdt, _), (jstat, _), w8a8, _ = RUNGS[rung]
    tree = _tree(ln_seed)
    d0, d1, f0, f1, l0, l1 = _inputs(tree, case)
    with _w8a8(w8a8):
        out = jax_stack.transformer_stack(
            _jax_layers(rung, tree), jnp.asarray(d0, jdt), jnp.asarray(d1, jdt),
            jnp.asarray(f0), jnp.asarray(f1), None if l0 is None else jnp.asarray(l0),
            None if l1 is None else jnp.asarray(l1), num_heads=4, head_dim=64,
            stat_dtype=jstat, attn_dtype=jnp.bfloat16, cross_transposed=cross_transposed)
    return tuple(np.asarray(x, np.float32) for x in out)


def _port_stack(rung, case, layers=None, ops=None, ln_seed=None):
    (_, tdt), (_, tstat), w8a8, _ = RUNGS[rung]
    tree = _tree(ln_seed)
    d0, d1, f0, f1, l0, l1 = _inputs(tree, case)
    layers = _port_layers(rung, tree) if layers is None else layers
    args = (layers, torch.from_numpy(d0).to(tdt), torch.from_numpy(d1).to(tdt),
            torch.from_numpy(f0), torch.from_numpy(f1),
            None if l0 is None else torch.from_numpy(l0),
            None if l1 is None else torch.from_numpy(l1))
    kw = dict(num_heads=4, stat_dtype=tstat, attn_dtype=torch.bfloat16)
    with _w8a8(w8a8):
        if ops is None:  # the entry point: on the CPU it runs the plain versions
            out = layer_stack.transformer_stack(*args, head_dim=64, **kw)
        else:
            out = layer_stack._run_stack(*args, ops=ops, **kw)
    for x in out:
        assert x.dtype == tdt
    return tuple(x.float().numpy() for x in out)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("rung", list(RUNGS))
def test_transformer_stack_matches_jax_at_rung(rung, case):
    atol, share = RUNGS[rung][3]
    want = _jax_stack(rung, case)
    for g, w in zip(_port_stack(rung, case), want):
        assert g.shape == w.shape
        err, bound = np.abs(g - w).max(), atol + share * np.abs(w).max()
        assert err <= bound, (rung, case, err, bound)


# the port's MIXED stack with a direction-1 launch that sums fp32 p, as
# self-attention and direction 0 do (the reference's cross_transposed rule)
_NO_DIR1 = layer_stack.PLAIN_OPS._replace(
    attention=lambda *a, dir1=False, **kw: layer_stack.attention_plain(*a, **kw))


def _mean_err(got, want):
    return float(np.mean([np.abs(g - w).mean() for g, w in zip(got, want)]))


@pytest.mark.parametrize("case", ["128x128 unmasked", "128x256 masked"])
def test_mixed_direction1_sums_bf16_p(case):
    """Premise of the card's MIXED attention witness: the reference's shared-S
    direction 1 sums p1.astype(attn_dtype) (layer_stack.py:543-549), where
    its cross_transposed variant and direction 0 sum fp32 p. At MIXED the
    two rules differ, so the port with its dir1 flag is nearer the JAX
    default, and without it nearer the JAX cross_transposed stack."""
    default = _jax_stack("mixed", case, cross_transposed=False)
    transposed = _jax_stack("mixed", case, cross_transposed=True)
    with_flag = _port_stack("mixed", case, ops=layer_stack.PLAIN_OPS)
    without = _port_stack("mixed", case, ops=_NO_DIR1)
    assert _mean_err(without, default) > _mean_err(with_flag, default)
    assert _mean_err(with_flag, transposed) > _mean_err(without, transposed)
    # image 1's rows, which direction 1 writes first
    assert np.abs(without[1] - default[1]).mean() > np.abs(with_flag[1] - default[1]).mean()


def test_int8_is_not_bf16_with_dequantized_weights():
    """Premise of INT8 on the card: the JAX session does not cast the
    quantized tree (session.py:75-78), so LayerNorm gamma/beta reach the
    stack in fp32 (used as g.astype(f32), :395-397) where BF16 rounds them
    to bf16. With gamma/beta off the bf16 grid, the port's INT8 stack and
    the BF16 stack on dequantized weights differ, and the INT8 one is the
    nearer to the JAX INT8 stack."""
    case, ln_seed = "128x128 masked", 3
    tree = _tree(ln_seed)
    qtree = quant.quantize_lightglue(tree)

    def dequantized(node):
        if quant.is_quantized(node):
            return {"w": quant.dequantize(node, torch.float32).numpy(), "b": node["b"]}
        return {k: dequantized(v) if isinstance(v, dict) else v for k, v in node.items()}

    bf16_deq = weights.params_from_numpy(dequantized(qtree), "cpu", torch.bfloat16)["layers"]
    want = _jax_stack("int8", case, ln_seed=ln_seed)
    got = _port_stack("int8", case, ln_seed=ln_seed)
    alt = _port_stack("int8", case, layers=bf16_deq, ln_seed=ln_seed)
    assert all(np.mean(g != a) > 0.1 for g, a in zip(got, alt))
    assert _mean_err(alt, want) > _mean_err(got, want)
    atol = RUNGS["int8"][3][0]
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= atol
