"""Port ring attention (plain step on the CPU) against the JAX package:
flash_attention_step (Pallas interpret mode) with its carries, offsets,
stripe rule and fitted blocks; ring_attention on a ring of CPU positions
against the JAX ring on the 8-device CPU mesh (every case of
tests/test_ring.py); and forward_ring against the JAX forward_ring and the
port's own forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from lightglue_tpu import quant as jax_quant
from lightglue_tpu.config import LightGlueConfig as JLGC
from lightglue_tpu.kernels import attention as jax_attn
from lightglue_tpu.models import lightglue as jax_lg
from lightglue_tpu.parallel import ring as jax_ring
from lightglue_tpu.precision import Precision as JPrecision
from lightglue_tpu.precision import policy_for as jax_policy_for
from lightglue_tpu.runtime import weights as jax_weights
from lightglue_tpu_torch import quant
from lightglue_tpu_torch.config import LightGlueConfig
from lightglue_tpu_torch.kernels import attention
from lightglue_tpu_torch.models import lightglue
from lightglue_tpu_torch.parallel import ring
from lightglue_tpu_torch.precision import Precision, policy_for
from lightglue_tpu_torch.runtime import weights

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# all fp32: true fp32 on both sides, sums in another order. Any bf16 (operands
# or stats): the same rounding points, so a different fp32 sum order flips a
# bf16 rounding by an ulp or two
TOL = {"fp32": dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=2e-2, rtol=2e-2)}
# (operand dtype, stat dtype)
PRECISIONS = {
    "fp32": (torch.float32, torch.float32),
    "bf16 operands, fp32 stats": (torch.bfloat16, torch.float32),
    "bf16 operands, bf16 stats": (torch.bfloat16, torch.bfloat16),
}

# label: (B, H, n, nk, GLOBAL lengths or None, row0, col0, block cap, fresh carries)
STEP_CASES = {
    "unmasked": (2, 2, 128, 128, None, 0, 0, 64, False),
    "masked, kv boundary inside a block": (2, 2, 128, 128, [[256, 173], [200, 150]], 128, 128,
                                           64, False),
    "block wholly past kv_len": (1, 2, 128, 128, [[256, 100]], 0, 128, 64, False),
    "stripes past q_len": (2, 2, 128, 128, [[150, 256], [128, 256]], 128, 0, 16, False),
    "kv_len 0": (2, 2, 64, 64, [[64, 0], [40, 0]], 0, 0, 64, True),
    "n=nk=384, fitted blocks": (1, 2, 384, 384, [[700, 600]], 384, 384, 256, False),
}


def _carries(rng, b, h, n, fresh):
    if fresh:  # the ring's first step
        return (np.full((b, h, n, 1), -1e30, np.float32), np.zeros((b, h, n, 1), np.float32),
                np.zeros((b, h, n, 64), np.float32))
    return (rng.uniform(-2, 2, (b, h, n, 1)).astype(np.float32),
            rng.uniform(0.5, 3, (b, h, n, 1)).astype(np.float32),
            rng.standard_normal((b, h, n, 64), dtype=np.float32))


@pytest.mark.parametrize("precision", list(PRECISIONS))
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_flash_attention_step_matches_jax(case, precision):
    b, h, n, nk, lens, row0, col0, block, fresh = STEP_CASES[case]
    dt, stat = PRECISIONS[precision]
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((b, h, x, 64), dtype=np.float32) for x in (n, nk, nk))
    carries = _carries(rng, b, h, n, fresh)
    lengths = None if lens is None else np.asarray(lens, np.int32)
    kw = dict(block_q=block, block_k=block)
    want = jax_attn.flash_attention_step(
        *(jnp.asarray(x, JDT[dt]) for x in (q, k, v)), *map(jnp.asarray, carries),
        None if lengths is None else jnp.asarray(lengths), row0, col0,
        stat_dtype=JDT[stat], **kw)
    got = attention.flash_attention_step(
        *(torch.from_numpy(x).to(dt) for x in (q, k, v)), *map(torch.from_numpy, carries),
        None if lengths is None else torch.from_numpy(lengths), row0, col0,
        stat_dtype=stat, **kw)
    tol = TOL["fp32" if precision == "fp32" else "bf16"]
    for g, w, c in zip(got, want, carries):
        assert g.dtype == torch.float32 and g.shape == c.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    if case in ("block wholly past kv_len", "kv_len 0"):  # exact pass-through
        for g, c in zip(got, carries):
            np.testing.assert_array_equal(g.numpy(), c)
    if case == "stripes past q_len":  # rows 160.. of pair 0 and all of pair 1 pass through
        for g, c in zip(got, carries):
            np.testing.assert_array_equal(g[0, :, 32:].numpy(), c[0, :, 32:])
            np.testing.assert_array_equal(g[1].numpy(), c[1])
            assert not np.array_equal(g[0, :, :32].numpy(), c[0, :, :32])


def test_flash_attention_step_cpu_launches_nothing_and_fits_blocks():
    q = torch.zeros(1, 1, 96, 64)
    m, l, acc = torch.zeros(1, 1, 96, 1), torch.ones(1, 1, 96, 1), torch.zeros(1, 1, 96, 64)
    before = attention.flash_attention_step.launches
    attention.flash_attention_step(q, q, q, m, l, acc, block_q=64, block_k=64)
    assert attention.flash_attention_step.launches == before  # the plain version ran
    assert [attention._fit_block(s, 1024) for s in (512, 384, 96)] == [512, 384, 96]
    assert attention._fit_block(96, 64) == 48 and attention._fit_block(1536, 1024) == 768


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "carry_dtype,acc_shape",
    [(torch.bfloat16, (1, 4, 128, 64)), (torch.float32, (1, 4, 128, 32))],
    ids=["bf16 carries", "acc shape"],
)
def test_flash_attention_step_rejects_malformed_carries_before_launch(carry_dtype, acc_shape):
    # meta tensors take the kernel branch without a card; the checks run first
    q = _meta(1, 4, 128, 64)
    m = _meta(1, 4, 128, 1, dtype=carry_dtype)
    with pytest.raises(ValueError):
        attention.flash_attention_step(q, q, q, m, m, _meta(*acc_shape, dtype=carry_dtype))


# ---------------------------------------------------------------------------
# ring_attention: the nine cases of tests/test_ring.py, port against JAX
# ---------------------------------------------------------------------------


def _mesh(n=8):
    return Mesh(np.asarray(jax.devices()[:n]), (jax_ring.AXIS_SEQ,))


def _ring_pair(q, k, v, lengths=None, ring_size=8, dtype=torch.float32):
    """(port on a ring of CPU positions, JAX on the CPU mesh), as numpy fp32."""
    got = ring.ring_attention(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
                              None if lengths is None else torch.from_numpy(lengths),
                              devices=["cpu"] * ring_size)
    assert got.dtype == dtype
    want = jax_ring.ring_attention(*(jnp.asarray(x, JDT[dtype]) for x in (q, k, v)),
                                   None if lengths is None else jnp.asarray(lengths),
                                   mesh=_mesh(ring_size))
    return got.float().numpy(), np.asarray(want, np.float32)


def _qkv(rng, b, h, nq, nk):
    return (rng.standard_normal((b, h, x, 64), dtype=np.float32) for x in (nq, nk, nk))


def _reference(q, k, v, lengths=None):
    return attention.reference_attention(
        *map(torch.from_numpy, (q, k, v)),
        None if lengths is None else torch.from_numpy(lengths)).numpy()


RING_CASES = {
    # label: (B, H, N_q, N_kv, lengths, ring size)
    "fp32": (2, 4, 256, 256, None, 8),
    "cross shaped": (1, 4, 128, 512, None, 8),
    "masked lengths": (2, 2, 256, 256, [[200, 173], [256, 41]], 8),
    "fully masked shard": (1, 2, 256, 256, [[256, 32]], 8),
    "smaller ring": (1, 2, 128, 128, [[100, 77]], 4),
    "zero-length kv": (2, 2, 64, 64, [[64, 0], [40, 32]], 8),
}


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_attention_matches_jax(rng, case):
    b, h, nq, nk, lens, size = RING_CASES[case]
    q, k, v = _qkv(rng, b, h, nq, nk)
    lengths = None if lens is None else np.asarray(lens, np.int32)
    got, want = _ring_pair(q, k, v, lengths, size)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the oracle averages the padded values of an empty kv side; the ring gives 0
    live = [i for i in range(b) if lens is None or lens[i][1] > 0]
    np.testing.assert_allclose(got[live], _reference(q, k, v, lengths)[live], atol=1e-5, rtol=0)
    assert np.isfinite(got).all()
    if lens is not None:  # padded Q rows, and every row of an empty kv side, are exactly 0
        for i, (ql, kl) in enumerate(lens):
            assert not got[i, :, ql:].any()
            if kl == 0:
                assert not got[i].any()


def test_ring_attention_bf16_inputs_match_jax(rng):
    q, k, v = _qkv(rng, 1, 4, 256, 256)
    got, want = _ring_pair(q, k, v, dtype=torch.bfloat16)
    # bf16 output of the same fp32-stat merge: an ulp of the output apart
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    ref = attention.reference_attention(*(torch.from_numpy(x).to(torch.bfloat16)
                                          for x in (q, k, v)))
    np.testing.assert_allclose(got, ref.float().numpy(), atol=2e-2)  # JAX's own bar


def test_ring_size_validation_raises_as_jax(rng):
    q, k, v = _qkv(rng, 1, 1, 100, 256)  # 100 % 8 != 0
    with pytest.raises(ValueError, match="divide"):
        jax_ring.ring_attention(*map(jnp.asarray, (q, k, v)), mesh=_mesh())
    with pytest.raises(ValueError, match="divide"):
        ring.ring_attention(*map(torch.from_numpy, (q, k, v)), devices=["cpu"] * 8)


def test_ring_attention_local_merges_blocks_in_ring_order(rng):
    """Position idx merges the block of origin (idx - s) mod ring at step s,
    at col0 = origin * nk and row0 = idx * n, and the one-process transport
    hands it the next."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 1, 1, 64, 64))
    ks, vs = k.chunk(4, dim=2), v.chunk(4, dim=2)
    seen = []

    def step(q_, k_, v_, m, l, acc, lengths, row0, col0, *, scale):
        seen.append((row0, col0, int(torch.equal(k_, ks[col0 // 16]))))
        return attention.flash_attention_step_plain(q_, k_, v_, m, l, acc, lengths, row0, col0,
                                                    scale=scale)

    ring.ring_attention_local(q[:, :, 16:32], ks[1], vs[1], None, idx=1, ring=4,
                              transport=ring._LocalTransport(ks, vs, torch.device("cpu")),
                              step=step)
    assert seen == [(16, 16, 1), (16, 0, 1), (16, 48, 1), (16, 32, 1)]


# ---------------------------------------------------------------------------
# forward_ring: the model with every attention on the ring
# ---------------------------------------------------------------------------


def _model_case(n_layers, precision, with_forward=False):
    rng = np.random.default_rng(888)
    b, n = 2, 256
    k0, k1 = (rng.uniform(-1, 1, (b, n, 2)).astype(np.float32) for _ in range(2))
    d0, d1 = (rng.standard_normal((b, n, 256), dtype=np.float32) for _ in range(2))
    lens0, lens1 = np.asarray([n, 200], np.int32), np.asarray([173, n], np.int32)
    tree = jax_weights.init_lightglue(0, JLGC(n_layers=n_layers))
    jpol = jax_policy_for(JPrecision(precision))
    pol = policy_for(Precision(precision))
    if pol.int8_weights:  # quantized and not cast, as both sessions do on the INT8 rung
        jtree = jax_weights.to_jax(jax_quant.quantize_lightglue(tree))
        ptree = weights.params_from_numpy(quant.quantize_lightglue(tree))
    else:
        jtree = jax_weights.to_jax(tree, jpol.param_dtype)
        ptree = weights.params_from_numpy(tree, "cpu", pol.param_dtype)
    want = jax_lg.forward_ring(
        jtree, *map(jnp.asarray, (k0, k1, d0, d1)), jnp.asarray(lens0), jnp.asarray(lens1),
        config=JLGC(n_layers=n_layers), policy=jpol, mesh=_mesh())
    args = (ptree, *map(torch.from_numpy, (k0, k1, d0, d1, lens0, lens1)))
    kw = dict(config=LightGlueConfig(n_layers=n_layers), policy=pol)
    got = lightglue.forward_ring(*args, devices=["cpu"] * 8, **kw)
    return got, want, lightglue.forward(*args, **kw) if with_forward else None


def _scores(out):
    s = out.scores.float().numpy() if isinstance(out.scores, torch.Tensor) else np.asarray(
        out.scores, np.float32)
    return s, s > -1e29


def test_forward_ring_matches_jax_and_forward_fp32():
    got, want, fwd = _model_case(2, "fp32", with_forward=True)
    s_got, valid = _scores(got)
    s_want, valid_want = _scores(want)
    assert np.array_equal(valid, valid_want)
    # the JAX package's own bars (tests/test_ring.py): scores 5e-4; the
    # descriptors at the port's per-block bar against JAX (1e-4, fp32 sums
    # of two frameworks) and at JAX's own 5e-5 against the port's forward
    np.testing.assert_allclose(s_got, s_want, atol=5e-4, rtol=0)
    np.testing.assert_allclose(s_got, _scores(fwd)[0], atol=5e-4, rtol=0)
    for g, w, f in ((got.desc0, want.desc0, fwd.desc0), (got.desc1, want.desc1, fwd.desc1)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
        np.testing.assert_allclose(g.numpy(), f.numpy(), atol=5e-5, rtol=0)


def _assert_16bit_parity(precision):
    got, want, _ = _model_case(2, precision)
    s_got, valid = _scores(got)
    s_want, _ = _scores(want)
    assert np.array_equal(valid, s_want > -1e29)
    # the 2-layer bf16 gate of golden/bf16_layer_err_r05.txt (2 x 0.0563) on
    # the descriptors, the JAX package's 0.15 bf16 bar on the scores
    for g, w in ((got.desc0, want.desc0), (got.desc1, want.desc1)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   atol=2 * 0.0563, rtol=0)
    assert np.abs(s_got - s_want)[valid].max() < 0.15


def test_forward_ring_matches_jax_bf16():
    _assert_16bit_parity("bf16")


def test_forward_ring_matches_jax_int8():
    """int8 weights dequantized as each linear fetches them (weight-only
    whatever LGTPU_W8A8 says, as in the JAX package), beside the fp32
    biases, LayerNorm and heads of the uncast quantized tree."""
    _assert_16bit_parity("int8")
