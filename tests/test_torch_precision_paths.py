"""The MIXED and INT8 rungs on the port's other routes, plain versions on the
CPU, against the JAX package: fused_mha, flash_attention and
bidirectional_cross_attention with bf16 operands, fp32 statistics and an
fp32 output (Pallas interpret mode); the adaptive forward against the JAX
force_loop oracle; and MatcherSession against the JAX session."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu import quant as jax_quant
from lightglue_tpu.config import LightGlueConfig as JLGC
from lightglue_tpu.kernels import attention as jax_attn
from lightglue_tpu.models import lightglue as jax_lg
from lightglue_tpu.precision import Precision as JPrecision
from lightglue_tpu.precision import policy_for as jax_policy_for
from lightglue_tpu.runtime import weights as jax_weights
from lightglue_tpu.runtime.session import MatcherSession as JaxSession
from lightglue_tpu_torch import quant
from lightglue_tpu_torch.config import LightGlueConfig
from lightglue_tpu_torch.kernels import attention
from lightglue_tpu_torch.models import lightglue
from lightglue_tpu_torch.precision import Precision, policy_for
from lightglue_tpu_torch.runtime import weights
from lightglue_tpu_torch.runtime.session import MatcherSession

from test_torch_adaptive import _inputs, _pinned_exit, _spread, _token, _with_match_bias
from test_torch_session import _configs, _match_set
from test_torch_superpoint import smooth_images

# bf16 operands on both sides, fp32 statistics and sums in another order,
# fp32 outputs: a bf16 rounding of p that flips moves an output by far less
MIXED_TOL = dict(atol=1e-3, rtol=1e-3)


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _bf16(x):
    """(JAX, torch) bf16 copies of a numpy array."""
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _lens(lens):
    if lens is None:
        return None, None
    x = np.asarray(lens, np.int32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MIXED_TOL)


MIXED = dict(stat_dtype=torch.float32, out_dtype=torch.float32)
JMIXED = dict(stat_dtype=jnp.float32, out_dtype=jnp.float32)

# (B, Nq, Nk, rope, lengths, block_q/block_k)
FUSED_CASES = {
    "unmasked": (2, 128, 128, False, None, 1024),
    "ragged lengths, q_len 0, kv_len 0": (3, 192, 192, False,
                                          [[192, 150], [0, 100], [80, 0]], 64),
    "rope, ragged": (2, 192, 192, True, [[150, 100], [192, 0]], 64),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_mha_mixed_matches_jax(case):
    b, nq, nk, rope, lens, block = FUSED_CASES[case]
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (_bf16(_rand(rng, b, n, 256)) for n in (nq, nk, nk))
    freqs = None
    if rope:
        ang = rng.uniform(-3, 3, (b, nk, 32)).astype(np.float32)
        emb = np.stack([np.cos(ang), np.sin(ang)], axis=1)
        freqs = np.concatenate([emb, emb], axis=-1)
    jf, tf = (None, None) if freqs is None else (jnp.asarray(freqs), torch.from_numpy(freqs))
    jl, tl = _lens(lens)
    kw = dict(num_heads=4, block_q=block, block_k=block)
    want = jax_attn.fused_mha(jq, jk, jv, jf, jl, **JMIXED, **kw)
    got = attention.fused_mha(tq, tk, tv, tf, tl, **MIXED, **kw)
    _close(got, want)
    for i, (ql, kl) in enumerate(lens or []):  # the port gives 0 past q_len and for kv_len 0
        assert not got[i, ql:].any()
        if kl == 0:
            assert not got[i].any()


@pytest.mark.parametrize("case", ["unmasked", "ragged, three KV tiles"])
def test_flash_attention_mixed_matches_jax(case):
    b, nq, nk, lens, block = {"unmasked": (2, 128, 128, None, 1024),
                              "ragged, three KV tiles": (2, 192, 192, [[100, 70], [0, 192]],
                                                         64)}[case]
    rng = np.random.default_rng(2)
    (jq, tq), (jk, tk), (jv, tv) = (_bf16(_rand(rng, b, 4, n, 64)) for n in (nq, nk, nk))
    jl, tl = _lens(lens)
    kw = dict(block_q=block, block_k=block)
    want = jax_attn.flash_attention(jq, jk, jv, jl, **JMIXED, **kw)
    got = attention.flash_attention(tq, tk, tv, tl, **MIXED, **kw)
    _close(got, want)


BIDIR_CASES = {
    "unmasked 128x192": (2, 128, 192, None),
    "ragged 192x128": (2, 192, 128, [[150, 100], [192, 128]]),
    "an empty side": (2, 64, 256, [[40, 70], [5, 0]]),
}


@pytest.mark.parametrize("case", list(BIDIR_CASES))
def test_bidirectional_cross_mixed_matches_jax(case):
    """Both directions at MIXED, direction 1 summing p after its cast to
    bf16 in both packages. A pair whose kv side is empty gives 0 in the
    port; the JAX kernel gives the mean of the pads there (ROADMAP queue
    3), so only the other pairs are compared."""
    b, n0, n1, lens = BIDIR_CASES[case]
    rng = np.random.default_rng(3)
    ops = [_bf16(_rand(rng, b, n, 256)) for n in (n0, n1, n0, n1)]
    jl, tl = _lens(lens)
    want = jax_attn.bidirectional_cross_attention(*[j for j, _ in ops], jl, num_heads=4,
                                                  **JMIXED)
    got = attention.bidirectional_cross_attention(*[t for _, t in ops], tl, num_heads=4,
                                                  **MIXED)
    live = [i for i in range(b) if lens is None or min(lens[i]) > 0]
    for g, w in zip(got, want):
        _close(g[live], np.asarray(w)[live])
    for i, (l0, l1) in enumerate(lens or []):
        assert not got[0][i, l0:].any() and not got[1][i, l1:].any()
        if min(l0, l1) == 0:
            assert not got[0][i].any() and not got[1][i].any()


# ---------------------------------------------------------------------------
# the adaptive forward on the stack against the JAX force_loop oracle
# ---------------------------------------------------------------------------


def _trees(tree, precision):
    """(JAX tree, port tree) of a rung: cast to the parameter dtype, or on
    INT8 quantized and not cast."""
    if precision == "int8":
        return (jax_weights.to_jax(jax_quant.quantize_lightglue(tree)),
                weights.params_from_numpy(quant.quantize_lightglue(tree)))
    jpol, pol = jax_policy_for(JPrecision(precision)), policy_for(Precision(precision))
    return (jax_weights.to_jax(tree, jpol.param_dtype),
            weights.params_from_numpy(tree, "cpu", pol.param_dtype))


ADAPTIVE_CASES = {
    # label: (L, token head, match bias or None, config)
    "depth exit 2": (3, lambda L: _pinned_exit(L, 2), None, dict(depth_confidence=0.95)),
    "unconfident, width nothing pruned": (3, lambda L: _token(L, np.full(L - 1, -10.0)), 50.0,
                                          dict(depth_confidence=0.95, width_confidence=0.99)),
    "width pruning, spread head": (3, lambda L: _spread(L, 7), None,
                                   dict(width_confidence=0.2)),
}
# scores: MIXED at fp32 with bf16 products on the port's stack against
# true-fp32 products of the oracle's per-layer loop; INT8 at the JAX
# package's 0.15 bf16 bar on log-assignment scores
SCORE_TOL = {"mixed": 5e-2, "int8": 0.15}


@pytest.mark.parametrize("case", list(ADAPTIVE_CASES))
@pytest.mark.parametrize("precision", ["mixed", "int8"])
def test_forward_adaptive_matches_jax_oracle(precision, case):
    """The port's forward_adaptive (transformer_stack_adaptive) against JAX
    force_loop=True (the per-layer oracle: the JAX kernel's downshift has a
    liveness fault, ROADMAP queue 3). Exits are equal; so are the survivor
    counts up to the pruning boundary's flips."""
    n_layers, token_fn, match_bias, cfg = ADAPTIVE_CASES[case]
    tree = weights.init_lightglue(0, LightGlueConfig(n_layers=n_layers))
    tree["token"] = token_fn(n_layers)
    if match_bias is not None:
        tree = _with_match_bias(tree, match_bias)
    jtree, ptree = _trees(tree, precision)
    args = _inputs()
    jpol = jax_policy_for(JPrecision(precision))
    k0, k1, d0, d1, l0, l1 = args
    want = jax_lg.forward_adaptive(
        jtree, *map(jnp.asarray, (k0, k1)), jnp.asarray(d0, jpol.act_dtype),
        jnp.asarray(d1, jpol.act_dtype), jnp.asarray(l0), jnp.asarray(l1),
        config=JLGC(n_layers=n_layers, **cfg), policy=jpol, force_loop=True)
    got = lightglue.forward_adaptive(
        ptree, *map(torch.from_numpy, args), config=LightGlueConfig(n_layers=n_layers, **cfg),
        policy=policy_for(Precision(precision)))
    np.testing.assert_array_equal(got.exit_layer.numpy(), np.asarray(want.exit_layer))
    pruning = "pruning" in case
    for key in ("lengths0", "lengths1"):
        g, w = getattr(got, key).numpy(), np.asarray(getattr(want, key))
        assert np.abs(g - w).max() <= (2 if pruning else 0), key
    if pruning:
        assert got.lengths0[0] < 123 or got.lengths1[0] < 119, "nothing pruned"
        return
    s_got, s_want = got.scores.float().numpy(), np.asarray(want.scores, np.float32)
    valid = s_want > -1e29
    assert np.array_equal(s_got > -1e29, valid)
    assert np.abs(s_got - s_want)[valid].max() < SCORE_TOL[precision]


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["mixed", "int8"])
def test_session_matches_jax_session_at_rung(precision):
    """MatcherSession(device="cpu") on the rung against the JAX session on
    the same numpy weights and images: keypoints, the match set at
    threshold 0 and the scores."""
    jcfg, cfg = _configs(precision)
    sp = jax_weights.init_superpoint(11)
    lg = jax_weights.init_lightglue(12, JLGC(n_layers=2))
    imgs = smooth_images(5, 1, 112, 152)[0]
    img0, img1 = imgs[:96, :128], imgs[16:112, 24:152]
    want = JaxSession(sp, lg, config=jcfg, compile_cache_dir=None).match_pair(img0, img1)
    session = MatcherSession(sp, lg, config=cfg, device="cpu")
    if precision == "int8":
        qkv = session.lg_params["layers"]["self_attn"]["qkv"]
        assert qkv["w_q"].dtype == torch.int8 and qkv["scale"].dtype == torch.float32
        assert session.lg_params["layers"]["self_attn"]["ln_g"].dtype == torch.float32
    got = session.match_pair(img0, img1)
    assert got["num_keypoints0"] == want["num_keypoints0"] > 10
    assert got["num_keypoints1"] == want["num_keypoints1"]
    ours, theirs = _match_set(got), _match_set(want)
    assert theirs, "JAX found no matches; the comparison would be vacuous"
    iou = len(ours.keys() & theirs.keys()) / len(ours.keys() | theirs.keys())
    assert iou > 0.9, (len(ours), len(theirs), iou)
    valid = want["scores"] > -1e29
    assert np.array_equal(got["scores"] > -1e29, valid)
    assert np.abs(got["scores"] - want["scores"])[valid].max() < SCORE_TOL[precision]
