"""Port the per-block LightGlue route (plain versions on the CPU) against the
JAX package: transformer_layer's stacked and mixed branches, forward off
the layer stack's gate (a 192 bucket, a 2048 bucket), forward_adaptive's
per-layer loop there, and the session on the reference's pad-to-64 ladder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.config import LightGlueConfig as JLGC
from lightglue_tpu.config import PipelineConfig as JPC
from lightglue_tpu.config import SuperPointConfig as JSPC
from lightglue_tpu.models import lightglue as jax_lg
from lightglue_tpu.precision import Precision as JPrecision
from lightglue_tpu.precision import policy_for as jax_policy_for
from lightglue_tpu.runtime import weights as jax_weights
from lightglue_tpu.runtime.session import MatcherSession as JaxSession
from lightglue_tpu_torch.config import LightGlueConfig, PipelineConfig, SuperPointConfig
from lightglue_tpu_torch.models import lightglue
from lightglue_tpu_torch.precision import Precision, policy_for
from lightglue_tpu_torch.runtime import weights
from lightglue_tpu_torch.runtime.session import MatcherSession

from test_torch_adaptive import _assert_same, _inputs, _prune_parity, _run, _spread, _tree
from test_torch_session import _match_set
from test_torch_superpoint import smooth_images

# FP32: true fp32 on both sides, sums in another order. BF16: the 2-layer
# gate of golden/bf16_layer_err_r05.txt that test_torch_layer_stack uses
# (twice the measured envelope between two summation orders, 2 x 0.0563)
DESC_TOL = {"fp32": 1e-4, "bf16": 2 * 0.0563}


def _case(seed, b, m, n, lens):
    rng = np.random.default_rng(seed)
    k0 = rng.uniform(-1, 1, (b, m, 2)).astype(np.float32)
    k1 = rng.uniform(-1, 1, (b, n, 2)).astype(np.float32)
    d0 = rng.standard_normal((b, m, 256), dtype=np.float32)
    d1 = rng.standard_normal((b, n, 256), dtype=np.float32)
    l0 = l1 = None
    if lens:
        l0, l1 = (np.asarray(x, np.int32) for x in lens)
    return k0, k1, d0, d1, l0, l1


def _opt(x, fn):
    return None if x is None else fn(x)


def test_apply_rotary_matches_jax():
    rng = np.random.default_rng(1)
    t = rng.standard_normal((2, 4, 96, 64), dtype=np.float32)
    ang = rng.uniform(-3, 3, (2, 96, 32)).astype(np.float32)
    emb = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    freqs = np.concatenate([emb, emb], axis=-1)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jax_lg.apply_rotary(jnp.asarray(freqs), jnp.asarray(t, jdt))
        got = lightglue.apply_rotary(torch.from_numpy(freqs), torch.from_numpy(t).to(tdt))
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


LAYER_CASES = {
    "stacked 192x192 masked": (1, 192, 192, ([150], [192])),
    "mixed 64x192 masked": (2, 64, 192, ([64, 40], [150, 192])),
}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_transformer_layer_matches_jax(case, precision):
    b, m, n, lens = LAYER_CASES[case]
    k0, k1, d0, d1, l0, l1 = _case(2, b, m, n, lens)
    tree = jax_weights.init_lightglue(1, JLGC(n_layers=1))
    jpol = jax_policy_for(JPrecision(precision))
    jp = jax_weights.to_jax(tree, jpol.param_dtype)
    jf0, jf1 = (jax_lg.posenc(jp["posenc"], jnp.asarray(k), 64) for k in (k0, k1))
    want = jax_lg.transformer_layer(
        jax.tree.map(lambda a: a[0], jp["layers"]), jnp.asarray(d0, jpol.act_dtype),
        jnp.asarray(d1, jpol.act_dtype), jf0, jf1, _opt(l0, jnp.asarray), _opt(l1, jnp.asarray),
        4, jpol)
    pol = policy_for(Precision(precision))
    p = weights.params_from_numpy(tree, "cpu", pol.param_dtype)
    got = lightglue.transformer_layer(
        lightglue._layer(p["layers"], 0), torch.from_numpy(d0).to(pol.act_dtype),
        torch.from_numpy(d1).to(pol.act_dtype), torch.tensor(np.asarray(jf0)),
        torch.tensor(np.asarray(jf1)), _opt(l0, torch.from_numpy), _opt(l1, torch.from_numpy),
        4, pol)
    for g, w in zip(got, want):
        assert g.dtype == pol.act_dtype and g.shape == w.shape
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   atol=DESC_TOL[precision], rtol=0)


FORWARD_CASES = {
    "2 layers, 192x192 ragged": (2, 2, 192, 192, ([192, 120], [160, 192])),
    "1 layer, 2048x2048": (1, 1, 2048, 2048, ([2048], [1500])),
}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_per_block_matches_jax(case, precision):
    n_layers, b, m, n, lens = FORWARD_CASES[case]
    args = _case(4, b, m, n, lens)
    tree = jax_weights.init_lightglue(3, JLGC(n_layers=n_layers))
    jpol = jax_policy_for(JPrecision(precision))
    want = jax_lg.forward(
        jax_weights.to_jax(tree, jpol.param_dtype), *map(jnp.asarray, args[:4]),
        *(_opt(x, jnp.asarray) for x in args[4:]), config=JLGC(n_layers=n_layers), policy=jpol)
    pol = policy_for(Precision(precision))
    got = lightglue.forward(
        weights.params_from_numpy(tree, "cpu", pol.param_dtype), *map(torch.from_numpy, args[:4]),
        *(_opt(x, torch.from_numpy) for x in args[4:]), config=LightGlueConfig(n_layers=n_layers),
        policy=pol)
    for g, w in ((got.desc0, want.desc0), (got.desc1, want.desc1)):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   atol=DESC_TOL[precision], rtol=0)
    s_got, s_want = got.scores.float().numpy(), np.asarray(want.scores, np.float32)
    valid = s_want > -1e29
    assert np.array_equal(valid, s_got > -1e29)
    if precision == "fp32":
        np.testing.assert_allclose(s_got, s_want, atol=1e-4, rtol=1e-4)
    else:  # the JAX package's own bf16 bar (tests/test_layer_stack.py)
        assert np.abs(s_got - s_want)[valid].max() < 0.15


ADAPTIVE_N = 192


@pytest.mark.parametrize("width", [False, True], ids=["depth", "depth+width"])
def test_forward_adaptive_per_block_loop_matches_jax(width):
    """Off the stack's gate both packages run the per-layer loop on
    transformer_layer (lightglue.py:921-966): a spread token head keeps the
    confident share under 0.95 for the depth case and prunes at width 0.2."""
    n_layers = 3
    tree = _tree(n_layers, token=_spread(n_layers, 7))
    cfg = dict(n_layers=n_layers, depth_confidence=0.95)
    if width:
        cfg["width_confidence"] = 0.2
    got, want = _run(tree, _inputs(b=2, n=ADAPTIVE_N), **cfg)
    np.testing.assert_array_equal(got["exit_layer"], want["exit_layer"])
    if not width:
        _assert_same(got, want)
        return
    for i in range(2):
        assert got["lengths0"][i] < ADAPTIVE_N - 5 or got["lengths1"][i] < ADAPTIVE_N - 9
        _prune_parity(got, want, i)


def test_session_pad_to_64_ladder_matches_jax():
    """The reference's pad-to-64 bucketing: a pair of 129-192 keypoints
    lands in bucket 192, off the stack's gate, so both sessions take the
    per-block route."""
    kw = dict(buckets=(64, 128, 192), match_threshold=0.0, max_matches=192)
    jcfg = JPC(superpoint=JSPC(max_num_keypoints=192), lightglue=JLGC(n_layers=2),
               precision=JPrecision.FP32, **kw)
    cfg = PipelineConfig(superpoint=SuperPointConfig(max_num_keypoints=192),
                         lightglue=LightGlueConfig(n_layers=2), precision=Precision.FP32, **kw)
    sp = jax_weights.init_superpoint(11)
    lg = jax_weights.init_lightglue(12, JLGC(n_layers=2))
    imgs = smooth_images(5, 1, 112, 152)[0]
    img0, img1 = imgs[:96, :128], imgs[16:112, 24:152]
    want = JaxSession(sp, lg, config=jcfg, compile_cache_dir=None).match_pair(img0, img1)
    got = MatcherSession(sp, lg, config=cfg, device="cpu").match_pair(img0, img1)
    assert got["num_keypoints0"] == want["num_keypoints0"] > 128
    assert got["num_keypoints1"] == want["num_keypoints1"] > 128
    assert got["scores"].shape == want["scores"].shape == (192, 192)
    ours, theirs = _match_set(got), _match_set(want)
    assert theirs, "JAX found no matches; the comparison would be vacuous"
    iou = len(ours.keys() & theirs.keys()) / len(ours.keys() | theirs.keys())
    assert iou > 0.95, (len(ours), len(theirs), iou)
