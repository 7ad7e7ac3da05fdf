"""Port lightglue.forward (plain versions on the CPU) against JAX lightglue.forward."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.config import LightGlueConfig as JaxLightGlueConfig
from lightglue_tpu.models import lightglue as jax_lg
from lightglue_tpu.precision import Precision as JaxPrecision
from lightglue_tpu.precision import policy_for as jax_policy_for
from lightglue_tpu.runtime import weights as jax_weights
from lightglue_tpu_torch.config import LightGlueConfig
from lightglue_tpu_torch.models import lightglue
from lightglue_tpu_torch.precision import Precision, policy_for
from lightglue_tpu_torch.runtime import weights

N_LAYERS = 2
CASES = {
    "128x128 unmasked": (1, 128, 128, None),
    "128x256 masked mixed": (2, 128, 256, ([128, 70], [200, 256])),
}


def _run_both(case, precision):
    b, m, n, lens = CASES[case]
    rng = np.random.default_rng(4)
    tree = jax_weights.init_lightglue(3, JaxLightGlueConfig(n_layers=N_LAYERS))
    k0 = rng.uniform(-1, 1, (b, m, 2)).astype(np.float32)
    k1 = rng.uniform(-1, 1, (b, n, 2)).astype(np.float32)
    d0 = rng.standard_normal((b, m, 256), dtype=np.float32)
    d1 = rng.standard_normal((b, n, 256), dtype=np.float32)
    l0 = l1 = None
    if lens:
        l0, l1 = (np.asarray(x, np.int32) for x in lens)
    jpol = jax_policy_for(JaxPrecision(precision))
    want = jax_lg.forward(
        jax_weights.to_jax(tree, jpol.param_dtype), *map(jnp.asarray, (k0, k1, d0, d1)),
        None if l0 is None else jnp.asarray(l0), None if l1 is None else jnp.asarray(l1),
        config=JaxLightGlueConfig(n_layers=N_LAYERS), policy=jpol,
    )
    pol = policy_for(Precision(precision))
    got = lightglue.forward(
        weights.params_from_numpy(tree, "cpu", pol.param_dtype),
        *map(torch.from_numpy, (k0, k1, d0, d1)),
        None if l0 is None else torch.from_numpy(l0),
        None if l1 is None else torch.from_numpy(l1),
        config=LightGlueConfig(n_layers=N_LAYERS), policy=pol,
    )
    return got, want


@pytest.mark.parametrize("case", list(CASES))
def test_forward_scores_match_jax_fp32(case):
    got, want = _run_both(case, "fp32")
    # true fp32 on both sides; padded rows/columns are -1e30 on both
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-4, rtol=1e-4)
    for g, w in ((got.desc0, want.desc0), (got.desc1, want.desc1)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax_bf16(case):
    got, want = _run_both(case, "bf16")
    # descriptors: the bf16 layer-stack gate at 2 layers (test_torch_layer_stack)
    for g, w in ((got.desc0, want.desc0), (got.desc1, want.desc1)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   atol=2 * 0.0563, rtol=0)
    # scores: the JAX package's own bf16 bar for the stack against the
    # composed path (tests/test_layer_stack.py:test_stack_matches_full_forward)
    s_got, s_want = got.scores.numpy(), np.asarray(want.scores, np.float32)
    valid = s_want > -1e29
    assert np.array_equal(valid, s_got > -1e29)
    assert np.abs(s_got - s_want)[valid].max() < 0.15
    assert (s_got.argmax(-1) == s_want.argmax(-1)).mean() > 0.9


def test_gate_and_adaptive_raise():
    """Buckets off the stack's gate take the per-block route (a 200 bucket
    runs forward and forward_adaptive's per-layer loop); above 1024 a bucket
    that is not a multiple of 1024 raises fused_mha's ValueError, as in JAX.
    An adaptive config runs through forward_adaptive."""
    tree = weights.init_lightglue(0, LightGlueConfig(n_layers=2))
    params = weights.params_from_numpy(tree, "cpu")
    gen = torch.Generator().manual_seed(0)
    k, d = torch.rand(1, 200, 2, generator=gen) * 2 - 1, torch.randn(1, 200, 256, generator=gen)
    out = lightglue.forward(params, k, k, d, d, config=LightGlueConfig(n_layers=2),
                            policy=policy_for(Precision.FP32))
    assert out.scores.shape == (1, 200, 200) and torch.isfinite(out.scores).all()
    cfg = LightGlueConfig(n_layers=2, depth_confidence=0.95, width_confidence=0.99)
    lens = torch.tensor([120], dtype=torch.int32)
    out = lightglue.forward_adaptive(params, k, k, d, d, lens, lens, config=cfg,
                                     policy=policy_for(Precision.FP32))
    assert out.scores.shape == (1, 200, 200) and torch.isfinite(out.scores).all()
    big = torch.zeros(1, 1536, 2), torch.zeros(1, 1536, 256)
    with pytest.raises(ValueError, match="not divisible"):
        lightglue.forward(params, big[0], big[0], big[1], big[1],
                          config=LightGlueConfig(n_layers=2), policy=policy_for(Precision.FP32))
    k, d = k[:, :128], d[:, :128]
    out = lightglue.forward_adaptive(params, k, k, d, d, lens, lens, config=cfg,
                                     policy=policy_for(Precision.FP32))
    assert out.scores.shape == (1, 128, 128) and int(out.exit_layer[0]) in (1, 2)
    assert torch.isfinite(out.scores).all()
