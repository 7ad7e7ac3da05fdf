"""The port's .pth weight path (runtime/weights.py) and SuperPoint's raw
descriptor map against the JAX package and the independent torch oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.models import superpoint as jax_sp
from lightglue_tpu.precision import Precision as JaxPrecision
from lightglue_tpu.precision import policy_for as jax_policy_for
from lightglue_tpu.runtime import weights as jax_weights
from lightglue_tpu_torch.config import LightGlueConfig
from lightglue_tpu_torch.models import lightglue, superpoint
from lightglue_tpu_torch.precision import Precision, policy_for
from lightglue_tpu_torch.runtime import weights

from test_torch_host import one_torch_thread  # noqa: F401 (autouse)
from test_torch_superpoint import smooth_images
from torch_oracle import (
    make_lightglue_state_dict,
    make_superpoint_state_dict,
    oracle_lightglue,
    oracle_superpoint_raw_descriptors,
)

N_LAYERS = 2
FP32 = policy_for(Precision.FP32)


def assert_trees_equal(got, want, path=""):
    """The same keys, and every leaf of the same dtype, shape and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _old_key_scheme(sd):
    """transformers.{i}.self_attn.* -> self_attn.{i}.* (the pre-rename
    checkpoints, reference lightglue.py:347-354)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("transformers."):
            _, i, block, rest = k.split(".", 3)
            k = f"{block}.{i}.{rest}"
        out[k] = v
    return out


@pytest.mark.parametrize("head_dim", [64, 32, 8])
def test_rope_permutation_and_qkv_repack_equal_jax(head_dim):
    perm = weights.rope_permutation(head_dim)
    want = jax_weights.rope_permutation(head_dim)
    assert perm.dtype == want.dtype and np.array_equal(perm, want)
    heads = 256 // head_dim
    rng = np.random.default_rng(head_dim)
    w = rng.standard_normal((768, 256)).astype(np.float32)
    b = rng.standard_normal(768).astype(np.float32)
    assert_trees_equal(weights._repack_qkv(w, b, heads, head_dim),
                       jax_weights._repack_qkv(w, b, heads, head_dim))


@pytest.mark.parametrize("scheme", ["current", "pre-rename"])
def test_lightglue_from_state_dict_equals_jax(scheme):
    sd = _numpy(make_lightglue_state_dict(seed=5, n_layers=N_LAYERS))
    if scheme == "pre-rename":
        sd = _old_key_scheme(sd)
    got = weights.lightglue_from_state_dict(sd)  # layer count read from the keys
    assert_trees_equal(got, jax_weights.lightglue_from_state_dict(sd))
    assert got["layers"]["self_attn"]["qkv"]["w"].shape == (N_LAYERS, 3, 256, 256)
    assert_trees_equal(got, weights.lightglue_from_state_dict(
        sd, LightGlueConfig(n_layers=N_LAYERS)))


def test_superpoint_from_state_dict_equals_jax():
    sd = _numpy(make_superpoint_state_dict(seed=6))
    assert_trees_equal(weights.superpoint_from_state_dict(sd),
                       jax_weights.superpoint_from_state_dict(sd))


def test_load_torch_checkpoint_equals_jax(tmp_path):
    sd = make_superpoint_state_dict(seed=2)
    path = str(tmp_path / "superpoint_v1.pth")
    torch.save(sd, path)
    got, want = weights.load_torch_checkpoint(path), jax_weights.load_torch_checkpoint(path)
    assert got.keys() == want.keys() == sd.keys()
    for k in sd:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()


def test_converted_lightglue_matches_torch_oracle():
    """The port's LightGlue (FP32, CPU, plain versions) on the converted
    tree against the oracle driven by the torch state dict: 1e-4."""
    sd = make_lightglue_state_dict(seed=9, n_layers=N_LAYERS)
    tree = weights.lightglue_from_state_dict(_numpy(sd))
    rng = np.random.default_rng(9)
    k0 = rng.uniform(-1, 1, (1, 128, 2)).astype(np.float32)
    k1 = rng.uniform(-1, 1, (1, 128, 2)).astype(np.float32)
    d0 = rng.standard_normal((1, 128, 256), dtype=np.float32)
    d1 = rng.standard_normal((1, 128, 256), dtype=np.float32)
    out = lightglue.forward(weights.params_from_numpy(tree), *map(torch.from_numpy, (k0, k1, d0, d1)),
                            config=LightGlueConfig(n_layers=N_LAYERS), policy=FP32)
    want_d0, want_d1, want_scores = oracle_lightglue(sd, k0, k1, d0, d1, n_layers=N_LAYERS)
    np.testing.assert_allclose(out.desc0.numpy(), want_d0, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out.desc1.numpy(), want_d1, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out.scores.numpy(), want_scores, atol=1e-4, rtol=1e-4)


def test_raw_descriptors_match_jax_and_oracle():
    """forward_raw_descriptors on a 64x96 image against JAX's and the
    oracle's (from the torch state dict): 1e-4 of the map's largest value."""
    sd = make_superpoint_state_dict(seed=4)
    tree = weights.superpoint_from_state_dict(_numpy(sd))
    img = smooth_images(5, 1, 64, 96)
    got = superpoint.forward_raw_descriptors(weights.params_from_numpy(tree),
                                             torch.from_numpy(img), policy=FP32)
    assert got.shape == (1, 8, 12, 256) and got.dtype == torch.float32
    got = got.numpy()
    want = np.asarray(jax_sp.forward_raw_descriptors(
        jax_weights.to_jax(tree), jnp.asarray(img), policy=jax_policy_for(JaxPrecision.FP32)))
    oracle = oracle_superpoint_raw_descriptors(sd, img.transpose(0, 3, 1, 2)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0)
    np.testing.assert_allclose(got, oracle.transpose(0, 2, 3, 1), atol=1e-4 * scale, rtol=0)


def test_whitening_matches_jax():
    """whiten_superpoint_descriptors on two 96x128 calibration images (384
    positions, more than the 256 dimensions) against JAX's, leaf by leaf.

    Tolerance 1e-3 of the leaf's largest value: the raw maps agree to ~1e-7
    of their scale, and the whitening divides by the square root of
    eigenvalues down to the floor of 1e-6 x the largest, so it can grow a
    raw difference up to 1e3 times; 1e-3 keeps a factor 10 of margin."""
    tree = jax_weights.init_superpoint(3)
    images = smooth_images(8, 2, 96, 128)
    got = weights.whiten_superpoint_descriptors(tree, images, device="cpu")
    want = jax_weights.whiten_superpoint_descriptors(tree, images)
    assert got.keys() == want.keys()
    for name in want:
        for leaf in ("w", "b"):
            g, w = got[name][leaf], want[name][leaf]
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            if name != "convDb":
                assert g.tobytes() == w.tobytes()  # untouched
            else:
                np.testing.assert_allclose(g, w, atol=1e-3 * np.abs(w).max(), rtol=0)
    # the point of it: the whitened descriptors spread out
    raw = superpoint.forward_raw_descriptors(weights.params_from_numpy(got),
                                             torch.from_numpy(images), policy=FP32).numpy()
    flat = raw.reshape(-1, 256)
    flat = flat / np.linalg.norm(flat, axis=1, keepdims=True)
    cos = flat @ flat.T
    assert np.median(np.abs(cos[np.triu_indices(len(flat), 1)])) < 0.5


def test_whitening_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = jax_weights.init_superpoint(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        weights.whiten_superpoint_descriptors(tree, smooth_images(0, 1, 64, 96))
