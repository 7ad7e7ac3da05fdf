"""Port weights: same numpy stream as the JAX package, layout conversion, npz IO."""

import numpy as np
import pytest
import torch

from lightglue_tpu.config import LightGlueConfig as JaxLightGlueConfig
from lightglue_tpu.runtime import weights as jax_weights
from lightglue_tpu_torch.config import LightGlueConfig
from lightglue_tpu_torch.runtime import weights


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("which", ["lightglue", "superpoint"])
def test_init_equals_jax_init(which):
    if which == "lightglue":
        ours = weights.init_lightglue(5, LightGlueConfig(n_layers=2))
        want = jax_weights.init_lightglue(5, JaxLightGlueConfig(n_layers=2))
    else:
        ours = weights.init_superpoint(5)
        want = jax_weights.init_superpoint(5)
    ours_l, want_l = dict(_leaves(ours)), dict(_leaves(want))
    assert ours_l.keys() == want_l.keys()
    for key, a in want_l.items():
        b = ours_l[key]
        assert b.dtype == np.asarray(a).dtype, key
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=key)


def test_params_from_numpy_layouts():
    tree = weights.init_lightglue(1, LightGlueConfig(n_layers=2))
    p = weights.params_from_numpy(tree, "cpu", torch.bfloat16)
    sa, ca = tree["layers"]["self_attn"], tree["layers"]["cross_attn"]
    qkv = p["layers"]["self_attn"]["qkv"]
    assert qkv["w"].shape == (2, 256, 768) and qkv["w"].dtype == torch.bfloat16
    for c in range(3):  # columns [q | k | v]
        np.testing.assert_array_equal(
            qkv["w"][:, :, c * 256:(c + 1) * 256].float().numpy(),
            torch.as_tensor(sa["qkv"]["w"][:, c]).to(torch.bfloat16).float().numpy(),
        )
        np.testing.assert_array_equal(
            qkv["b"][:, c * 256:(c + 1) * 256].float().numpy(),
            torch.as_tensor(sa["qkv"]["b"][:, c]).to(torch.bfloat16).float().numpy(),
        )
    qk_v = p["layers"]["cross_attn"]["qk_v"]
    assert "qk" not in p["layers"]["cross_attn"] and qk_v["w"].shape == (2, 256, 512)
    np.testing.assert_array_equal(qk_v["w"][..., 256:].float().numpy(),
                                  torch.as_tensor(ca["v"]["w"]).to(torch.bfloat16).float().numpy())

    sp = weights.init_superpoint(1)
    ps = weights.params_from_numpy(sp, "cpu")
    assert ps["conv1b"]["w"].shape == (3, 3, 64, 64)  # kernel conv: HWIO
    assert ps["conv3a"]["w"].shape == (128, 64, 3, 3)  # F.conv2d: OIHW
    np.testing.assert_array_equal(ps["conv3a"]["w"].numpy(),
                                  sp["conv3a"]["w"].transpose(3, 2, 0, 1))
    assert ps["conv1a"]["w"].dtype == torch.float32


def test_npz_round_trip_reads_jax_archives(tmp_path):
    tree = weights.init_lightglue(2, LightGlueConfig(n_layers=2))
    path = str(tmp_path / "lg.npz")
    jax_weights.save_npz(tree, path)  # written by the JAX package
    back = weights.load_npz(path)
    ours_path = str(tmp_path / "lg2.npz")
    weights.save_npz(back, ours_path)
    again = jax_weights.load_npz(ours_path)
    want = dict(_leaves(tree))
    for got in (dict(_leaves(back)), dict(_leaves(again))):
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
