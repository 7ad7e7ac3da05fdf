"""Port SuperPoint forward(nms=False) + extract_keypoints(raw_scores=True)
(plain versions on the CPU) against the JAX package at FP32."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.config import SuperPointConfig as JaxSuperPointConfig
from lightglue_tpu.models import superpoint as jax_sp
from lightglue_tpu.pipeline import extract as jax_extract
from lightglue_tpu.precision import Precision as JaxPrecision
from lightglue_tpu.precision import policy_for as jax_policy_for
from lightglue_tpu.runtime import weights as jax_weights
from lightglue_tpu_torch.config import SuperPointConfig
from lightglue_tpu_torch.models import superpoint
from lightglue_tpu_torch.pipeline import extract
from lightglue_tpu_torch.precision import Precision, policy_for
from lightglue_tpu_torch.runtime import weights


def smooth_images(seed, b, h, w):
    rng = np.random.default_rng(seed)
    x = rng.random((b, h + 4, w + 4)).astype(np.float32)
    x = sum(x[:, i:i + h, j:j + w] for i in range(5) for j in range(5)) / 25.0
    x = (x - x.min()) / (x.max() - x.min())
    return np.ascontiguousarray(x[..., None], dtype=np.float32)


# (H, W, k): 96x128 takes the JAX paired-conv kernels, 96x120 (W % 16 != 0)
# the XLA conv fallback (extract.py:218-222); k = 1024 at 96x120 has fewer
# tile candidates than k and takes the dense simple_nms + top-k path
@pytest.mark.parametrize("h,w,k", [(96, 128, 256), (96, 120, 256), (96, 120, 1024)])
def test_superpoint_extract_matches_jax(h, w, k):
    tree = jax_weights.init_superpoint(2)
    images = smooth_images(h + w + k, 2, h, w)
    jcfg = JaxSuperPointConfig(max_num_keypoints=k)
    jscores, jdesc = jax_sp.forward(
        jax_weights.to_jax(tree), jnp.asarray(images), config=jcfg,
        policy=jax_policy_for(JaxPrecision.FP32), nms=False,
    )
    want = jax_extract.extract_keypoints(jscores, jdesc, config=jcfg, raw_scores=True)

    cfg = SuperPointConfig(max_num_keypoints=k)
    scores, desc = superpoint.forward(
        weights.params_from_numpy(tree, "cpu"), torch.from_numpy(images), config=cfg,
        policy=policy_for(Precision.FP32), nms=False,
    )
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(desc.numpy(), np.asarray(jdesc), atol=1e-4, rtol=0)
    got = extract.extract_keypoints(scores, desc, config=cfg, raw_scores=True)

    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    for i in range(images.shape[0]):
        n = int(want.count[i])
        assert n > 10
        ours = {tuple(p): j for j, p in enumerate(got.keypoints[i, :n].numpy())}
        theirs = {tuple(p): j for j, p in enumerate(np.asarray(want.keypoints[i, :n]))}
        # only the tie order at the k-th score may differ (extract.py docstring)
        assert len(ours.keys() ^ theirs.keys()) <= 2, len(ours.keys() ^ theirs.keys())
        for p in ours.keys() & theirs.keys():
            a, b = ours[p], theirs[p]
            np.testing.assert_allclose(float(got.scores[i, a]), float(want.scores[i, b]),
                                       rtol=1e-4, atol=1e-7)
            np.testing.assert_allclose(got.descriptors[i, a].numpy(),
                                       np.asarray(want.descriptors[i, b]), atol=1e-4)
            np.testing.assert_allclose(got.keypoints_norm[i, a].numpy(),
                                       np.asarray(want.keypoints_norm[i, b]), atol=1e-6)


def test_cudnn_convs_run_one_image_at_a_time(monkeypatch):
    """forward's F.conv2d convs (conv3a..convDb) take one image each: cuDNN
    picks its algorithm by the whole shape, so on a card a batched call
    made an image's descriptors depend on the batch it came in."""
    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(x, *args, **kwargs):
        if sys._getframe(1).f_code is superpoint._conv.__code__:  # not the kernels' plain versions
            seen.append(x.shape[0])
        return conv2d(x, *args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    params = weights.params_from_numpy(jax_weights.init_superpoint(0))
    images = torch.from_numpy(smooth_images(1, 3, 32, 48))
    scores, desc = superpoint.forward(params, images, policy=policy_for(Precision.FP32), nms=False)
    assert seen == [1] * (8 * 3)
    want_scores, want_desc = superpoint.forward(params, images[1:2], policy=policy_for(Precision.FP32),
                                                nms=False)
    assert torch.equal(scores[1:2], want_scores) and torch.equal(desc[1:2], want_desc)
