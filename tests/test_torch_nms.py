"""Port NMS (plain versions on the CPU) against the JAX package, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.kernels import nms as jax_nms
from lightglue_tpu_torch.kernels import _build, nms


def _tied_map(seed, b, h, w):
    """Random scores on a coarse grid (many exact ties) plus one plateau tile."""
    rng = np.random.default_rng(seed)
    s = np.floor(rng.uniform(0, 16, (b, h, w))).astype(np.float32) / 256.0
    s[:, 8:16, 16:24] = 0.25  # every pixel of one 8x8 tile tied at the max
    return s


@pytest.mark.parametrize("shape", [(2, 32, 64), (1, 40, 48), (1, 48, 128), (1, 48, 72)])
def test_nms_candidates_equals_jax_exactly(shape):
    s = _tied_map(sum(shape), *shape)
    want_v, want_i = jax_nms.nms_candidates(jnp.asarray(s), nms_radius=4, border=4, cap=4)
    got_v, got_i = nms.nms_candidates(torch.from_numpy(s), nms_radius=4, border=4, cap=4)
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


# radii and caps other than the path's (4, 4); the JAX kernel holds at most
# 8 candidates per tile
@pytest.mark.parametrize("radius,cap", [(2, 1), (2, 4), (4, 1), (4, 8), (6, 4)])
def test_nms_candidates_radius_and_cap_equal_jax(radius, cap):
    s = _tied_map(radius + cap, 1, 48, 72)
    want_v, want_i = jax_nms.nms_candidates(jnp.asarray(s), nms_radius=radius, border=4, cap=cap)
    got_v, got_i = nms.nms_candidates(torch.from_numpy(s), nms_radius=radius, border=4, cap=cap)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("radius", [2, 4])
def test_simple_nms_equals_jax_exactly(radius):
    s = _tied_map(7, 2, 40, 56)
    want = np.asarray(jax_nms.simple_nms(jnp.asarray(s), radius))
    got = nms.simple_nms(torch.from_numpy(s), radius).numpy()
    np.testing.assert_array_equal(got, want)


def test_nms_candidates_rejects_unaligned_map_before_launch():
    # a meta tensor takes the kernel branch without a card; the check runs first
    with pytest.raises(ValueError):
        nms.nms_candidates(torch.empty(1, 36, 64, device="meta"))


@pytest.mark.parametrize("radius,cap", [(-1, 4), (nms.MAX_RADIUS + 1, 4), (4, 0), (4, 65)])
def test_nms_candidates_rejects_radius_and_cap_before_launch(radius, cap):
    with pytest.raises(ValueError):
        nms.nms_candidates(torch.empty(1, 32, 64, device="meta"), radius, 4, cap)


def test_every_built_radius_fits_shared_memory():
    # csrc/nms.cu is built for radii 0..MAX_RADIUS; the launch raises the
    # block's shared memory to nms_smem_bytes(radius), which must fit
    sizes = [nms.nms_smem_bytes(r) for r in range(nms.MAX_RADIUS + 1)]
    assert max(sizes) <= _build.MAX_DYNAMIC_SMEM
