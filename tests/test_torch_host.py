"""Port runtime/host.py and utils/{image,profiling,viz}.py against the JAX
package's.

Both bindings run the C++ of native/lgtpu_native.cpp (the port builds its
own copy under build/torch_native/), so the native results must be equal
bit for bit; the port's numpy rendering of the preprocessing loop is held
to the native call at 1e-6 abs."""

import numpy as np
import pytest
import torch

from lightglue_tpu.runtime import host as jax_host
from lightglue_tpu.utils import image as jax_image
from lightglue_tpu_torch.runtime import host
from lightglue_tpu_torch.utils import image

from test_native import _epipolar_pair


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's tests (imported by the other
    entry-point test files): the suite runs six worker processes on a few
    cores, where torch's thread per core oversubscribes them (the CPU demo
    test took 2 s alone and 107 s in the suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_native_builds_under_build_not_native():
    path = host.build()
    assert host.native_available()
    assert path.parent == host.BUILD_DIR and path.parent.parent.name == "build"
    assert path.parent != host.SOURCE.parent  # never into native/


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(host, "SOURCE", bad)
    monkeypatch.setattr(host, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(host, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on broken.cpp"):
        host.lib()
    assert not host.native_available()
    assert not list((tmp_path / "out").glob("*.so"))


@pytest.mark.parametrize("hw,out_hw", [((100, 140), (50, 70)), ((64, 96), (64, 96)),
                                       ((37, 53), (80, 120)), ((480, 640), (240, 320))])
def test_preprocess_equals_jax_and_plain(hw, out_hw):
    rgb = (np.random.default_rng(sum(hw)).random((*hw, 3)) * 255).astype(np.uint8)
    got = host.preprocess_image(rgb, out_hw)
    want = jax_host.preprocess_image(rgb, out_hw)
    assert got.shape == (*out_hw, 1) and got.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    plain = host.preprocess_image_plain(rgb, out_hw)
    assert plain.shape == got.shape and plain.dtype == np.float32
    np.testing.assert_allclose(plain, got, atol=1e-6, rtol=0)


def test_ransac_equals_jax(rng):
    pts0, pts1, labels = _epipolar_pair(rng)
    for iters, thr, seed in ((800, 2.0, 888), (500, 3.0, 7)):
        count, mask, F = host.ransac_fundamental(pts0, pts1, iters, thr, seed)
        jcount, jmask, jF = jax_host.ransac_fundamental(pts0, pts1, iters, thr, seed)
        assert count == jcount and count == mask.sum() > 0
        np.testing.assert_array_equal(mask, jmask)
        assert F.dtype == jF.dtype == np.float64 and F.tobytes() == jF.tobytes()
    assert mask[labels].mean() > 0.95


def test_ransac_too_few_points_equals_jax():
    pts = np.zeros((5, 2), np.float32)
    got, want = host.ransac_fundamental(pts, pts), jax_host.ransac_fundamental(pts, pts)
    assert got[0] == want[0] == 0 and not got[1].any()
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_image_utils_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    rgb = (rng.random((61, 83, 3)) * 255).astype(np.uint8)
    for size in (48, (40, 56)):
        for fn in ("max", "min"):
            got, gs = image.resize_image(rgb, size, fn)
            want, ws = jax_image.resize_image(rgb, size, fn)
            assert gs == ws and got.tobytes() == want.tobytes()
    assert image.rgb_to_grayscale(rgb).tobytes() == jax_image.rgb_to_grayscale(rgb).tobytes()
    gray = image.rgb_to_grayscale(rgb)
    assert image.pad_to_multiple(gray).tobytes() == jax_image.pad_to_multiple(gray).tobytes()
    assert image.pad_to_multiple(gray).shape == (64, 88)
    import cv2

    path = str(tmp_path / "frame.png")
    cv2.imwrite(path, rgb[..., ::-1])
    for gray_flag in (False, True):
        assert (image.read_image(path, gray_flag).tobytes()
                == jax_image.read_image(path, gray_flag).tobytes())
    for resize in (None, 40, (32, 48)):
        for grayscale in (True, False):
            got, gs = image.load_image(path, resize, grayscale)
            want, ws = jax_image.load_image(path, resize, grayscale)
            assert gs == ws and got.shape == want.shape and got.tobytes() == want.tobytes()


def test_profiling_utils_equal_jax(tmp_path):
    from lightglue_tpu.utils.profiling import SectionTimer as JaxSectionTimer
    from lightglue_tpu_torch.utils import profiling

    timer, jax_timer = profiling.SectionTimer(), JaxSectionTimer()
    for t in (timer, jax_timer):
        t.samples["extract"].extend([1.5, 2.25, 0.75, 3.0])
        t.samples["match"].append(4.0)
    assert timer.summary() == jax_timer.summary() and timer.report() == jax_timer.report()
    with timer.section("host"):
        timer.block({"out": (torch.ones(2), [torch.zeros(1)])})  # CPU tensors: nothing to wait on
    assert timer.summary()["host"]["count"] == 1
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_viz_utils_equal_jax(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    from lightglue_tpu.utils import viz as jax_viz
    from lightglue_tpu_torch.utils import viz

    x = np.linspace(-1.2, 1.2, 25, dtype=np.float32)
    for name in ("cm_RdGn", "cm_BlRdGn", "cm_prune"):
        np.testing.assert_array_equal(getattr(viz, name)(x), getattr(jax_viz, name)(x))
    rng = np.random.default_rng(0)
    images = [rng.random((40, 60, 1)).astype(np.float32), rng.random((40, 50))]
    fig, axes = viz.plot_images(images, titles=["a", "b"])
    k0, k1 = rng.uniform(0, 40, (6, 2)), rng.uniform(0, 40, (6, 2))
    viz.plot_keypoints(axes, [k0, k1])
    viz.plot_matches(axes, k0, k1, scores=rng.random(6))
    viz.plot_pruning(axes, [k0, k1], [np.arange(6), np.arange(6)])
    viz.add_text(axes[0], "6 matches")
    viz.save_plot(fig, str(tmp_path / "matches.png"))
    assert (tmp_path / "matches.png").stat().st_size > 0
