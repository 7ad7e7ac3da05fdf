"""The port's CLIs (cli/convert.py, cli/demo_mono.py, cli/bench.py) on the
CPU, against the JAX CLIs and the JAX session + host on the same inputs."""

import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from lightglue_tpu.cli import bench as jax_bench_cli
from lightglue_tpu.cli import convert as jax_convert_cli
from lightglue_tpu.config import LightGlueConfig as JLGC
from lightglue_tpu.config import PipelineConfig as JPC
from lightglue_tpu.config import SuperPointConfig as JSPC
from lightglue_tpu.precision import Precision as JPrecision
from lightglue_tpu.runtime import host as jax_host
from lightglue_tpu.runtime.session import MatcherSession as JaxSession
from lightglue_tpu_torch.cli import bench, convert, demo_mono
from lightglue_tpu_torch.config import LightGlueConfig, PipelineConfig, SuperPointConfig
from lightglue_tpu_torch.precision import Precision
from lightglue_tpu_torch.runtime import weights
from lightglue_tpu_torch.runtime.session import MatcherSession

from test_torch_host import one_torch_thread  # noqa: F401 (autouse)
from test_torch_weights_pth import assert_trees_equal
from torch_oracle import make_lightglue_state_dict, make_superpoint_state_dict

ROOT = Path(__file__).resolve().parent.parent
HW = (64, 96)


def sequence_frames(n=4, h=HW[0], w=HW[1], step=(6, 9), seed=21):
    """n (h, w, 3) uint8 RGB frames: shifted crops of one smoothed colour
    noise field (a camera panning over a textured scene)."""
    rng = np.random.default_rng(seed)
    dy, dx = step
    field = rng.random((h + n * dy + 4, w + n * dx + 4, 3))
    field = sum(field[i:i + h + n * dy, j:j + w + n * dx] for i in range(5) for j in range(5))
    field = (field - field.min()) / (field.max() - field.min())
    return [np.ascontiguousarray((field[k * dy:k * dy + h, k * dx:k * dx + w] * 255)
                                 .astype(np.uint8)) for k in range(n)]


@pytest.fixture(scope="module")
def frame_dir(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("frames")
    for k, rgb in enumerate(sequence_frames()):
        cv2.imwrite(str(d / f"frame_{k:02d}.png"), rgb[..., ::-1])
    return d


# ---- convert ---------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("pth")
    sp, lg = d / "superpoint_v1.pth", d / "superpoint_lightglue.pth"
    torch.save(make_superpoint_state_dict(seed=1), sp)
    torch.save(make_lightglue_state_dict(seed=2, n_layers=2), lg)
    return str(sp), str(lg)


def test_convert_round_trips_and_equals_jax_cli(checkpoints, tmp_path, monkeypatch, capsys):
    sp, lg = checkpoints
    out = str(tmp_path / "port.npz")
    convert.main(["--superpoint", sp, "--lightglue", lg, "--out", out])
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"converted SuperPoint: \d+ tensors", lines[0])
    assert re.fullmatch(r"converted LightGlue: \d+ tensors", lines[1])
    assert lines[2] == f"wrote {out}"
    tree = weights.load_npz(out)
    assert_trees_equal(tree["superpoint"], weights.superpoint_from_state_dict(
        weights.load_torch_checkpoint(sp)))
    assert_trees_equal(tree["lightglue"], weights.lightglue_from_state_dict(
        weights.load_torch_checkpoint(lg)))
    jax_out = str(tmp_path / "jax.npz")
    monkeypatch.setattr(sys, "argv", ["convert", "--superpoint", sp, "--lightglue", lg,
                                      "--out", jax_out])
    jax_convert_cli.main()
    assert capsys.readouterr().out.splitlines() == [*lines[:2], f"wrote {jax_out}"]
    assert_trees_equal(tree, weights.load_npz(jax_out))
    with pytest.raises(SystemExit, match="provide --superpoint"):
        convert.main(["--out", out])


def test_convert_as_a_module(checkpoints, tmp_path):
    out = tmp_path / "sp.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "lightglue_tpu_torch.cli.convert", "--superpoint",
         checkpoints[0], "--out", str(out)],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert proc.returncode == 0, proc.stderr
    assert "converted SuperPoint" in proc.stdout
    assert set(weights.load_npz(str(out))) == {"superpoint"}


# ---- demo ------------------------------------------------------------------

DEMO_LINES = [
    r"args: .*device=cpu.*image_dir=.*proxy_whiten=True.*",
    r"proxy weights: descriptor head ZCA-whitened on frame 0",
    r"warming up \(64x96, buckets \(256, 384, 512, 640, 768, 896, 1024\)\)\.\.\.",
    r"warmup \(compile all buckets\): \d+\.\ds",
    *[r"pair +\d+ \[ ?\d+, ?\d+\]: kpts \d+/\d+  matches +\d+  ransac inliers +\d+  "
      r"sp +\d+\.\d\d ms  lg +\d+\.\d\d ms"] * 2,
    "-" * 72,
    r"avg over 2 pairs: superpoint \d+\.\d\d ms, lightglue \d+\.\d\d ms, matches \d+\.\d, "
    r"inliers \d+\.\d",
    r"warm avg \(excl\. first 1 pairs\): superpoint \d+\.\d\d ms, lightglue \d+\.\d\d ms",
    r"\(host wall-clock incl\. dispatch; see cli\.bench for device-true latency\)",
]


def test_demo_runs_on_frames(frame_dir, tmp_path, monkeypatch, capsys):
    warm = MatcherSession.warmup
    warmed = []

    def smallest_bucket_only(self, image_hw, batch=1, pairs=None):
        b = min(self.config.buckets)
        warmed.append((image_hw, b))
        return warm(self, image_hw, batch, pairs=[(b, b)])

    monkeypatch.setattr(MatcherSession, "warmup", smallest_bucket_only)
    out_dir = tmp_path / "renders"
    demo_mono.main(["--image_dir", str(frame_dir), "--out_dir", str(out_dir), "--pairs", "2",
                    "--height", "64", "--width", "96", "--precision", "fp32",
                    "--threshold", "0", "--proxy_whiten", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert warmed == [(HW, 256)]
    assert len(lines) == len(DEMO_LINES), lines
    for line, pattern in zip(lines, DEMO_LINES):
        assert re.fullmatch(pattern, line), (line, pattern)
    counts = [int(re.search(r"matches +(\d+)", line).group(1)) for line in lines[4:6]]
    assert all(counts), lines
    assert sorted(p.name for p in out_dir.iterdir()) == ["match_000.jpg", "match_001.jpg"]


def test_demo_stops_without_a_frame_directory(tmp_path):
    with pytest.raises(SystemExit, match="not a directory"):
        demo_mono.main(["--image_dir", str(tmp_path / "missing"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="not a directory"):
        demo_mono.main(["--device", "cpu"])


def _match_set(kpts0, kpts1, scores):
    return {(tuple(a), tuple(b)): s for a, b, s in zip(kpts0, kpts1, scores)}


def test_match_frames_matches_jax_session_and_host():
    """The demo's per-pair function on synthetic frames against JAX's
    session + host, FP32, threshold 0, 2 layers, buckets (128, 256):
    keypoint counts exact, match sets at IoU > 0.95 with scores at 1e-4;
    where the two match sets are equal, RANSAC's inliers too."""
    kw = dict(buckets=(128, 256), match_threshold=0.0, max_matches=256)
    sp, lg = weights.init_superpoint(13), weights.init_lightglue(14, LightGlueConfig(n_layers=2))
    jax_session = JaxSession(sp, lg, config=JPC(
        superpoint=JSPC(max_num_keypoints=256), lightglue=JLGC(n_layers=2),
        precision=JPrecision.FP32, **kw), compile_cache_dir=None)
    session = MatcherSession(sp, lg, config=PipelineConfig(
        superpoint=SuperPointConfig(max_num_keypoints=256), lightglue=LightGlueConfig(n_layers=2),
        precision=Precision.FP32, **kw), device="cpu")
    frames = sequence_frames()
    for i0, i1 in ((0, 1), (3, 1)):
        got = demo_mono.match_frames(session, frames[i0], frames[i1], HW, seed=888)
        img0 = jax_host.preprocess_image(frames[i0], HW)
        img1 = jax_host.preprocess_image(frames[i1], HW)
        ext0, ext1 = jax_session.extract(img0[None]), jax_session.extract(img1[None])
        _, matches = jax_session.match_from_extractions(ext0, ext1)
        count = int(matches.count[0])
        idx = np.asarray(matches.indices[0, :count])
        m0 = np.asarray(ext0.keypoints[0])[idx[:, 0]]
        m1 = np.asarray(ext1.keypoints[0])[idx[:, 1]]
        assert got["num_keypoints0"] == int(ext0.count[0]) > 10
        assert got["num_keypoints1"] == int(ext1.count[0])
        ours = _match_set(got["matched_kpts0"], got["matched_kpts1"], got["match_scores"])
        theirs = _match_set(m0, m1, np.asarray(matches.scores[0, :count]))
        assert theirs, "JAX found no matches; the comparison would be vacuous"
        iou = len(ours.keys() & theirs.keys()) / len(ours.keys() | theirs.keys())
        assert iou > 0.95, (len(ours), len(theirs), iou)
        for key in ours.keys() & theirs.keys():
            np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-4, atol=1e-4)
        if np.array_equal(got["matched_kpts0"], m0) and np.array_equal(got["matched_kpts1"], m1):
            inliers, mask, _ = jax_host.ransac_fundamental(m0, m1, 500, 3.0, 888)
            assert got["inliers"] == inliers
            np.testing.assert_array_equal(got["inlier_mask"], mask)


# ---- bench -----------------------------------------------------------------


def _shape(line):
    """A console line with its numbers blanked."""
    return re.sub(r"\d+(\.\d+)?", "#", line)


@pytest.mark.parametrize("args", [
    ["--all", "--kpts", "128", "--height", "64", "--width", "96"],
    ["--model", "lightglue", "--precision", "fp32", "--kpts", "128"],
    ["--model", "superpoint", "--precision", "fp32", "--height", "64", "--width", "96"],
], ids=["all", "lightglue", "superpoint"])
def test_bench_prints_the_jax_cli_lines_and_keys(args, monkeypatch, capsys):
    bench.main([*args, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu (host clock)"
    result = json.loads(lines[-1])
    for st in result.values():
        assert set(st) <= {"p50", "min", "spread_pct", "reps", "outlier_contaminated"}
        assert len(st["reps"]) == bench.REPEATS and st["p50"] > 0 and np.isfinite(st["p50"])
        assert st["min"] == min(st["reps"])

    # the JAX CLI on the same flags, its timing functions stubbed (they are
    # JAX bench.py's, which this test does not run)
    record = {"p50": 1.5, "min": 1.25, "spread_pct": 2.5, "reps": [1.5] * 5}
    stub = types.ModuleType("bench")
    stub.bench_lightglue = lambda *a, **k: dict(record)
    stub.bench_superpoint = lambda *a, **k: dict(record)
    monkeypatch.setitem(sys.modules, "bench", stub)
    monkeypatch.setattr(sys, "argv", ["bench", *args])
    jax_bench_cli.main()
    jax_lines = capsys.readouterr().out.splitlines()
    assert list(result) == list(json.loads(jax_lines[-1]))
    assert [_shape(x) for x in lines[1:-1]] == [_shape(x) for x in jax_lines[:-1]]
