"""Sequence-matching demo (counterpart of ``lightglue_tpu/cli/demo_mono.py``,
the analog of the reference's demo_mono, demo/demo_mono.cpp:47-466): load an
image sequence, extract SuperPoint keypoints and match random pairs with
LightGlue on the card, verify with fundamental-matrix RANSAC, optionally
render match images, and report per-stage timings like
matches_demo_mono_0/console.txt.

Usage:
  python -m lightglue_tpu_torch.cli.demo_mono --image_dir <dir> [--out_dir out]
      [--pairs 100] [--precision bf16] [--threshold 0.5] [--weights ckpt.npz]
      [--device cuda]

``--device cpu`` runs the kernels' plain PyTorch versions on the CPU (for
tests); the default is the card, and without one the demo stops.
"""

from __future__ import annotations

import argparse
import random
import time
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image_dir", default=None, help="directory of sequence frames")
    p.add_argument("--out_dir", default=None, help="save match renders here")
    p.add_argument("--pairs", type=int, default=100)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument(
        "--precision", default="bf16", choices=["fp32", "mixed", "bf16", "int8"]
    )
    p.add_argument("--threshold", type=float, default=0.5,
                   help="match confidence threshold (demo_mono.cpp:296)")
    p.add_argument("--max_keypoints", type=int, default=1024)
    p.add_argument("--depth_confidence", type=float, default=-1.0)
    p.add_argument("--width_confidence", type=float, default=-1.0)
    p.add_argument("--downshift_layer", type=int, default=-1,
                   help="bucket-ladder downshift boundary for width pruning "
                        "(LightGlueConfig.downshift_layer)")
    p.add_argument("--weights", default=None,
                   help=".npz checkpoint with {superpoint,lightglue} trees "
                        "(see runtime.weights, cli.convert); random init if omitted")
    p.add_argument("--seed", type=int, default=888,
                   help="pair-sampling seed (srand(888), demo_mono.cpp:204)")
    p.add_argument(
        "--proxy_whiten", action="store_true",
        help="with random-init weights, ZCA-whiten the descriptor head on "
             "the first frame so match counts are meaningful",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device: the card by default, 'cpu' runs the plain versions")
    return p.parse_args(argv)


def match_frames(session, rgb0: np.ndarray, rgb1: np.ndarray, hw, seed: int = 888) -> dict:
    """The demo's per-pair work on two (H, W, 3) uint8 RGB frames: the native
    resize + grayscale to ``hw``, one extraction per frame, bucketed
    LightGlue on the two extractions, then RANSAC on the matched points.

    Returns host arrays: the keypoint counts, match indices and scores,
    matched points, RANSAC inliers and mask, and the host wall-clock ms of
    the extractions (``sp_ms``) and the match (``lg_ms``), each ending in a
    fetch of its counts."""
    from lightglue_tpu_torch.runtime import host

    img0 = host.preprocess_image(rgb0, hw)
    img1 = host.preprocess_image(rgb1, hw)
    t0 = time.perf_counter()
    ext0 = session.extract(img0[None])
    ext1 = session.extract(img1[None])
    n0, n1 = int(ext0.count[0]), int(ext1.count[0])
    t1 = time.perf_counter()
    _, matches = session.match_from_extractions(ext0, ext1)
    count = int(matches.count[0])
    t2 = time.perf_counter()

    idx = matches.indices[0, :count].cpu().numpy()
    k0 = ext0.keypoints[0].cpu().numpy()
    k1 = ext1.keypoints[0].cpu().numpy()
    m0 = k0[idx[:, 0]] if count else np.zeros((0, 2), np.float32)
    m1 = k1[idx[:, 1]] if count else np.zeros((0, 2), np.float32)
    inliers, mask, _ = host.ransac_fundamental(m0, m1, 500, 3.0, seed)
    return {
        "num_keypoints0": n0,
        "num_keypoints1": n1,
        "matches": idx,
        "match_scores": matches.scores[0, :count].cpu().numpy(),
        "matched_kpts0": m0,
        "matched_kpts1": m1,
        "inliers": inliers,
        "inlier_mask": mask,
        "sp_ms": (t1 - t0) * 1e3,
        "lg_ms": (t2 - t1) * 1e3,
    }


def main(argv=None):
    args = parse_args(argv)
    # late imports so --help stays fast
    from lightglue_tpu_torch.config import LightGlueConfig, PipelineConfig, SuperPointConfig
    from lightglue_tpu_torch.precision import Precision
    from lightglue_tpu_torch.runtime import host, weights
    from lightglue_tpu_torch.runtime.session import MatcherSession
    from lightglue_tpu_torch.utils.image import read_image

    # the console is self-documenting: every argument, the threshold included
    print("args: " + " ".join(f"{k}={v}" for k, v in sorted(vars(args).items())))
    if args.image_dir is None or not Path(args.image_dir).is_dir():
        raise SystemExit(f"--image_dir {args.image_dir}: not a directory of sequence frames")
    frames = sorted(
        str(p)
        for p in Path(args.image_dir).iterdir()
        if p.suffix.lower() in (".png", ".jpg", ".jpeg")
    )
    if len(frames) < 2:
        raise SystemExit(f"need >= 2 frames in {args.image_dir}")
    hw = (args.height, args.width)

    config = PipelineConfig(
        superpoint=SuperPointConfig(max_num_keypoints=args.max_keypoints),
        lightglue=LightGlueConfig(
            depth_confidence=args.depth_confidence,
            width_confidence=args.width_confidence,
            downshift_layer=args.downshift_layer,
        ),
        precision=Precision(args.precision),
        match_threshold=args.threshold,
        max_matches=args.max_keypoints,
    )
    sp_params = lg_params = None
    if args.weights:
        ckpt = weights.load_npz(args.weights)
        sp_params, lg_params = ckpt.get("superpoint"), ckpt.get("lightglue")
    elif args.proxy_whiten:
        sp_params = weights.init_superpoint(0, config.superpoint)
        calib = host.preprocess_image(read_image(frames[0], grayscale=False), hw)
        sp_params = weights.whiten_superpoint_descriptors(
            sp_params, calib[None], config=config.superpoint, device=args.device
        )
        print("proxy weights: descriptor head ZCA-whitened on frame 0")
    session = MatcherSession(sp_params, lg_params, config, device=args.device)

    print(f"warming up ({args.height}x{args.width}, buckets {config.buckets})...")
    t0 = time.perf_counter()
    session.warmup(hw)
    print(f"warmup (compile all buckets): {time.perf_counter() - t0:.1f}s")

    rng = random.Random(args.seed)
    out_dir = Path(args.out_dir) if args.out_dir else None
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)

    cache = {}

    def load(path):
        if path not in cache:
            cache[path] = read_image(path, grayscale=False)
        return cache[path]

    sp_ms, lg_ms, match_counts, inlier_counts = [], [], [], []
    for i in range(args.pairs):
        i0, i1 = rng.sample(range(len(frames)), 2)
        rgb0, rgb1 = load(frames[i0]), load(frames[i1])
        r = match_frames(session, rgb0, rgb1, hw, args.seed)
        count = len(r["matches"])
        sp_ms.append(r["sp_ms"])
        lg_ms.append(r["lg_ms"])
        match_counts.append(count)
        inlier_counts.append(r["inliers"])
        print(
            f"pair {i:3d} [{i0:2d},{i1:2d}]: kpts {r['num_keypoints0']}/{r['num_keypoints1']}  "
            f"matches {count:4d}  ransac inliers {r['inliers']:4d}  "
            f"sp {sp_ms[-1]:6.2f} ms  lg {lg_ms[-1]:6.2f} ms"
        )
        if out_dir is not None and count:
            _render(out_dir / f"match_{i:03d}.jpg", rgb0, rgb1, r["matched_kpts0"],
                    r["matched_kpts1"], r["inlier_mask"], hw)

    print("-" * 72)
    print(
        f"avg over {args.pairs} pairs: superpoint {np.mean(sp_ms):.2f} ms, "
        f"lightglue {np.mean(lg_ms):.2f} ms, matches {np.mean(match_counts):.1f}, "
        f"inliers {np.mean(inlier_counts):.1f}"
    )
    # the cold average holds each key's first call (its graph capture); the
    # warm average is the steady-state serving number (the reference's
    # console reports only a post-warmup loop: demo_mono.cpp records its
    # CUDA graphs up front)
    warm = max(1, min(5, len(sp_ms) - 1))
    print(
        f"warm avg (excl. first {warm} pairs): "
        f"superpoint {np.mean(sp_ms[warm:]):.2f} ms, "
        f"lightglue {np.mean(lg_ms[warm:]):.2f} ms"
    )
    print(
        "(host wall-clock incl. dispatch; see cli.bench for device-true latency)"
    )


def _render(path, rgb0, rgb1, m0, m1, inlier_mask, hw):
    try:
        import cv2
    except ImportError:
        return
    h, w = hw
    im0 = cv2.resize(rgb0[..., ::-1], (w, h))
    im1 = cv2.resize(rgb1[..., ::-1], (w, h))
    canvas = np.concatenate([im0, im1], axis=1)
    for (x0, y0), (x1, y1), ok in zip(m0, m1, inlier_mask):
        color = (0, 200, 0) if ok else (0, 0, 220)
        cv2.line(
            canvas,
            (int(x0), int(y0)),
            (int(x1) + w, int(y1)),
            color,
            1,
            cv2.LINE_AA,
        )
    cv2.imwrite(str(path), canvas)


if __name__ == "__main__":
    main()
