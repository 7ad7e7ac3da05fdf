"""trtexec-equivalent benchmark CLI (counterpart of ``lightglue_tpu/cli/bench.py``,
reference steps.txt:50-227 recipes): per-config device latency and
throughput of what the session serves, with the JAX CLI's flags, console
lines and result keys.

Method: the step runs as the session's own CUDA graph with its inputs
already in place (``MatcherSession._match_fn(n, n, full=True, batch=B)``:
LightGlue unmasked at fixed depth and the match filter, weights from seed 0,
INT8 quantized as the session does; ``_extract_fn(1, H, W)``: SuperPoint and
keypoint selection), so no host-to-device copy and no Python is timed.
After a warm-up, each of ``REPEATS`` reps times ``ITERS`` replays between
two CUDA events. A row reports {p50, min, spread_pct, reps} in ms per step:
p50 and min of the reps, the spread of the reps with the fastest and
slowest dropped, the raw reps, and ``outlier_contaminated`` where that
spread exceeds 25 % (JAX ``bench.py:_timed``). Inputs follow JAX
``bench.py:bench_lightglue`` / ``bench_superpoint``: keypoints uniform in
(-1, 1), descriptors normal, a uniform random image, all from seed 0.

``--device cpu`` times the eager bodies with the host clock instead; it
exists so that tests can drive the CLI, and its numbers are no device's.

Usage examples:
  python -m lightglue_tpu_torch.cli.bench --model lightglue --precision bf16 \\
      --kpts 1024 --batch 1
  python -m lightglue_tpu_torch.cli.bench --model superpoint --height 480 --width 640
  python -m lightglue_tpu_torch.cli.bench --all
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from lightglue_tpu_torch.config import PipelineConfig
from lightglue_tpu_torch.precision import Precision
from lightglue_tpu_torch.runtime.session import MatcherSession, resolve_device

ITERS = 20  # graph replays per rep on a card (one eager call per rep on the CPU)
WARMUP = 3
REPEATS = 5
OUTLIER_SPREAD_PCT = 25.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", choices=["lightglue", "superpoint"],
                   default="lightglue")
    p.add_argument("--precision", default="bf16",
                   choices=["fp32", "mixed", "bf16", "int8"])
    p.add_argument("--kpts", type=int, default=1024)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--all", action="store_true",
                   help="run the full precision x model matrix")
    p.add_argument("--device", default="cuda",
                   help="torch device: the card by default; 'cpu' only drives the CLI")
    return p.parse_args(argv)


def _stats(est) -> dict:
    """JAX ``bench.py:_timed``'s record of per-step estimates (ms)."""
    p50 = float(np.median(est))
    trimmed = sorted(est)[1:-1] if len(est) >= 3 else sorted(est)
    spread = (max(trimmed) - min(trimmed)) / p50 * 100.0
    out = {
        "p50": round(p50, 3),
        "min": round(min(est), 3),
        "spread_pct": round(spread, 1),
        "reps": [round(e, 3) for e in est],
    }
    if spread > OUTLIER_SPREAD_PCT:
        out["outlier_contaminated"] = True
    return out


def _time(step, device: torch.device) -> dict:
    """ms per ``step()``: CUDA events around ``ITERS`` steps on a card, the
    host clock around one step on the CPU."""
    if device.type != "cuda":
        step()
        est = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            step()
            est.append((time.perf_counter() - t0) * 1e3)
        return _stats(est)
    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize(device)
    est = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            step()
        end.record()
        end.synchronize()
        est.append(start.elapsed_time(end) / ITERS)
    return _stats(est)


def _session(precision: str, device):
    return MatcherSession(config=PipelineConfig(precision=Precision(precision)), seed=0,
                          device=device)


def bench_lightglue(precision: str, n: int = 1024, batch: int = 1, device=None) -> dict:
    """The session's full-bucket match step (LightGlue unmasked at fixed
    depth, 9 layers, and the match filter) on ``batch`` pairs of ``n``
    keypoints, as a graph replay (JAX ``bench.py:bench_lightglue`` at the
    CLI's arguments)."""
    session = _session(precision, device)
    rng = np.random.default_rng(0)
    kpts0 = rng.uniform(-1, 1, (batch, n, 2)).astype(np.float32)
    kpts1 = rng.uniform(-1, 1, (batch, n, 2)).astype(np.float32)
    desc0 = rng.standard_normal((batch, n, 256), dtype=np.float32)
    desc1 = rng.standard_normal((batch, n, 256), dtype=np.float32)
    count = np.full((batch,), n, np.int32)
    inputs = [torch.from_numpy(a).to(session.device)
              for a in (kpts0, kpts1, desc0, desc1, count, count)]
    runner = session._match_fn(n, n, full=True, batch=batch)
    with torch.inference_mode():
        runner(*inputs)  # on a card: the eager warm-up and the capture
        step = runner.graph.replay if session._graphs else lambda: runner(*inputs)
        return _time(step, session.device)


def bench_superpoint(precision: str, h: int = 480, w: int = 640, device=None) -> dict:
    """The session's extraction (SuperPoint and keypoint selection) of one
    (h, w) image, as a graph replay (JAX ``bench.py:bench_superpoint``)."""
    session = _session(precision, device)
    image = np.random.default_rng(0).random((1, h, w, 1), dtype=np.float32)
    runner = session._extract_fn(1, h, w)
    with torch.inference_mode():
        runner(image)
        step = runner.graph.graph.replay if session._graphs else lambda: runner(image)
        return _time(step, session.device)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (host clock)"
    print(f"device: {name}")
    results = {}
    if args.all:
        for prec in ("fp32", "mixed", "bf16", "int8"):
            st = bench_lightglue(prec, args.kpts, args.batch, device)
            results[f"lightglue_{prec}_{args.batch}x{args.kpts}_ms"] = st
            ms = st["p50"]
            print(f"lightglue {prec:5s} {args.batch}x{args.kpts}: {ms:.3f} ms "
                  f"+-{st['spread_pct']:.1f}% ({1e3 / ms * args.batch:.1f} pairs/s)")
        st = bench_superpoint("bf16", args.height, args.width, device)
        results["superpoint_bf16_ms"] = st
        print(f"superpoint bf16 {args.height}x{args.width}: {st['p50']:.3f} ms "
              f"+-{st['spread_pct']:.1f}%")
    elif args.model == "lightglue":
        st = bench_lightglue(args.precision, args.kpts, args.batch, device)
        results[f"lightglue_{args.precision}_ms"] = st
        ms = st["p50"]
        print(
            f"lightglue {args.precision} {args.batch}x{args.kpts}x{args.kpts}: "
            f"{ms:.3f} ms/step +-{st['spread_pct']:.1f}% "
            f"({1e3 / ms * args.batch:.1f} pairs/s)"
        )
    else:
        st = bench_superpoint(args.precision, args.height, args.width, device)
        results["superpoint_ms"] = st
        print(
            f"superpoint {args.precision} {args.height}x{args.width}: "
            f"{st['p50']:.3f} ms +-{st['spread_pct']:.1f}% "
            f"({1e3 / st['p50']:.1f} images/s)"
        )
    print(json.dumps(results))


if __name__ == "__main__":
    main()
