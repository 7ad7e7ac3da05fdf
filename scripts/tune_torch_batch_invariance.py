"""Whether SuperPoint's result for an image depends on the batch it came in,
and what running its cuDNN convs one image at a time costs, on one CUDA card.

``models/superpoint.py:_conv`` (conv3a..convDb, ``F.conv2d``) convolves
each image of a batch alone. ``batched_conv`` below is the one-call form it
replaced: cuDNN picks its algorithm by the whole shape, batch included.

1. For BF16 and FP32, with ``batched_conv``: the encoder and descriptor
   head layer by layer on one 480x640 frame alone and in a batch of two,
   the number of outputs that differ per layer; then whole extractions
   (``MatcherSession.extract``) of the frame alone and in the batch, field
   by field, with the batched and the per-image convs. The SuperPoint
   weights are proxy-whitened on the frame, as ``cli/demo_mono.py
   --proxy_whiten`` does.
2. Three rounds, alternating which form runs first: ms of
   ``match_pair`` (480x640, 9 layers; host clock, median of 30) and of a
   4-pair ``match_batch`` (median of 10), and the device ms of the batch-2
   extraction graph (CUDA events around 20 replays, median of 5), at BF16
   and FP32, with each form.

From the root of a checkout, on a machine with a CUDA card:

    python3 scripts/tune_torch_batch_invariance.py
"""

import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from lightglue_tpu_torch.config import PipelineConfig  # noqa: E402
from lightglue_tpu_torch.kernels import stem  # noqa: E402
from lightglue_tpu_torch.models import superpoint as sp_mod  # noqa: E402
from lightglue_tpu_torch.precision import Precision, precision_scope  # noqa: E402
from lightglue_tpu_torch.runtime import host, weights  # noqa: E402
from lightglue_tpu_torch.runtime.session import MatcherSession  # noqa: E402

PER_IMAGE = sp_mod._conv


def batched_conv(p, x):
    """``_conv`` as one cuDNN call over the whole batch."""
    w = p["w"].to(x.dtype).float()
    out = F.conv2d(x.permute(0, 3, 1, 2).float(), w, padding=w.shape[-1] // 2)
    return (out.permute(0, 2, 3, 1) + p["b"]).to(x.dtype)


def layers(p):
    return [
        ("conv1a (stem.cu)", lambda x: stem.relu_conv1a_shift(x, p["conv1a"]["w"],
                                                               p["conv1a"]["b"])),
        ("conv1b+pool (conv3x3.cu)", lambda x: sp_mod._kernel_conv(p["conv1b"], x, pool=True)),
        ("conv2a (conv3x3.cu)", lambda x: sp_mod._kernel_conv(p["conv2a"], x, pool=False)),
        ("conv2b+pool (conv3x3.cu)", lambda x: sp_mod._kernel_conv(p["conv2b"], x, pool=True)),
        ("conv3a", lambda x: sp_mod._relu_conv(p["conv3a"], x)),
        ("conv3b+pool", lambda x: sp_mod._max_pool_2x2(sp_mod._relu_conv(p["conv3b"], x))),
        ("conv4a", lambda x: sp_mod._relu_conv(p["conv4a"], x)),
        ("conv4b", lambda x: sp_mod._relu_conv(p["conv4b"], x)),
        ("convDa", lambda x: sp_mod._relu_conv(p["convDa"], x)),
        ("convDb", lambda x: sp_mod._conv(p["convDb"], x)),
    ]


def host_ms(fn, n):
    fn()
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


@torch.inference_mode()
def graph_ms(runner, images):
    runner(images)
    graph = runner.graph.graph
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 20)
    return statistics.median(times)


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    frames = cs.demo_frames()
    hw = (480, 640)
    imgs = [host.preprocess_image(f, hw) for f in frames]
    proxy = weights.whiten_superpoint_descriptors(weights.init_superpoint(0), imgs[0][None],
                                                  device="cuda")
    one, two = imgs[0][None], np.stack([imgs[0], imgs[3]])

    for prec in ("bf16", "fp32"):
        sp_mod._conv = batched_conv
        session = MatcherSession(proxy, None, PipelineConfig(precision=Precision(prec)),
                                 device="cuda")
        dt = session.policy.act_dtype
        xa = torch.from_numpy(one).cuda().to(dt)
        xb = torch.from_numpy(two).cuda().to(dt)
        with torch.inference_mode(), precision_scope(session.policy):
            for name, layer in layers(session.sp_params):
                xa, xb = layer(xa), layer(xb)
                d = (xa.float() - xb[:1].float()).abs()
                print(f"{prec} batched convs, {name}: the frame alone vs in a batch of 2: "
                      f"{int((d > 0).sum())} of {d.numel()} outputs differ, max "
                      f"{float(d.max()):.3e}", flush=True)
        for label, conv in (("batched", batched_conv), ("per-image", PER_IMAGE)):
            sp_mod._conv = conv
            session = MatcherSession(proxy, None, PipelineConfig(precision=Precision(prec)),
                                     device="cuda")
            alone, batch = session.extract(one), session.extract(two)
            diff = {f: float((getattr(alone, f)[0].float() - getattr(batch, f)[0].float())
                             .abs().max()) for f in alone._fields}
            print(f"{prec} {label} convs, extract of the frame alone vs in a batch of 2: "
                  f"max difference per field {diff}", flush=True)
    sp_mod._conv = PER_IMAGE

    img0, img1 = cs.smooth_pair(0)
    b0, b1 = np.stack([img0, img1, img1, img0]), np.stack([img1, img0, img0, img1])
    results = {}
    for rnd in range(3):
        order = ("batched", "per-image") if rnd % 2 == 0 else ("per-image", "batched")
        for label in order:
            sp_mod._conv = batched_conv if label == "batched" else PER_IMAGE
            for prec in ("bf16", "fp32"):
                session = MatcherSession(config=PipelineConfig(precision=Precision(prec)),
                                         device="cuda")
                row = (host_ms(lambda: session.match_pair(img0, img1), 30),
                       host_ms(lambda: session.match_batch(b0, b1), 10),
                       graph_ms(session._extract_fn(2, *hw), np.stack([img0, img1])))
                results.setdefault((prec, label), []).append(row)
                print(f"round {rnd} {prec} {label}: match_pair {row[0]:.3f} ms, match_batch "
                      f"(4 pairs) {row[1]:.3f} ms, batch-2 extraction graph {row[2]:.4f} ms",
                      flush=True)
    sp_mod._conv = PER_IMAGE
    for (prec, label), rows in sorted(results.items()):
        med = [statistics.median(r[i] for r in rows) for i in range(3)]
        print(f"{prec} {label}: medians of 3 rounds: match_pair {med[0]:.3f} ms, match_batch "
              f"{med[1]:.3f} ms, batch-2 extraction {med[2]:.4f} ms")


if __name__ == "__main__":
    main()
