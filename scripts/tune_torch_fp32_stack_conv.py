"""Time the FP32 rung's stack attention and the model's fp32 conv of one or
more checkouts on one CUDA card, kernel by kernel and end to end.

Every checkout root given (default: this one) is measured in a process of
its own, which imports the package under ``root/src`` and runs its
kernels (each root's library built once, all roots at once, before the
first measurement). Per root:

- ``attention`` at fp32 operands and stats, the stack's calls: self with
  RoPE and cross at 1x1024 (18 launches each a pair), cross under keep
  masks at 1x1024 (the adaptive route's width pruning) and self with RoPE
  at 8x1024 (bench 8x1024's shape), each against its plain version at the
  fp32 gate (1e-4) and timed with ``chip_smoke.cuda_ms`` beside
  ``scaled_dot_product_attention`` with TF32 off (no RoPE, no masks);
- ``conv3x3`` at fp32, SuperPoint's conv1b+pool (2x480x640), conv2a and
  conv2b+pool (2x240x320), each against its plain version at 1e-4 and
  timed beside cuDNN's fp32 conv with TF32 off;
- the kernel ms and the busy share of one profiled ``match_pair`` (480x640,
  9 layers, seed-0 weights; ``chip_smoke.profile_breakdown``) and its ms
  (graphs, host clock, median of 10) at FP32 and MIXED: fixed depth,
  adaptive (``depth_confidence=0.95, width_confidence=0.99``) and the
  2048-keypoint route;
- ``cli/bench.py``'s LightGlue 1x1024 and 8x1024 steps and SuperPoint of
  one 480x640 image at FP32 and MIXED (device ms, p50 of 5 reps of 20
  graph replays);
- a digest of the kernels' outputs: two roots that print the same digest
  computed them bit for bit alike.

Roots run in the order given; give a parent first and last to bracket
drift (a parent unpacked into a git-ignored directory with ``git archive
<commit> | tar -x -C build/parent``):

    python3 scripts/tune_torch_fp32_stack_conv.py build/parent . . build/parent
"""

import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
E, HEADS, N = 256, 4, 1024
# label, batch, rope, keep masks, launches a pair
ATTENTION = (("self rope 1x1024", 1, True, False, 18), ("cross 1x1024", 1, False, False, 18),
             ("cross keep-masked 1x1024", 1, False, True, 0),
             ("self rope 8x1024", 8, True, False, 0))
# label, H, W, pool: one launch each a pair (two images)
CONVS = (("conv1b+pool", 480, 640, True), ("conv2a", 240, 320, False),
         ("conv2b+pool", 240, 320, True))


def worker(root: Path) -> dict:
    sys.path[:0] = [str(root / "src"), str(HERE)]
    import dataclasses
    import gc

    import torch
    import torch.nn.functional as F

    import lightglue_tpu_torch  # root's, before chip_smoke puts this checkout's src on the path

    import chip_smoke as cs  # this checkout's helpers
    from lightglue_tpu_torch.cli import bench
    from lightglue_tpu_torch.config import LightGlueConfig, PipelineConfig
    from lightglue_tpu_torch.kernels import conv as conv_k
    from lightglue_tpu_torch.kernels import layer_stack as ls
    from lightglue_tpu_torch.precision import Precision
    from lightglue_tpu_torch.runtime.session import MatcherSession

    assert Path(lightglue_tpu_torch.__file__).resolve().is_relative_to(root.resolve())
    assert Path(ls.__file__).resolve().is_relative_to(root.resolve()), ls.__file__
    torch.backends.cuda.matmul.allow_tf32 = False  # true fp32 beside the kernels
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    gate = cs.TOL["fp32"]
    digest = hashlib.sha256()
    out = {"root": str(root), "attention": {}, "conv": {}}

    def rand(*shape, scale=1.0, uniform=False):
        f = torch.rand if uniform else torch.randn
        return f(*shape, generator=gen, device=dev) * scale

    for label, b, rope, keep, weight in ATTENTION:
        if rope:
            qkv = rand(b, N, 3 * E)
            q, k, v = qkv[..., :E], qkv[..., E:2 * E], qkv[..., 2 * E:]
            ang = rand(b, N, 32, scale=2.0)
            emb = torch.stack([torch.cos(ang), torch.sin(ang)], 1)
            f = torch.cat([emb, emb], -1).contiguous()
        else:
            q = rand(b, N, E)
            kv = rand(b, N, 2 * E)
            k, v, f = kv[..., :E], kv[..., E:], None
        kq = kk = None
        if keep:
            kq = (torch.rand(b, N, generator=gen, device=dev) > 0.25).float()
            kk = (torch.rand(b, N, generator=gen, device=dev) > 0.3).float()

        def call():
            return ls.attention(q, k, v, f, None, None, HEADS, torch.float32, keep_q=kq,
                                keep_kv=kk)

        got = call()
        err = cs.compare(f"attention {label}", got,
                         ls.attention_plain(q, k, v, f, None, None, HEADS, torch.float32,
                                            keep_q=kq, keep_kv=kk), **gate)
        digest.update(got.cpu().numpy().tobytes())
        qh, kh, vh = (x.reshape(b, N, HEADS, 64).transpose(1, 2) for x in (q, k, v))
        out["attention"][label] = {
            "weight": weight, "err": err, "ms": cs.cuda_ms(call),
            "sdpa_ms": cs.cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))}
    for label, h, w, pool in CONVS:
        x = rand(2, h, w, 64, uniform=True)
        wt = (torch.rand(3, 3, 64, 64, generator=gen, device=dev) * 2 - 1) / 24
        bias = (torch.rand(64, generator=gen, device=dev) * 2 - 1) / 24
        got = conv_k.conv3x3(x, wt, bias, pool=pool)
        err = cs.compare(f"conv3x3 {label}", got, conv_k.conv3x3_plain(x, wt, bias, pool), **gate)
        digest.update(got.cpu().numpy().tobytes())
        lib = cs.cudnn_conv(wt, bias, torch.float32, pool, True)
        xc = x.permute(0, 3, 1, 2)
        out["conv"][label] = {
            "err": err, "ms": cs.cuda_ms(lambda: conv_k.conv3x3(x, wt, bias, pool=pool)),
            "cudnn_ms": cs.cuda_ms(lambda: lib(xc))}
    rows = list(out["attention"].values())
    out["attention_pair_ms"] = sum(r["weight"] * r["ms"] for r in rows)
    out["sdpa_pair_ms"] = sum(r["weight"] * r["sdpa_ms"] for r in rows)
    out["conv_pair_ms"] = sum(r["ms"] for r in out["conv"].values())
    out["cudnn_pair_ms"] = sum(r["cudnn_ms"] for r in out["conv"].values())
    out["kernel_digest"] = digest.hexdigest()[:16]

    pair = cs.smooth_pair(cs.INVARIANCE_SEEDS[0])
    routes = {"fixed depth": PipelineConfig(),
              "adaptive": PipelineConfig(lightglue=LightGlueConfig(depth_confidence=0.95,
                                                                  width_confidence=0.99)),
              "2048-keypoint": cs.pb_configs()["2048-keypoint"]}
    for rung in ("fp32", "mixed"):
        for route, config in routes.items():
            s = MatcherSession(config=dataclasses.replace(config, precision=Precision(rung)),
                               device="cuda")
            s.match_pair(*pair)  # captures the graphs
            times = []
            for _ in range(10):
                t = time.perf_counter()
                s.match_pair(*pair)
                times.append((time.perf_counter() - t) * 1e3)
            ms = statistics.median(times)
            prof = cs.profile_breakdown(lambda: s.match_pair(*pair), ms, top=0)
            key = f"{rung} {route}"
            out[f"{key} match_pair ms"] = ms
            if prof:
                out[f"{key} kernel ms"] = prof[1]
                out[f"{key} busy share"] = prof[0] / ms
            del s
            gc.collect()
            torch.cuda.empty_cache()
        for b in (1, 8):
            out[f"bench lightglue {rung} {b}x1024 ms"] = bench.bench_lightglue(
                rung, 1024, b, "cuda")["p50"]
            gc.collect()
            torch.cuda.empty_cache()
        out[f"bench superpoint {rung} 1x480x640 ms"] = bench.bench_superpoint(
            rung, device="cuda")["p50"]
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main():
    if sys.argv[1:2] == ["--worker"]:
        print("RESULT " + json.dumps(worker(Path(sys.argv[2]))), flush=True)
        return
    roots = sys.argv[1:] or ["."]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t = time.perf_counter()
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from lightglue_tpu_torch.kernels import _build; _build.lib()", str(Path(r) / "src")],
        cwd=HERE) for r in dict.fromkeys(roots)]
    if any(p.wait() for p in builds):
        raise SystemExit("a root's kernels did not build")
    print(f"builds: {time.perf_counter() - t:.1f} s", flush=True)
    results = []
    for root in roots:
        proc = subprocess.run([sys.executable, __file__, "--worker", root], capture_output=True,
                              text=True, cwd=HERE)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:])
            raise SystemExit(f"{root}: worker failed")
        r = json.loads(lines[-1][len("RESULT "):])
        results.append(r)
        att = ", ".join(f"{k} {c['ms'] * 1e3:.1f} us (sdpa {c['sdpa_ms'] * 1e3:.1f})"
                        for k, c in r["attention"].items())
        print(f"{root}: attention FP32 {r['attention_pair_ms']:.4f} ms a pair (sdpa "
              f"{r['sdpa_pair_ms']:.4f}) | {att}", flush=True)
        cv = ", ".join(f"{k} {c['ms'] * 1e3:.1f} us (cudnn {c['cudnn_ms'] * 1e3:.1f})"
                       for k, c in r["conv"].items())
        print(f"{root}: conv3x3 fp32 {r['conv_pair_ms']:.4f} ms a pair (cudnn "
              f"{r['cudnn_pair_ms']:.4f}) | {cv} | kernel outputs {r['kernel_digest']}",
              flush=True)
        print("JSON " + json.dumps(r), flush=True)
    for key in results[0]:
        if key.endswith(" ms") or key.endswith("share"):
            per = {}
            for r in results:
                per.setdefault(r["root"], []).append(r[key])
            print(f"{key}: " + "; ".join(f"{root} {[round(x, 4) for x in v]}"
                                         for root, v in per.items()), flush=True)


if __name__ == "__main__":
    main()
