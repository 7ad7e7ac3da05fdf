"""Whether a pair's result on one CUDA card depends on the batch it runs in,
in SuperPoint and in the match step, and what the batched forms cost.

Every checkout root given (default: this one) gets a process of its own,
which imports the package under ``root/src`` and answers for it. The
SuperPoint parts run on the first root; the match part and the timings on
every root, the timings in the order given, ``--rounds`` times over (for an
A/B: parent, change, change, parent).

1. SuperPoint (``--parts superpoint``). ``models/superpoint.py:_conv``
   (conv3a..convDb, ``F.conv2d``) convolves each image of a batch alone;
   ``batched_conv`` below is the one-call form it replaced: cuDNN picks its
   algorithm by the whole shape, batch included. For BF16 and FP32, with
   ``batched_conv``: the encoder and descriptor head layer by layer on one
   480x640 frame alone and in a batch of two, the number of outputs that
   differ per layer; then whole extractions (``MatcherSession.extract``) of
   the frame alone and in the batch, field by field, with the batched and
   the per-image convs (weights proxy-whitened on the frame, as
   ``cli/demo_mono.py --proxy_whiten`` does). Then three rounds, alternating
   the forms: ms of ``match_pair`` (480x640, 9 layers; host clock, median
   of 30), of a 4-pair ``match_batch`` (median of 10) and the device ms of
   the batch-2 extraction graph (CUDA events around 20 replays, median of
   5), at BF16 and FP32.
2. The match step (``--parts match``), per root: on each configuration of
   ``match_configs`` (fixed depth 1024, adaptive exit 9, 2048-keypoint,
   pad-to-64, at each rung), one eager 4-pair ``match_batch`` of
   chip_smoke.py's invariance pairs in which every call of a kernel wrapper
   (through ``_build.run``) and of the plain-torch functions of
   ``PLAIN_FUNCTIONS`` (the projections, the FFN's LayerNorm and GELU,
   ``posenc``, the match head with its fp32 ``sim`` product, the match
   filter) is run again at once on each pair's rows of its inputs alone
   (batch-axis rows ``i``, or ``i`` and ``B + i`` where both images are
   stacked) and compared with that pair's rows of its output: per function,
   the calls whose rows differ and the largest difference. A function that
   differs there depends on its batch given the same inputs.
3. Timings (``--parts timing``), per root and round, on seed-0 weights:
   ``match_pair`` (graphs, host clock, median of 30) and a 4-pair
   ``match_batch`` (median of 10) at fixed depth, 2048-keypoint and
   pad-to-64, BF16 and FP32, with the kernel ms and the busy share of one
   profiled BF16 fixed-depth ``match_pair`` (``chip_smoke.profile_breakdown``);
   ``cli/bench.py``'s LightGlue 1x1024 and 8x1024 steps per rung (device
   ms, p50 of 5 reps of 20 graph replays); the
   ``ContinuousBatcher`` on chip_smoke.py's 24 ladder pairs at batch 4 (ms
   a pair, host clock, median of 3 streams after a capturing one); and a
   digest of each ``match_pair`` result's arrays, which tells whether two
   roots give a pair the same bits.

From the root of a checkout, on a machine with a CUDA card (a parent
unpacked into a git-ignored directory with ``git archive <commit> | tar -x
-C build/parent``):

    python3 scripts/tune_torch_batch_invariance.py
    python3 scripts/tune_torch_batch_invariance.py --parts match,timing \\
        build/parent . . build/parent
"""

import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PARTS = ("superpoint", "match", "timing")
# plain-torch functions of models/lightglue.py, and the match filter as the
# session calls it, run again per pair in part 2: (module, name)
PLAIN_FUNCTIONS = (("lightglue", "_linear"), ("lightglue", "_linear_rowshard"),
                   ("lightglue", "_linear_maybe_batched"), ("lightglue", "posenc"),
                   ("lightglue", "match_assignment"), ("lightglue", "_layer_norm"),
                   ("lightglue", "_gelu"), ("F", "log_softmax"), ("F", "logsigmoid"),
                   ("session", "filter_matches"))
# kernel wrappers part 2 leaves out: the decision updates its exit register
# in place, so a second run is not the same call
SKIP_KERNELS = ("_adaptive_decide_cuda",)
DEVICE = "cuda"  # where part 2's sessions run


def host_ms(fn, n):
    fn()
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


# ---- part 1: SuperPoint's cuDNN convs --------------------------------------

def superpoint_part(cs):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from lightglue_tpu_torch.config import PipelineConfig
    from lightglue_tpu_torch.kernels import stem
    from lightglue_tpu_torch.models import superpoint as sp_mod
    from lightglue_tpu_torch.precision import Precision, precision_scope
    from lightglue_tpu_torch.runtime import host, weights
    from lightglue_tpu_torch.runtime.session import MatcherSession

    per_image = sp_mod._conv

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
        for label, conv in (("batched", batched_conv), ("per-image", per_image)):
            sp_mod._conv = conv
            session = MatcherSession(proxy, None, PipelineConfig(precision=Precision(prec)),
                                     device="cuda")
            alone, batch = session.extract(one), session.extract(two)
            diff = {f: float((getattr(alone, f)[0].float() - getattr(batch, f)[0].float())
                             .abs().max()) for f in alone._fields}
            print(f"{prec} {label} convs, extract of the frame alone vs in a batch of 2: "
                  f"max difference per field {diff}", flush=True)
    sp_mod._conv = per_image

    img0, img1 = cs.smooth_pair(0)
    b0, b1 = np.stack([img0, img1, img1, img0]), np.stack([img1, img0, img0, img1])
    results = {}
    for rnd in range(3):
        order = ("batched", "per-image") if rnd % 2 == 0 else ("per-image", "batched")
        for label in order:
            sp_mod._conv = batched_conv if label == "batched" else per_image
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
    sp_mod._conv = per_image
    for (prec, label), rows in sorted(results.items()):
        med = [statistics.median(r[i] for r in rows) for i in range(3)]
        print(f"{prec} {label}: medians of 3 rounds: match_pair {med[0]:.3f} ms, match_batch "
              f"{med[1]:.3f} ms, batch-2 extraction {med[2]:.4f} ms")


# ---- part 2: the match step, function by function ---------------------------

def match_configs(cs):
    """(label, PipelineConfig): each route of the session at each rung (the
    adaptive one with random weights: every pair runs all 9 layers), and
    fixed depth at a 512 bucket, where a batch of four puts two of one
    pair's 16-row groups in one stack attention block, and masked pairs in
    two of the continuous batcher's buckets."""
    import dataclasses

    from lightglue_tpu_torch.config import LightGlueConfig, PipelineConfig, SuperPointConfig
    from lightglue_tpu_torch.precision import Precision

    routes = {"fixed depth": PipelineConfig(),
              "adaptive exit 9": PipelineConfig(lightglue=LightGlueConfig(
                  depth_confidence=0.95, width_confidence=0.99)),
              **cs.pb_configs(),
              "fixed depth 512": PipelineConfig(superpoint=SuperPointConfig(max_num_keypoints=512)),
              # the batcher's buckets, masked: 200 keypoints in 256, 600 in 640
              **{f"fixed depth {k} masked": PipelineConfig(
                  superpoint=SuperPointConfig(max_num_keypoints=k)) for k in (200, 600)}}
    return [(f"{rung} {route}", dataclasses.replace(cfg, precision=Precision(rung.lower())))
            for rung in ("BF16", "MIXED", "INT8", "FP32") for route, cfg in routes.items()]


def pair_rows(x, i, b):
    """Pair ``i``'s rows of a call's argument or result at batch ``b``:
    tensors whose first axis is ``b`` keep row ``i``, those whose first
    axis is ``2 b`` (both images stacked) rows ``i`` and ``b + i``; dicts,
    tuples and lists are walked; anything else is as it is."""
    import torch

    if isinstance(x, torch.Tensor) and x.dim() and x.shape[0] in (b, 2 * b):
        return x[i:i + 1] if x.shape[0] == b else x[[i, b + i]]
    if isinstance(x, dict):
        return {k: pair_rows(v, i, b) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(pair_rows(v, i, b) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(pair_rows(v, i, b) for v in x)
    return x


def tensors_of(x):
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in tensors_of(v)]
    return []


class PerPair:
    """Runs every recorded call again on each pair's rows alone and keeps,
    per function, [calls, calls whose rows differ, largest difference]."""

    def __init__(self, batch):
        self.batch, self.on, self.stats = batch, False, {}

    def check(self, name, fn, args, kwargs, out):
        import torch

        if not self.on:
            return
        self.on = False  # the calls below are not recorded again
        try:
            row = self.stats.setdefault(name, [0, 0, 0.0])
            row[0] += 1
            differ = False
            for i in range(self.batch):
                alone = fn(*pair_rows(args, i, self.batch), **pair_rows(kwargs, i, self.batch))
                for got, want in zip(tensors_of(alone), tensors_of(pair_rows(out, i,
                                                                              self.batch))):
                    if got.shape != want.shape or not torch.equal(got, want):
                        differ = True
                        if got.shape == want.shape and got.is_floating_point():
                            row[2] = max(row[2], float((got.float() - want.float()).abs()
                                                       .nan_to_num(0.0).max()))
            row[1] += differ
        finally:
            self.on = True


def match_part(cs, only=()):
    import contextlib

    import numpy as np
    import torch

    from lightglue_tpu_torch.kernels import _build
    from lightglue_tpu_torch.models import lightglue
    from lightglue_tpu_torch.runtime import session as session_mod
    from lightglue_tpu_torch.runtime.session import MatcherSession

    modules = {"lightglue": lightglue, "session": session_mod, "F": torch.nn.functional}
    pairs = [cs.smooth_pair(seed) for seed in cs.INVARIANCE_SEEDS]
    images0, images1 = (np.stack([p[k] for p in pairs]) for k in (0, 1))
    spy = PerPair(len(pairs))
    real_run = _build.run

    def run(op, cpu, cuda, *args):
        out = real_run(op, cpu, cuda, *args)
        if cuda.__name__ not in SKIP_KERNELS:
            spy.check(cuda.__name__, cpu if args[0].is_cpu else cuda, args, {}, out)
        return out

    def wrapped(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            spy.check(name, fn, args, kwargs, out)
            return out
        return call

    saved = [(modules[m], n, getattr(modules[m], n)) for m, n in PLAIN_FUNCTIONS]
    rows = {}
    try:
        _build.run = run
        for mod, name, fn in saved:
            setattr(mod, name, wrapped(name, fn))
        for label, cfg in match_configs(cs):
            if only and not any(o in label for o in only):
                continue
            session = MatcherSession(config=cfg, device=DEVICE)
            spy.stats = {}
            with contextlib.ExitStack() as stack:
                stack.enter_context(cs.eager_session(session))
                stack.enter_context(cs.w8a8_env(False))
                session.match_batch(images0, images1)  # first launches set up, unrecorded
                spy.on = True
                session.match_batch(images0, images1)
                spy.on = False
            rows[label] = spy.stats
            differ = {k: v for k, v in spy.stats.items() if v[1]}
            print(f"{label}: of {sum(v[0] for v in spy.stats.values())} calls, these differ on "
                  f"a pair's rows alone (calls, differing, largest difference): "
                  f"{differ or 'none'}", flush=True)
            del session
    finally:
        _build.run = real_run
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return rows


# ---- part 3: what the batched forms cost -----------------------------------

def timing_setup(cs):
    """Sessions and inputs set up once; returns the function that takes one
    round's readings."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from lightglue_tpu_torch.cli import bench
    from lightglue_tpu_torch.config import PipelineConfig
    from lightglue_tpu_torch.parallel.batcher import ContinuousBatcher, session_match_fn
    from lightglue_tpu_torch.precision import Precision
    from lightglue_tpu_torch.runtime.session import MatcherSession

    pairs = [cs.smooth_pair(seed) for seed in cs.INVARIANCE_SEEDS]
    images0, images1 = (np.stack([p[k] for p in pairs]) for k in (0, 1))
    configs = {f"{rung} {route}": dataclasses.replace(cfg, precision=Precision(rung.lower()))
               for rung in ("BF16", "FP32") for route, cfg in (
                   ("fixed depth", PipelineConfig()), *cs.pb_configs().items())}
    sessions = {k: MatcherSession(config=c, device="cuda") for k, c in configs.items()}
    config = PipelineConfig(match_threshold=0.0)  # as chip_smoke.py's batcher
    batcher_session = MatcherSession(config=config, device="cuda")
    ladder = config.buckets
    ladder_pairs = cs.batcher_pairs(ladder)

    def stream():
        batcher = ContinuousBatcher(session_match_fn(batcher_session), batcher_session.lg_params,
                                    buckets=ladder, batch_size=cs.BATCHER_SIZE, device="cuda")
        t = time.perf_counter()
        for i, p in enumerate(ladder_pairs):
            batcher.submit(i, *p)
        batcher.flush()
        return (time.perf_counter() - t) * 1e3

    def digest(result):  # every array of a match_pair result, bit for bit
        h = hashlib.sha256()
        for key in sorted(result):
            h.update(key.encode() + np.ascontiguousarray(result[key]).tobytes())
        return h.hexdigest()[:16]

    def measure():
        out = {}
        for label, s in sessions.items():
            out[f"{label} match_pair digest"] = digest(s.match_pair(*pairs[0]))
            out[f"{label} match_pair ms"] = ms = host_ms(lambda: s.match_pair(*pairs[0]), 30)
            if label == "BF16 fixed depth":  # the main path's kernel ms and busy share
                prof = cs.profile_breakdown(lambda: s.match_pair(*pairs[0]), ms, top=0)
                if prof:
                    out[f"{label} match_pair kernel ms"] = prof[1]
                    out[f"{label} match_pair busy share"] = prof[0] / ms
            out[f"{label} match_batch (4 pairs) ms"] = host_ms(
                lambda: s.match_batch(images0, images1), 10)
        for p in ("fp32", "mixed", "bf16", "int8"):
            for b in (1, 8):
                out[f"bench lightglue {p} {b}x1024 ms"] = bench.bench_lightglue(p, 1024, b,
                                                                                "cuda")["p50"]
            # the bench session's graphs, freed before the next capture: a
            # capture that must return memory to the card is invalidated
            gc.collect()
            torch.cuda.empty_cache()
        stream()  # captures each bucket's graph
        out["batcher ms a pair"] = statistics.median(stream() for _ in range(3)) / len(
            ladder_pairs)
        return out

    return measure


# ---- the processes ---------------------------------------------------------

def serve(root: Path) -> int:
    """A measuring process for the package under ``root``: answers each
    part named on its input with its printed lines and a last line
    ``DONE <json>``, until the input closes."""
    sys.path[:0] = [str(root / "src"), str(ROOT)]
    import lightglue_tpu_torch
    from lightglue_tpu_torch.kernels import _build

    import chip_smoke as cs  # this checkout's images and helpers; the package stays root's

    assert Path(lightglue_tpu_torch.__file__).resolve().is_relative_to(root.resolve())
    _build.lib()
    measure = None
    print("ready", flush=True)
    for line in sys.stdin:
        part = line.strip()
        if part == "superpoint":
            superpoint_part(cs)
            result = None
        elif part.startswith("match"):
            result = match_part(cs, tuple(filter(None, part[len("match"):].split("|"))))
        else:
            measure = measure or timing_setup(cs)
            result = measure()
        print("DONE " + json.dumps(result), flush=True)
    return 0


def ask(proc, part):
    """Send ``part`` to a measuring process, echo its lines, return its result."""
    proc.stdin.write(part + "\n")
    proc.stdin.flush()
    for line in proc.stdout:
        if line.startswith("DONE "):
            return json.loads(line[5:])
        print("  " + line.rstrip(), flush=True)
    raise RuntimeError(f"the measuring process ended during {part}")


def main() -> int:
    if sys.argv[1:2] == ["--serve"]:
        return serve(Path(sys.argv[2]))
    argv, parts, rounds, only = sys.argv[1:], PARTS, 1, ""
    while argv[:1] and argv[0].startswith("--"):
        if argv[0] == "--parts":
            parts = tuple(argv[1].split(","))
        elif argv[0] == "--rounds":
            rounds = int(argv[1])
        elif argv[0] == "--configs":  # part 2's configurations whose labels hold one of these
            only = "|".join(argv[1].split(","))
        else:
            raise SystemExit(f"unknown option {argv[0]}")
        argv = argv[2:]
    order = argv or ["."]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    procs = {}
    try:
        for root in dict.fromkeys(order):
            procs[root] = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--serve", root],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=ROOT)
            if procs[root].stdout.readline().strip() != "ready":
                raise RuntimeError(f"{root}: the measuring process did not start")
        if "superpoint" in parts:
            print(f"== SuperPoint's convs, {order[0]}", flush=True)
            ask(procs[order[0]], "superpoint")
        if "match" in parts:
            for root, proc in procs.items():
                print(f"== the match step per function, {root}", flush=True)
                print(json.dumps({"match_functions": {"root": root,
                                                      "configs": ask(proc, "match" + only)}}),
                      flush=True)
        if "timing" in parts:
            rows = []
            for _ in range(rounds):
                for root in order:
                    print(f"== timings, {root}", flush=True)
                    rows.append(dict(root=root, **ask(procs[root], "timing")))
                    print(json.dumps({"timing": rows[-1]}), flush=True)
            for key in rows[0]:
                if key == "root":
                    continue
                if key.endswith("digest"):  # the same bits at every root and round?
                    print(f"{key}: " + ("equal" if len({r[key] for r in rows}) == 1 else "DIFFER")
                          + " " + "; ".join(f"{r['root']} {r[key]}" for r in rows))
                    continue
                mine = {root: [r[key] for r in rows if r["root"] == root] for root in procs}
                print(f"{key}: " + "; ".join(
                    f"{root} median {statistics.median(v):.3f} of {[round(x, 3) for x in v]}"
                    for root, v in mine.items()))
    finally:
        for proc in procs.values():
            proc.stdin.close()
            proc.wait(timeout=120)
    return 0


if __name__ == "__main__":
    sys.exit(main())
