"""What the kernel wrappers' operator layer costs the port on one CUDA card.

Each checkout root given gets one process, which imports its package and
sets up once; the processes then take turns measuring, in the order given
(for an A/B: parent, change, change, parent), ``--rounds`` times over (one
round is the order given once). On seed-0 weights and chip_smoke.py's
480x640 pair, host clock, each call ending in a synchronise, median of 20
after a warm call:

1. ``MatcherSession.match_pair`` at the default config (BF16, fixed depth,
   9 layers, 1024 keypoints) from the session's CUDA graphs;
2. the eager bodies: a second session whose runners are them (as
   ``chip_smoke.py:eager_session`` swaps them in);
3. the 4 x 1 mesh's match step on ``[cuda:0] * 4`` (four B = 1 stacks, one
   after another, eager), 4 pairs of 1024 keypoints (image1 = image0, as
   ``chip_smoke.py:parallel_checks``), per pair;
4. the host time of one wrapper call, ``linear``, ``attention`` and
   ``ln_gelu`` at a 64-row bf16 shape: 2000 calls back to back, one
   synchronise at the end, median of 5 (the card runs each launch faster
   than the host issues it, so this is the wrapper's Python and launch).

Prints the card's name and power limit, a JSON line per measurement, a
table, and each reading's median and quartiles per root.
From the root of a checkout, on a machine with a CUDA card, with a parent
unpacked into a git-ignored directory (``git archive <commit> | tar -x -C
build/parent``):

    python3 scripts/tune_torch_dispatch.py --rounds 5 build/parent . . build/parent

To time the operators without ``_build.run``'s direct path, unpack the
change a second time and make ``run`` return ``op(*args)``, then give that
root too (parent, change, op, op, change, parent):

    git archive $(git write-tree) | tar -x -C build/opcall
    (replace the body of run() in build/opcall/src/lightglue_tpu_torch/
    kernels/_build.py by ``return op(*args)``)
    python3 scripts/tune_torch_dispatch.py --rounds 5 build/parent build/direct \\
        build/opcall build/opcall build/direct build/parent
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def host_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def call_us(fn, calls=2000, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e6 / calls)
    return statistics.median(times)


def setup(root: Path):
    """The package under ``root/src``, set up: a function that takes the
    four readings."""
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    import lightglue_tpu_torch
    from lightglue_tpu_torch.config import PipelineConfig
    from lightglue_tpu_torch.kernels import _build
    from lightglue_tpu_torch.kernels import layer_stack as ls
    from lightglue_tpu_torch.parallel import mesh as mesh_lib
    from lightglue_tpu_torch.runtime import weights
    from lightglue_tpu_torch.runtime.session import MatcherSession

    # the images of this script's checkout (its chip_smoke.py); the package
    # above stays the one under root
    sys.path.insert(1, str(ROOT))
    from chip_smoke import smooth_pair

    assert Path(lightglue_tpu_torch.__file__).resolve().is_relative_to(root.resolve())
    _build.lib()
    img0, img1 = smooth_pair(0)
    graphs = MatcherSession(device="cuda")
    eager = MatcherSession(device="cuda")
    eager._graphs = False  # its runners are the eager bodies
    with torch.inference_mode():
        images = np.stack([smooth_pair(seed)[k] for seed in (0, 1) for k in (0, 1)])
        ext = eager.extract(images)
    n = 1024
    counts = torch.clamp(ext.count, max=n)
    args = (ext.keypoints_norm, ext.keypoints_norm, ext.descriptors, ext.descriptors, counts,
            counts)
    dev = torch.device("cuda", 0)
    config = PipelineConfig()
    mesh = mesh_lib.make_mesh(4, 1, devices=[dev] * 4)
    step = mesh_lib.make_parallel_match_fn(mesh, config, n, n)
    params = mesh_lib.shard_lightglue_params(
        weights.params_from_numpy(weights.init_lightglue(0, config.lightglue), dev,
                                  torch.bfloat16), mesh)
    gen = torch.Generator(device=dev).manual_seed(0)
    x, qkv = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
              for shape in ((1, 64, 256), (1, 64, 768)))
    w, b = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) / 16
            for shape in ((256, 256), (256,)))
    g = torch.ones(256, device=dev, dtype=torch.bfloat16)

    def measure() -> dict:
        out = dict(root=str(root))
        with torch.inference_mode():
            out["graph_ms"] = host_ms(lambda: graphs.match_pair(img0, img1))
            out["eager_ms"] = host_ms(lambda: eager.match_pair(img0, img1))
        out["mesh_4x1_ms_per_pair"] = host_ms(lambda: step(params, *args)) / len(images)
        out["wrapper_us"] = {
            "linear": call_us(lambda: ls.linear(x, w, b)),
            "attention": call_us(lambda: ls.attention(qkv[..., :256], qkv[..., 256:512],
                                                      qkv[..., 512:], None, None, None, 4,
                                                      torch.bfloat16)),
            "ln_gelu": call_us(lambda: ls.ln_gelu(x, g, b)),
        }
        return out

    return measure


def serve(root: Path) -> int:
    """A measuring process: set up, say so, then one JSON line of readings
    for each line read, until the input closes."""
    measure = setup(root)
    print("ready", flush=True)
    for _ in sys.stdin:
        print(json.dumps(measure()), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--serve"]:
        return serve(Path(sys.argv[2]))
    argv = sys.argv[1:]
    rounds = 1
    if argv[:1] == ["--rounds"]:
        rounds, argv = int(argv[1]), argv[2:]
    order = argv or ["."]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    procs = {}
    try:
        for root in dict.fromkeys(order):
            procs[root] = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--serve", root],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for root, proc in procs.items():
            if proc.stdout.readline().strip() != "ready":
                raise RuntimeError(f"{root}: the measuring process did not start")
        rows = []
        for _ in range(rounds):
            for root in order:
                proc = procs[root]
                proc.stdin.write("measure\n")
                proc.stdin.flush()
                rows.append(json.loads(proc.stdout.readline()))
                print(json.dumps(rows[-1]), flush=True)
    finally:
        for proc in procs.values():
            proc.stdin.close()
            proc.wait(timeout=60)
    print("root | match_pair graph ms | match_pair eager ms | 4x1 mesh step ms a pair | "
          "linear / attention / ln_gelu us a call")
    for r in rows:
        us = " / ".join(f"{v:.2f}" for v in r["wrapper_us"].values())
        print(f"{r['root']} | {r['graph_ms']:.3f} | {r['eager_ms']:.3f} | "
              f"{r['mesh_4x1_ms_per_pair']:.3f} | {us}")
    for key in ("graph_ms", "eager_ms", "mesh_4x1_ms_per_pair"):
        for root in procs:
            vals = sorted(r[key] for r in rows if r["root"] == root)
            q = statistics.quantiles(vals, n=4) if len(vals) > 1 else vals * 3
            print(f"{key} {root}: median {statistics.median(vals):.3f}, quartiles "
                  f"{q[0]:.3f} / {q[2]:.3f} over {len(vals)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
