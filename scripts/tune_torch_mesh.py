"""Where a tensor-parallel mesh step's host time goes on one CUDA card, and
what the shard threads' turn lock (``parallel/mesh.py:_ModelAxis.turn``)
buys.

A single-process tensor-parallel (TP) step runs the shards of a data row in
threads that meet at the model axis's barrier. Every torch call releases and
retakes the interpreter lock, so runnable shard threads swap it at every
call; the turn lock keeps one shard thread runnable at a time.

1. Host clock, median of 7 (each call ending in a synchronise), BF16, 4
   pairs of 1024 keypoints, 9 layers, seed-0 weights: the per-block layers
   on one device at B = 4; one shard of a 1 x 2 and of a 1 x 4 mesh alone
   (its all-reduce a copy: the shard's own work); the match step of the
   1 x 2, 2 x 2 and 1 x 4 meshes on ``[cuda:0] * n``.
2. Three rounds, alternating which runs first: each mesh step with the turn
   lock and with a lock that never blocks (every shard thread runnable, as
   without it).
3. One instrumented step per mesh: the time the shard threads spend at the
   barrier, waiting for the turn, and in the barrier's action (the sum),
   summed over the threads, beside the step's wall time.

From the root of a checkout, on a machine with a CUDA card:

    python3 scripts/tune_torch_mesh.py
"""

import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from lightglue_tpu_torch.config import PipelineConfig  # noqa: E402
from lightglue_tpu_torch.kernels import _build  # noqa: E402
from lightglue_tpu_torch.models import lightglue  # noqa: E402
from lightglue_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from lightglue_tpu_torch.precision import policy_for  # noqa: E402
from lightglue_tpu_torch.runtime import weights  # noqa: E402

N, BATCH = 1024, 4
MESHES = ((1, 2), (2, 2), (1, 4))


class _Unlocked:
    """A lock that never blocks: every shard thread stays runnable."""

    def acquire(self):
        return True

    def release(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def host_ms(fn, reps=7):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


class Probe:
    """``_ModelAxis`` with its waits and its action timed (summed over the
    shard threads)."""

    def __init__(self):
        self.lock, self.sums = threading.Lock(), {}
        self.base = mesh_lib._ModelAxis

    def add(self, key, seconds):
        with self.lock:
            self.sums[key] = self.sums.get(key, 0.0) + seconds * 1e3

    def axis(self):
        probe = self

        class Timed(self.base):
            def _reduce(axis):
                t = time.perf_counter()
                super()._reduce()
                probe.add("action", time.perf_counter() - t)

            def shard(axis, j):
                def all_reduce(x):
                    axis.partials[j] = x
                    t0 = time.perf_counter()
                    axis.turn.release()
                    try:
                        axis.barrier.wait()
                    finally:
                        t1 = time.perf_counter()
                        axis.turn.acquire()
                        probe.add("barrier", t1 - t0)
                        probe.add("turn", time.perf_counter() - t1)
                    return axis.total.to(x.device)

                return lightglue.TensorParallel(axis.size, all_reduce)

        return Timed


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.lib()
    dev = torch.device("cuda", 0)
    config = PipelineConfig(buckets=(N,), max_matches=N)  # BF16, 9 layers
    policy = policy_for(config.precision)
    params = weights.params_from_numpy(weights.init_lightglue(0, config.lightglue), dev,
                                       torch.bfloat16)
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.uniform(-1, 1, (BATCH, N, 2)).astype(np.float32),
        rng.uniform(-1, 1, (BATCH, N, 2)).astype(np.float32),
        rng.standard_normal((BATCH, N, 256)).astype(np.float32),
        rng.standard_normal((BATCH, N, 256)).astype(np.float32),
        np.full((BATCH,), N - 5, np.int32), np.full((BATCH,), N - 9, np.int32))]

    print(f"1. host ms, median of 7, BF16, {BATCH}x{N}, 9 layers", flush=True)
    with torch.inference_mode():
        f0, f1 = (lightglue.posenc(params["posenc"], a, 64) for a in args[:2])
        d0, d1 = args[2].bfloat16(), args[3].bfloat16()
        ms = host_ms(lambda: lightglue.transformer_layers(
            params["layers"], d0, d1, f0, f1, args[4], args[5], num_heads=4, policy=policy))
        print(f"  per-block layers, one device, B={BATCH}: {ms:.3f} ms", flush=True)
        for tp in (2, 4):
            shard = mesh_lib.shard_lightglue_params(params, mesh_lib.make_mesh(
                1, tp, devices=[dev] * tp)).shards[(0, 0)]
            alone = lightglue.TensorParallel(tp, lambda x: x.clone())
            ms = host_ms(lambda: lightglue.transformer_layers(
                shard["layers"], d0, d1, f0, f1, args[4], args[5], num_heads=4 // tp,
                policy=policy, tp=alone))
            print(f"  one shard of 1 x {tp} alone (its all-reduce a copy): {ms:.3f} ms", flush=True)
    steps = {}
    for d, m in MESHES:
        mesh = mesh_lib.make_mesh(d, m, devices=[dev] * (d * m))
        steps[(d, m)] = (mesh_lib.make_parallel_match_fn(mesh, config, N, N),
                         mesh_lib.shard_lightglue_params(params, mesh))

    print("2. each step with the turn lock and with one that never blocks, three rounds", flush=True)
    base = mesh_lib._ModelAxis

    class NoTurn(base):
        def __init__(self, *a):
            super().__init__(*a)
            self.turn = _Unlocked()

    for rnd in range(3):
        for variant in (("turn", "no turn") if rnd % 2 == 0 else ("no turn", "turn")):
            mesh_lib._ModelAxis = base if variant == "turn" else NoTurn
            try:
                line = ", ".join(f"{d}x{m} {host_ms(lambda: fn(p, *args)):.1f}"
                                 for (d, m), (fn, p) in steps.items())
            finally:
                mesh_lib._ModelAxis = base
            print(f"  round {rnd} {variant}: step ms {line}", flush=True)

    print("3. one instrumented step per mesh (ms summed over the shard threads)", flush=True)
    probe = Probe()
    for (d, m), (fn, p) in steps.items():
        fn(p, *args)
        torch.cuda.synchronize()
        mesh_lib._ModelAxis = probe.axis()
        try:
            probe.sums.clear()
            t = time.perf_counter()
            fn(p, *args)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        finally:
            mesh_lib._ModelAxis = base
        sums = ", ".join(f"{k} {v:.1f}" for k, v in sorted(probe.sums.items()))
        print(f"  {d}x{m}: step {wall:.1f} ms; {d * m} threads: {sums}", flush=True)


if __name__ == "__main__":
    main()
