"""Where the ring across processes spends its time on one CUDA card.

1. ``chip_smoke.py``'s process-ring phase alone: the 480x640 pair's
   2048-keypoint extractions and the one-process ``forward_ring`` on
   ``[cuda:0] * 4`` (``ring_end_to_end``), then ``ring_process_checks``:
   ``ring_attention`` across 2 and 4 ranks spawned on cuda:0 in a gloo
   group, and ``forward_ring`` across 4 at BF16 and FP32, with ms a call,
   the host ms inside the transport (staging, posts, waits) and the host
   P2P alone.
2. gloo P2P between 4 CPU processes, no card: one ring rotation of a
   (1, 4, n, 64) bf16 K/V block at n = 512 and 1024 (a stripe of the 2048
   bucket over 4 and 2 ranks), median ms a rotation over 108 rotations (one
   ``forward_ring``'s), three rounds each, by how it is posted: K and V as
   two messages or one packed [k; v], through ``dist.batch_isend_irecv`` or
   plain ``isend`` / ``irecv``, or through ``parallel/ring.py``'s direct
   transport (a new one every 3 rotations, as ``forward_ring`` makes one a
   ring call); each table with one torch thread a process (what
   ``chip_smoke.py``'s ranks run with) and with torch's default count.

From the root of a checkout, on a machine with a CUDA card:

    python3 scripts/tune_torch_ring.py
"""

import datetime
import multiprocessing
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

MODES = ("batch, two messages", "batch, packed", "plain, two messages", "plain, packed",
         "ring.py transport")
ROTATIONS = 108  # 9 layers x 4 attentions x 3 rotations: one forward_ring at 4 ranks


def _rotate(mode, k, kv, rk, rv, rkv, nxt, prv):
    import torch.distributed as dist

    if mode == "batch, two messages":
        return dist.batch_isend_irecv([
            dist.P2POp(dist.isend, k, nxt, tag=0), dist.P2POp(dist.isend, k, nxt, tag=1),
            dist.P2POp(dist.irecv, rk, prv, tag=0), dist.P2POp(dist.irecv, rv, prv, tag=1)])
    if mode == "batch, packed":
        return dist.batch_isend_irecv([dist.P2POp(dist.isend, kv, nxt),
                                       dist.P2POp(dist.irecv, rkv, prv)])
    if mode == "plain, two messages":
        return [dist.isend(k, nxt, tag=0), dist.isend(k, nxt, tag=1),
                dist.irecv(rk, prv, tag=0), dist.irecv(rv, prv, tag=1)]
    return [dist.isend(kv, nxt), dist.irecv(rkv, prv)]


def p2p_rank(rank, size, port, threads, queue):
    """One CPU rank of the P2P table (``threads`` torch threads, or torch's
    default when None): puts (rank, {"n mode": median ms})."""
    import torch
    import torch.distributed as dist

    from lightglue_tpu_torch.parallel import ring

    if threads is not None:
        torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=size,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    nxt, prv = (rank + 1) % size, (rank - 1) % size
    out = {}
    for n in (512, 1024):
        k = torch.zeros(1, 4, n, 64, dtype=torch.bfloat16)
        kv = torch.zeros(2, 1, 4, n, 64, dtype=torch.bfloat16)
        rk, rv, rkv = torch.empty_like(k), torch.empty_like(k), torch.empty_like(kv)
        for mode in MODES * 3:
            dist.barrier()
            t = time.perf_counter()
            if mode == "ring.py transport":
                pr = ring.ProcessRing(dist.group.WORLD, torch.device("cpu"))
                for _ in range(ROTATIONS // 3):
                    transport, block = pr.transport(k, k), (k, k)
                    for _ in range(3):
                        block = transport.wait(transport.post(*block, 0))
            else:
                for _ in range(ROTATIONS):
                    for work in _rotate(mode, k, kv, rk, rv, rkv, nxt, prv):
                        work.wait()
            dist.barrier()
            out.setdefault(f"{n} {mode}", []).append((time.perf_counter() - t) * 1e3 / ROTATIONS)
    dist.destroy_process_group()
    queue.put((rank, {key: round(statistics.median(v), 4) for key, v in out.items()}))


def p2p_table(threads, size=4):
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=p2p_rank, args=(r, size, port, threads, queue))
             for r in range(size)]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=300) for _ in range(size))
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return got


def main():
    import torch

    from lightglue_tpu_torch.kernels import _build
    from lightglue_tpu_torch.kernels import attention as at
    from lightglue_tpu_torch.kernels import conv as conv_k
    from lightglue_tpu_torch.kernels import layer_stack as ls
    from lightglue_tpu_torch.kernels import nms as nms_k
    from lightglue_tpu_torch.kernels import stem as stem_k

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    _build.lib()
    img0, img1 = chip_smoke.smooth_pair(0)
    counters = [stem_k.relu_conv1a_shift, conv_k.conv3x3, nms_k.nms_candidates, ls.linear,
                ls.attention, ls.ln_gelu]
    step_entries = [chip_smoke.Entry(name, "", "") for name in ("step", "step fp32")]
    inputs = chip_smoke.ring_end_to_end(at, counters, img0, img1, *step_entries)
    chip_smoke.ring_process_checks(inputs)
    for threads in (1, None):
        print(f"gloo P2P between 4 CPU processes, {threads or 'default'} torch threads each, "
              "median ms a rotation by rank:", flush=True)
        for rank, row in sorted(p2p_table(threads).items()):
            print(f"  rank {rank}: {row}", flush=True)


if __name__ == "__main__":
    main()
