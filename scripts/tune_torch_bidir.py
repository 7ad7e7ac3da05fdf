"""Time the bidirectional kernel and the stack attention of one or more
checkouts on one CUDA card.

Each root (a checkout's root directory) is timed in its own process, which
runs that root's ``csrc/bidir_cross.cu`` and ``csrc/attention.cu`` (the two
compiled with the root's headers into one shared library, every root's
nvcc at once) through that root's wrappers (``_build._lib``: they call
nothing else):

- ``bidirectional_cross_attention`` on the pad-to-64 route's shapes, B = 1:
  960 x 960, the mixed buckets 960 x 704 and 960 x 64 at H = 4, and 960 x
  960 at the TP shards' H = 2 and H = 1 (E = 64 H), each at BF16 (bf16
  operands, stats and out), MIXED (bf16 operands, fp32 stats and out) and
  FP32 (3xTF32); the operands column slices of one [qk | v] projection a
  side; beside two ``scaled_dot_product_attention`` calls (one per
  direction: no one PyTorch call computes both) and two launches of the
  stack attention on the same operands (``chip_smoke.bidir_yardsticks``);
- ``attention`` (attention.cu's two kernels, which share the tile body of
  ``csrc/attention_tile.cuh`` with the bidirectional ones) at the stack's
  calls, self with RoPE and cross at 1x1024, H = 4, in the same three
  modes.

Each output is checked against its plain version at the gates of PERF.md
section 2 (bf16 2e-2, MIXED 1e-3, fp32 1e-4), then timed with
``chip_smoke.cuda_ms`` (a CUDA graph of ten calls, median of ten replays),
matmuls in fp32 with TF32 off. Per root it prints the per-pair sums (9
bidirectional launches, 18 self and 18 cross attention launches a pair)
and a digest of each kernel's outputs (two roots that print the same digest
computed those outputs bit for bit alike). ``--variant NAME=FILE`` times this
checkout with FILE (another bidir_cross.cu, e.g. under build/) in its
place; ``--constant NAME=VALUE`` a copy of this checkout with one
``constexpr int`` of csrc/ changed (``tune_torch_stack_kernels.
variant_root``). Roots run in the order given, variants after them; give a
parent first and last to bracket drift:

    git archive <parent> | tar -x -C build/parent
    python3 scripts/tune_torch_bidir.py build/parent . . build/parent
"""

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE / "scripts")]

import tune_torch_stack_kernels as tune  # noqa: E402

PAD64, N, LAYERS = 960, 1024, 9
# label, heads, n0, n1, launches a pad-to-64 pair (the 960 cap's call, the TP
# shards' calls)
BIDIR = (("960x960", 4, PAD64, PAD64, LAYERS), ("960x704", 4, PAD64, 704, 0),
         ("960x64", 4, PAD64, 64, 0), ("960x960 H=2", 2, PAD64, PAD64, LAYERS),
         ("960x960 H=1", 1, PAD64, PAD64, LAYERS))
ENTRIES = ("lg_bidirectional_cross", "lg_attention", "lg_rope_qk")
SOURCES = ("bidir_cross.cu", "attention.cu")


def build(csrc: Path, bidir: Path, name: str):
    """nvcc of one bidir_cross.cu and csrc's attention.cu (csrc's headers)
    into build/tune_bidir/<name>.so, started and returned unwaited."""
    sys.path[:0] = [str(HERE / "src")]
    from lightglue_tpu_torch.kernels import _build

    out = HERE / "build" / "tune_bidir"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"{name}.so"
    lib.unlink(missing_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(csrc), str(bidir),
           str(csrc / "attention.cu"), "-o", str(lib)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def worker(root: Path, lib: Path) -> dict:
    sys.path[:0] = [str(HERE)]
    import chip_smoke as cs  # puts this checkout's src first; the root's goes before it

    sys.path.insert(0, str(root / "src"))
    import torch

    from lightglue_tpu_torch.kernels import _build
    from lightglue_tpu_torch.kernels import attention as at
    from lightglue_tpu_torch.kernels import layer_stack as ls

    assert Path(at.__file__).resolve().is_relative_to(root.resolve()), at.__file__
    handle = ctypes.CDLL(str(lib))
    for name in ENTRIES:
        fn = getattr(handle, name)
        fn.argtypes, fn.restype = _build._SIGNATURES[name], ctypes.c_int
    _build._lib = handle
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, bf16, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    # mode: operand dtype, stat dtype, out dtype, gate
    modes = {"bf16": (bf16, bf16, None, cs.TOL["bf16"]),
             "mixed": (bf16, f32, f32, cs.MIXED_TOL["attention"]),
             "fp32": (f32, f32, None, cs.TOL["fp32"])}
    digests = {"bidir": hashlib.sha256(), "attention": hashlib.sha256()}

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def held(kernel, label, got, want, tol):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for i, (g, w) in enumerate(zip(got, want)):
            cs.compare(f"{kernel} {label} o{i}", g, w, **tol)
            digests[kernel].update(g.float().cpu().numpy().tobytes())

    out = {"root": str(root), "bidir": {}, "attention": {}}
    for label, heads, n0, n1, weight in BIDIR:
        e = 64 * heads
        for tag, (dt, sdt, odt, tol) in modes.items():
            a0, a1 = rand(1, n0, 2 * e, dtype=dt), rand(1, n1, 2 * e, dtype=dt)
            args = (a0[..., :e], a1[..., :e], a0[..., e:], a1[..., e:])  # [qk | v] slices
            kw = dict(num_heads=heads, stat_dtype=sdt, out_dtype=odt)
            held("bidir", f"{label} {tag}", at.bidirectional_cross_attention(*args, **kw),
                 at.bidirectional_cross_attention_plain(*args, **kw), tol)
            two, stack = cs.bidir_yardsticks(ls, args, heads, sdt, odt)
            out["bidir"][f"{label} {tag}"] = dict(
                weight=weight, ms=cs.cuda_ms(lambda: at.bidirectional_cross_attention(*args, **kw)),
                two_sdpa_ms=cs.cuda_ms(two), two_attention_ms=cs.cuda_ms(stack))
    ang = torch.rand(1, N, 32, generator=gen, device=dev) * 4.0
    emb = torch.stack([torch.cos(ang), torch.sin(ang)], dim=1)
    freqs = torch.cat([emb, emb], dim=-1).contiguous()
    for label, rope in (("self rope 1x1024", True), ("cross 1x1024", False)):
        for tag, (dt, sdt, odt, tol) in modes.items():
            q = rand(1, N, 3 * 256, dtype=dt)  # a qkv projection, or q beside a [qk | v] one
            kv = rand(1, N, 2 * 256, dtype=dt)
            args = ((q[..., :256], q[..., 256:512], q[..., 512:], freqs) if rope
                    else (q[..., :256], kv[..., :256], kv[..., 256:], None))
            call = (*args, None, None, 4, sdt, odt)
            held("attention", f"{label} {tag}", ls.attention(*call), ls.attention_plain(*call), tol)
            out["attention"][f"{label} {tag}"] = dict(ms=cs.cuda_ms(lambda: ls.attention(*call)))
    for tag in modes:
        b = out["bidir"]
        out[f"bidir {tag} pair ms"] = LAYERS * b[f"960x960 {tag}"]["ms"]
        out[f"bidir {tag} two sdpa pair ms"] = LAYERS * b[f"960x960 {tag}"]["two_sdpa_ms"]
        out[f"bidir {tag} two attention pair ms"] = (LAYERS
                                                     * b[f"960x960 {tag}"]["two_attention_ms"])
        for h in (2, 1):
            out[f"bidir {tag} H={h} pair ms"] = LAYERS * b[f"960x960 H={h} {tag}"]["ms"]
        out[f"attention {tag} pair ms"] = 2 * LAYERS * sum(
            out["attention"][f"{k} {tag}"]["ms"] for k in ("self rope 1x1024", "cross 1x1024"))
    out["digest"] = {k: d.hexdigest()[:16] for k, d in digests.items()}
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("roots", nargs="*", default=["."])
    parser.add_argument("--variant", action="append", default=[],
                        help="NAME=FILE: this checkout with FILE as its bidir_cross.cu")
    parser.add_argument("--constant", action="append", default=[],
                        help="NAME=VALUE: a copy of this checkout with that constant of csrc/")
    parser.add_argument("--worker", nargs=2, help=argparse.SUPPRESS)
    args = parser.parse_intermixed_args()
    if args.worker:
        print("RESULT " + json.dumps(worker(Path(args.worker[0]), Path(args.worker[1]))),
              flush=True)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t = time.perf_counter()
    runs, builds = [], {}
    roots = [(str(r), Path(r), None) for r in args.roots]
    roots += [(name, HERE, Path(file)) for name, file in (v.split("=", 1) for v in args.variant)]
    roots += [(c, tune.variant_root(c.replace("=", "_"), c), None) for c in args.constant]
    for label, root, bidir in roots:
        csrc = root / "src" / "lightglue_tpu_torch" / "csrc"
        key = (str(root.resolve()), str(bidir))
        if key not in builds:
            builds[key] = build(csrc, bidir or csrc / "bidir_cross.cu", f"root{len(builds)}")
        runs.append((label, root, builds[key][0]))
    for lib, proc in builds.values():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc {lib.name} failed:\n{log[-3000:]}")
    print(f"builds: {time.perf_counter() - t:.1f} s", flush=True)
    results = []
    for label, root, lib in runs:
        proc = subprocess.run([sys.executable, __file__, "--worker", str(root), str(lib)],
                              capture_output=True, text=True, cwd=HERE)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:])
            raise SystemExit(f"{label}: worker failed")
        r = dict(json.loads(lines[-1][len("RESULT "):]), label=label)
        results.append(r)
        for tag in ("bf16", "mixed", "fp32"):
            calls = ", ".join(f"{k[:-len(tag) - 1]} {c['ms'] * 1e3:.1f} us (two SDPA "
                              f"{c['two_sdpa_ms'] * 1e3:.1f}, two attention "
                              f"{c['two_attention_ms'] * 1e3:.1f})"
                              for k, c in r["bidir"].items() if k.endswith(" " + tag))
            print(f"{label}: bidirectional {tag} {r[f'bidir {tag} pair ms']:.4f} ms a pair (two "
                  f"SDPA {r[f'bidir {tag} two sdpa pair ms']:.4f}, two attention "
                  f"{r[f'bidir {tag} two attention pair ms']:.4f}; H=2 "
                  f"{r[f'bidir {tag} H=2 pair ms']:.4f}, H=1 {r[f'bidir {tag} H=1 pair ms']:.4f})"
                  f" | {calls}", flush=True)
        att = ", ".join(f"{k} {c['ms'] * 1e3:.1f} us" for k, c in r["attention"].items())
        print(f"{label}: attention BF16 / MIXED / FP32 {r['attention bf16 pair ms']:.4f} / "
              f"{r['attention mixed pair ms']:.4f} / {r['attention fp32 pair ms']:.4f} ms a pair "
              f"| {att} | outputs: bidirectional {r['digest']['bidir']}, attention "
              f"{r['digest']['attention']}", flush=True)
        print("JSON " + json.dumps(r), flush=True)
    for key in results[0]:
        if key.endswith(" ms"):
            per = {}
            for r in results:
                per.setdefault(r["label"], []).append(r[key])
            print(f"{key}: " + "; ".join(f"{label} {[round(x, 4) for x in v]}"
                                         for label, v in per.items()), flush=True)


if __name__ == "__main__":
    main()
