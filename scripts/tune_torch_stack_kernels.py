"""Time the layer stack's bf16 kernels of one or more checkouts on one CUDA card.

Each root (a checkout's root directory, or a copy of this checkout's
package with one constant of ``csrc/`` changed: ``NAME=VALUE`` in
``--variant``) is timed in its own process, which builds that root's
kernels into its own ``build/`` and runs them through that root's wrappers
at the main path's shapes, B = 1, N = 1024, E = 256, H = 4: the five
projections (qkv, out, ffn1 over two operands, ffn2 with its residual,
qk_v) beside ``torch.addmm`` of the same product, and the self (RoPE) and
cross attention calls beside ``scaled_dot_product_attention`` (which does no
RoPE), each output checked against the plain version first, each time
``chip_smoke.cuda_ms`` (a CUDA graph of ten calls, median of ten replays).
The cross attention is also timed at 8 pairs (bench LightGlue 8x1024's
shape), per pair. Per root: the per-pair sums (each shape weighted by its
launches in one ``match_pair``: 18 / 36 / 36 / 36 / 18 linear, 18 + 18
attention), the same sums for MIXED's and INT8's operand modes (each
output checked first), the host microseconds of one eager wrapper call
(enqueue only),
the microseconds of encoding one TMA tensor map (``cuTensorMapEncodeTiled``
through ctypes: a BF16 ``linear`` or ``attention`` call encodes three), and
a digest of the attention outputs (two roots that print the same digest
computed every output bit for bit alike).
Roots run in the order given; give a parent first and last to bracket
drift:

    git archive <parent> | tar -x -C build/parent
    python3 scripts/tune_torch_stack_kernels.py build/parent . . build/parent
    python3 scripts/tune_torch_stack_kernels.py . --variant WGS=2 .
"""

import argparse
import ctypes
import hashlib
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# (label, K1, K2, N, residual, launches per match_pair)
LINEAR = (("qkv", 256, 0, 768, False, 18), ("out", 256, 0, 256, False, 36),
          ("ffn1", 256, 256, 512, False, 36), ("ffn2", 512, 0, 256, True, 36),
          ("qk_v", 256, 0, 512, False, 18))
ATTENTION_PER_PAIR = 18  # self and cross launches each, per match_pair


def encode_us(reps=2000):
    """Microseconds of one cuTensorMapEncodeTiled call (a 1024 x 768 bf16
    matrix in 64 x 64 boxes, 128 B swizzle), libcuda's own function."""
    cuda = ctypes.CDLL("libcuda.so.1")
    enc = cuda.cuTensorMapEncodeTiled
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    buf = (ctypes.c_uint8 * 128)()
    dims, strides = (u64 * 2)(768, 1024), (u64 * 1)(1536)
    box, unit = (u32 * 2)(64, 64), (u32 * 2)(1, 1)
    args = (buf, 9, 2, ctypes.c_void_p(1 << 20), dims, strides, box, unit, 0, 3, 2, 0)
    if enc(*args):
        return None
    t = time.perf_counter()
    for _ in range(reps):
        enc(*args)
    return (time.perf_counter() - t) / reps * 1e6


def worker(root: Path) -> dict:
    sys.path[:0] = [str(HERE)]
    import chip_smoke as cs  # puts this checkout's src first; the root's goes before it

    sys.path.insert(0, str(root / "src"))
    import torch

    from lightglue_tpu_torch.kernels import _build
    from lightglue_tpu_torch.kernels import layer_stack as ls

    assert Path(ls.__file__).resolve().is_relative_to(root.resolve()), ls.__file__
    t = time.perf_counter()
    _build.lib()
    built = time.perf_counter() - t
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=bf16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def host_us(fn, reps=200):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        us = (time.perf_counter() - t) / reps * 1e6
        torch.cuda.synchronize()
        return us

    out = {"root": str(root), "build_s": round(built, 1), "linear": {}, "attention": {}}
    m = 1024
    for label, k1, k2, n, res, weight in LINEAR:
        a, a2 = rand(1, m, k1), rand(1, m, k2) if k2 else None
        w = (rand(k1 + k2, n, dtype=torch.float32) / math.sqrt(k1 + k2)).to(bf16)
        b = (rand(n, dtype=torch.float32) / math.sqrt(k1 + k2)).to(bf16)
        r = rand(1, m, n) if res else None
        err = cs.compare(label, ls.linear(a, w, b, a2=a2, residual=r),
                         ls.linear_plain(a, w, b, a2, r), **cs.TOL["bf16"])
        a_cat = a if a2 is None else torch.cat([a, a2], -1)
        out["linear"][label] = dict(
            weight=weight, err=err, ms=cs.cuda_ms(lambda: ls.linear(a, w, b, a2=a2, residual=r)),
            addmm_ms=cs.cuda_ms(lambda: torch.addmm(b, a_cat[0], w)),
            host_us=host_us(lambda: ls.linear(a, w, b, a2=a2, residual=r)))
    e, heads = 256, 4
    ang = torch.rand(8, m, 32, generator=gen, device=dev) * 4
    emb = torch.stack([torch.cos(ang), torch.sin(ang)], 1)
    freqs = torch.cat([emb, emb], -1).contiguous()
    digest = hashlib.sha256()  # the attention outputs' bits: equal roots compute alike
    for label, bsz, rope in (("self rope", 1, True), ("cross", 1, False), ("cross x8", 8, False)):
        if rope:
            qkv = rand(bsz, m, 3 * e)
            args = (qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:], freqs[:bsz])
        else:
            kv = rand(bsz, m, 2 * e)
            args = (rand(bsz, m, e), kv[..., :e], kv[..., e:], None)
        got = ls.attention(*args, None, None, heads, bf16)
        err = cs.compare(label, got, ls.attention_plain(*args, None, None, heads, bf16),
                         **cs.TOL["bf16"])
        digest.update(got.cpu().view(torch.int16).numpy().tobytes())
        q, k, v = (t.reshape(bsz, m, heads, 64).transpose(1, 2) for t in args[:3])
        out["attention"][label] = dict(
            pairs=bsz, err=err, ms=cs.cuda_ms(lambda: ls.attention(*args, None, None, heads, bf16)),
            sdpa_ms=cs.cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)),
            host_us=host_us(lambda: ls.attention(*args, None, None, heads, bf16)))
    # the other rungs' operand modes at the same shapes: MIXED (fp32
    # activations, bf16 products, fp32 out; the attention's fp32 stats and
    # out) and INT8 (int8 weights, fp32 scale and bias)
    f32 = torch.float32
    mixed, int8 = 0.0, 0.0
    for label, k1, k2, n, res, weight in LINEAR:
        a, a2 = rand(1, m, k1, dtype=f32), rand(1, m, k2, dtype=f32) if k2 else None
        w32 = rand(k1 + k2, n, dtype=f32) / math.sqrt(k1 + k2)
        b32 = rand(n, dtype=f32) / math.sqrt(k1 + k2)
        r = rand(1, m, n, dtype=f32) if res else None
        wb = w32.to(bf16)
        cs.compare(f"{label} mixed", ls.linear(a, wb, b32, a2=a2, residual=r),
                   ls.linear_plain(a, wb, b32, a2, r), atol=1e-4, rtol=1e-4)
        mixed += weight * cs.cuda_ms(lambda: ls.linear(a, wb, b32, a2=a2, residual=r))
        sc = (w32.abs().amax(0) / 127).clamp_min(1e-8)
        wq = torch.clamp(torch.round(w32 / sc), -127, 127).to(torch.int8)
        ab, a2b, rb = (t if t is None else t.to(bf16) for t in (a, a2, r))
        cs.compare(f"{label} int8", ls.linear(ab, wq, b32, a2=a2b, residual=rb, scale=sc),
                   ls.linear_plain(ab, wq, b32, a2b, rb, scale=sc), **cs.TOL["bf16"])
        int8 += weight * cs.cuda_ms(lambda: ls.linear(ab, wq, b32, a2=a2b, residual=rb, scale=sc))
    out["linear_mixed_pair_ms"], out["linear_int8_pair_ms"] = mixed, int8
    mixed = 0.0
    for label, rope in (("self rope", True), ("cross", False)):
        if rope:
            qkv = rand(1, m, 3 * e)
            args = (qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:], freqs[:1])
        else:
            kv = rand(1, m, 2 * e)
            args = (rand(1, m, e), kv[..., :e], kv[..., e:], None)
        cs.compare(f"{label} mixed", ls.attention(*args, None, None, heads, f32, f32),
                   ls.attention_plain(*args, None, None, heads, f32, f32), atol=1e-3, rtol=1e-3)
        mixed += ATTENTION_PER_PAIR * cs.cuda_ms(
            lambda: ls.attention(*args, None, None, heads, f32, f32))
    out["attention_mixed_pair_ms"] = mixed
    lin = out["linear"].values()
    att = out["attention"]
    out["linear_pair_ms"] = sum(c["weight"] * c["ms"] for c in lin)
    out["addmm_pair_ms"] = sum(c["weight"] * c["addmm_ms"] for c in lin)
    out["attention_pair_ms"] = ATTENTION_PER_PAIR * (att["self rope"]["ms"] + att["cross"]["ms"])
    out["sdpa_pair_ms"] = ATTENTION_PER_PAIR * (att["self rope"]["sdpa_ms"] + att["cross"]["sdpa_ms"])
    out["encode_us"] = encode_us()
    out["attention_digest"] = digest.hexdigest()[:16]
    return out


def variant_root(name: str, assignment: str) -> Path:
    """A copy of this checkout's package with one ``constexpr int NAME = V;``
    of csrc/ changed, under build/tune/<name>."""
    const, value = assignment.split("=")
    root = HERE / "build" / "tune" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(HERE / "src" / "lightglue_tpu_torch", root / "src" / "lightglue_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    hits = 0
    for src in (root / "src" / "lightglue_tpu_torch" / "csrc").glob("*.c*"):
        text, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                          src.read_text())
        hits += n
        src.write_text(text)
    if not hits:
        raise SystemExit(f"no constexpr int {const} in csrc/")
    return root


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("roots", nargs="*", default=["."])
    parser.add_argument("--variant", action="append", default=[],
                        help="NAME=VALUE: a copy of this checkout with that constant, timed last")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_intermixed_args()
    if args.worker:
        print("RESULT " + json.dumps(worker(Path(args.worker))), flush=True)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    roots = [Path(r) for r in args.roots]
    roots += [variant_root(v.replace("=", "_"), v) for v in args.variant]
    for root in roots:
        proc = subprocess.run([sys.executable, __file__, "--worker", str(root)],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:])
            raise SystemExit(f"{root}: worker failed")
        r = json.loads(lines[-1][len("RESULT "):])
        parts = ", ".join(f"{k} {c['ms'] * 1e3:.1f} us (addmm {c['addmm_ms'] * 1e3:.1f}, host "
                          f"{c['host_us']:.1f})" for k, c in r["linear"].items())
        print(f"{root}: linear {r['linear_pair_ms']:.4f} ms a pair (addmm "
              f"{r['addmm_pair_ms']:.4f}) | {parts}", flush=True)
        parts = ", ".join(f"{k} {c['ms'] * 1e3 / c['pairs']:.1f} us a pair (sdpa "
                          f"{c['sdpa_ms'] * 1e3 / c['pairs']:.1f}, host {c['host_us']:.1f})"
                          for k, c in r["attention"].items())
        print(f"{root}: attention {r['attention_pair_ms']:.4f} ms a pair (sdpa "
              f"{r['sdpa_pair_ms']:.4f}) | {parts} | encode {r['encode_us']:.2f} us a map, "
              f"build {r['build_s']} s, outputs {r['attention_digest']}", flush=True)
        print(f"{root}: MIXED linear {r['linear_mixed_pair_ms']:.4f}, attention "
              f"{r['attention_mixed_pair_ms']:.4f}; INT8 linear {r['linear_int8_pair_ms']:.4f} "
              "ms a pair", flush=True)
        print("JSON " + json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
