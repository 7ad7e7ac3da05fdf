"""Time the FP32 rung's wgmma kernels of one or more checkouts on one CUDA card.

``csrc/linear.cu``'s fp32 GEMM and ``csrc/flash_attn.cu``'s fp32 kernel
(3xTF32) of each root (a checkout's root directory) run in their own process,
through that root's wrappers, at the shapes the FP32 routes give them:

- ``linear`` at the stack's projections, 1024 rows of E = 256: qkv (256 ->
  768) and the cross block's qk_v (256 -> 512), 18 each a pair; out (256 ->
  256), ffn1 (256 + 256 -> 512, two operands) and ffn2 (512 -> 256 with
  its residual), 36 each: 144 launches a pair;
- ``fused_mha`` on the 2048-keypoint route (self with RoPE, B = 2, 9 a
  pair; cross, B = 1, 18 a pair), the pad-to-64 route's 960-row self block
  (B = 2) and the TP shards' heads (H = 2 and 1);
- ``flash_attention`` at (2, 4, 2048, 64), the generic entry point;
- ``flash_attention_step`` at the ring's 512-row stripes, fp32 stats (576
  launches a ``forward_ring``) and bf16 stats.

Each output is checked against the plain version (the fp32 gate, 1e-4; the
step's carries at 2.4e-4 of their magnitude), then timed with
``chip_smoke.cuda_ms`` (a CUDA graph of ten calls, median of ten replays)
beside one PyTorch call for the same function with TF32 off (``addmm``,
``scaled_dot_product_attention`` without RoPE or per-tile rounding). Per
root it prints the per-pair sums and a digest of the outputs: two roots
that print the same digest computed every output bit for bit alike. Each
root's linear.cu and flash_attn.cu are compiled into their own shared
library (every root's nvcc at once, ``-Xptxas -v`` logged for the fp32
kernels), which the worker's wrappers run (``_build._lib``).

``--variant NAME`` times this checkout built with one of ``VARIANTS``'
edits of its sources (a copy under build/tune_fp32_wgmma/):
``explicit_hi`` (the consumers clear the low 13 bits of every raw fp32 tile
that wgmma reads as hi, instead of leaving the truncation to the tensor
core; its digest equal to this checkout's shows that the tensor core reads
a raw fp32 word as its truncation),
``lin_shallow`` and ``lin_deep`` (the fp32 GEMM's ring at two slots, two
blocks an SM, or at four, one block an SM, at every launch),
``late_release`` (pass 2 of the fp32 flash kernel frees a piece's ring slot
after its P.V instead of after its S), ``klo1`` / ``klo2`` (the lo copies, the
fp32 flash kernel's K pieces' and the GEMM's X chunks', with one or two
16 B units a thread in flight instead of all),
``vt2`` (V's transposed copy two items at a time instead of one). Roots run in the order given,
variants after them; give a parent first and last to bracket drift:

    git archive <parent> | tar -x -C build/parent
    python3 scripts/tune_torch_fp32_wgmma.py build/parent . . build/parent
    python3 scripts/tune_torch_fp32_wgmma.py . --variant explicit_hi
"""

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
N, PAD64, RING_N, ROWS, E = 2048, 960, 512, 1024, 256
# label, K1, K2 (the second operand's width), N, residual, launches a pair
LINEAR = (("qkv", E, 0, 3 * E, False, 18), ("qk_v", E, 0, 2 * E, False, 18),
          ("out", E, 0, E, False, 36), ("ffn1", E, E, 2 * E, False, 36),
          ("ffn2", 2 * E, 0, E, True, 36))
# label, heads, B, nq, nk, rope, launches a pair
FUSED = (("self 2x2048", 4, 2, N, N, True, 9), ("cross 2048", 4, 1, N, N, False, 18),
         ("self 2x960", 4, 2, PAD64, PAD64, True, 9),
         ("TP H=2 self", 2, 2, N, N, True, 9), ("TP H=2 cross", 2, 1, N, N, False, 18),
         ("TP H=1 self", 1, 2, N, N, True, 9), ("TP H=1 cross", 1, 1, N, N, False, 18))
STEP_LAUNCHES = 576
ENTRIES = ("lg_linear", "lg_fused_mha", "lg_flash_attention", "lg_flash_attention_step")
SOURCES = ("linear.cu", "flash_attn.cu")
# NAME: edits of this checkout's sources, (source, text, replacement)
LO_STORE = "    *reinterpret_cast<uint4*>(lo + i) = make_uint4(l[0], l[1], l[2], l[3]);\n"
LO_LOOP = "  for (int i = 4 * tid; i < n; i += 4 * threads) {"
STAGE_RULE = "<= TF_SMS ? TF_DEEP : TF_SHALLOW;"
EARLY_RELEASE = ("            release(s);  // V is in its copies and S is done: the next piece "
                 "may land\n")
PV_END = "                fence_operand(pl[q]);\n              }\n            }\n"
VARIANTS = {
    # hi written explicitly: the lo copy also clears the raw tile's low bits
    "explicit_hi": [("hopper.cuh", LO_STORE,
                     LO_STORE + "    *reinterpret_cast<uint4*>(const_cast<float*>(raw) + i) =\n"
                     "        make_uint4(h[0], h[1], h[2], h[3]);\n")],
    "lin_shallow": [("linear.cu", STAGE_RULE, "<= TF_SMS ? TF_SHALLOW : TF_SHALLOW;")],
    "lin_deep": [("linear.cu", STAGE_RULE, "<= TF_SMS ? TF_DEEP : TF_DEEP;")],
    "klo1": [("hopper.cuh", LO_LOOP, "#pragma unroll 1\n" + LO_LOOP)],
    "klo2": [("hopper.cuh", LO_LOOP, "#pragma unroll 2\n" + LO_LOOP)],
    "vt2": [("flash_attn.cu", "#pragma unroll 1\n        for (int it = 0;",
             "#pragma unroll 2\n        for (int it = 0;")],
    "late_release": [("flash_attn.cu", EARLY_RELEASE, ""),
                     ("flash_attn.cu", PV_END, PV_END + "            release(s);\n")],
}


def edited_csrc(name: str, edits) -> Path:
    """A copy of this checkout's csrc/ under build/tune_fp32_wgmma/NAME with
    each edit's text replaced (each must occur once)."""
    src = HERE / "src" / "lightglue_tpu_torch" / "csrc"
    out = HERE / "build" / "tune_fp32_wgmma" / name
    out.mkdir(parents=True, exist_ok=True)
    for f in src.iterdir():
        (out / f.name).write_text(f.read_text())
    for source, old, new in edits:
        text = (out / source).read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old[:60]!r} is not in {source} once")
        (out / source).write_text(text.replace(old, new))
    return out


def build(root: Path, name: str, csrc=None):
    """nvcc of a root's linear.cu and flash_attn.cu (with its headers; csrc:
    another copy of them) into one shared library under
    build/tune_fp32_wgmma/, started and returned unwaited; ptxas's report
    goes to the log."""
    out = HERE / "build" / "tune_fp32_wgmma"
    out.mkdir(parents=True, exist_ok=True)
    sys.path[:0] = [str(HERE / "src")]
    from lightglue_tpu_torch.kernels import _build

    lib = out / f"{name}.so"
    lib.unlink(missing_ok=True)
    csrc = csrc or root / "src" / "lightglue_tpu_torch" / "csrc"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
           str(csrc), *(str(csrc / s) for s in SOURCES), "-o", str(lib)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_lines(log: str):
    """ptxas's registers, stack and spills of every fp32 (tf32) kernel."""
    lines, fn = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1] if "'" in ln else ln
        elif fn and "tf32" in fn and ("Used" in ln or "spill" in ln):
            lines.append(f"{fn[:90]}: {ln.strip()}")
    return lines


def worker(root: Path, lib: Path) -> dict:
    sys.path[:0] = [str(HERE)]
    import chip_smoke as cs  # puts this checkout's src first; the root's goes before it

    sys.path.insert(0, str(root / "src"))
    import torch
    import torch.nn.functional as F

    from lightglue_tpu_torch.kernels import _build
    from lightglue_tpu_torch.kernels import attention as at
    from lightglue_tpu_torch.kernels import layer_stack as ls

    assert Path(at.__file__).resolve().is_relative_to(root.resolve()), at.__file__
    torch.backends.cuda.matmul.allow_tf32 = False  # true fp32 products beside the kernels
    torch.backends.cudnn.allow_tf32 = False
    handle = ctypes.CDLL(str(lib))
    for name in ENTRIES:
        fn = getattr(handle, name)
        fn.argtypes, fn.restype = _build._SIGNATURES[name], ctypes.c_int
    _build._lib = handle  # the wrappers below call these entries alone
    dev, f32, bf16 = torch.device("cuda"), torch.float32, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    gate = cs.TOL["fp32"]

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def freqs(b, n):
        ang = torch.rand(b, n, 32, generator=gen, device=dev) * 4
        emb = torch.stack([torch.cos(ang), torch.sin(ang)], 1)
        return torch.cat([emb, emb], -1).contiguous()

    digest = hashlib.sha256()  # the outputs' bits: equal roots compute alike
    out = {"root": str(root), "linear": {}, "fused": {}}
    for label, k1, k2, n, res, weight in LINEAR:
        a = rand(1, ROWS, k1)
        a2 = rand(1, ROWS, k2) if k2 else None
        w = rand(k1 + k2, n, scale=(k1 + k2) ** -0.5)
        b = rand(n, scale=0.1)
        r = rand(1, ROWS, n) if res else None
        got = ls.linear(a, w, b, a2, r)
        err = cs.compare(f"linear {label}", got, ls.linear_plain(a, w, b, a2, r), **gate)
        digest.update(got.cpu().numpy().tobytes())
        x = a if a2 is None else torch.cat([a, a2], -1)
        lib_fn = ((lambda: torch.addmm(b, x[0], w) + r[0]) if res else
                  (lambda: torch.addmm(b, x[0], w)))
        out["linear"][label] = {"weight": weight, "err": err,
                                "ms": cs.cuda_ms(lambda: ls.linear(a, w, b, a2, r)),
                                "addmm_ms": cs.cuda_ms(lib_fn)}
    for label, heads, b, nq, nk, rope, weight in FUSED:
        e = 64 * heads
        if rope:
            qkv = rand(b, nq, 3 * e)
            args = (qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:], freqs(b, nq))
        else:
            kv = rand(b, nk, 2 * e)
            args = (rand(b, nq, e), kv[..., :e], kv[..., e:], None)
        q, k, v = (t.reshape(t.shape[0], t.shape[1], heads, 64).transpose(1, 2)
                   for t in args[:3])
        got = at.fused_mha(*args, num_heads=heads, stat_dtype=f32)
        err = cs.compare(f"fused_mha {label}", got,
                         at.fused_mha_plain(*args, num_heads=heads, stat_dtype=f32), **gate)
        digest.update(got.cpu().numpy().tobytes())
        out["fused"][label] = {
            "weight": weight, "err": err,
            "ms": cs.cuda_ms(lambda: at.fused_mha(*args, num_heads=heads, stat_dtype=f32)),
            "sdpa_ms": cs.cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))}
    q, k, v = (rand(2, 4, N, 64) for _ in range(3))
    got = at.flash_attention(q, k, v, stat_dtype=f32)
    flash = {"err": cs.compare("flash_attention", got,
                               at.flash_attention_plain(q, k, v, stat_dtype=f32), **gate),
             "ms": cs.cuda_ms(lambda: at.flash_attention(q, k, v, stat_dtype=f32)),
             "sdpa_ms": cs.cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))}
    digest.update(got.cpu().numpy().tobytes())
    out["flash"] = flash
    # the ring step: a 512-row stripe against a 512-key block, running carries
    q, k, v = (rand(1, 4, RING_N, 64) for _ in range(3))
    m = rand(1, 4, RING_N, 1)
    l = torch.rand(1, 4, RING_N, 1, generator=gen, device=dev) * 64 + 64  # l near 100
    acc = rand(1, 4, RING_N, 64, scale=8.0)
    step = {}
    for rung, sdt in (("fp32 stats", f32), ("bf16 stats", bf16)):
        kw = dict(row0=RING_N, col0=2 * RING_N, stat_dtype=sdt)
        got = at.flash_attention_step(q, k, v, m, l, acc, None, **kw)
        want = at.flash_attention_step_plain(q, k, v, m, l, acc, None, **kw)
        tol = dict(atol=2.4e-4, rtol=2.4e-4) if sdt == f32 else cs.TOL["bf16"]
        step[rung + "_err"] = max(cs.compare(f"step {rung} {name}", g, w, **tol)
                                  for name, g, w in zip("mla", got, want))
        for g in got:
            digest.update(g.cpu().numpy().tobytes())
        step[rung + "_ms"] = cs.cuda_ms(
            lambda: at.flash_attention_step(q, k, v, m, l, acc, None, **kw))
    out["step"] = step
    out["linear_pair_ms"] = sum(c["weight"] * c["ms"] for c in out["linear"].values())
    out["addmm_pair_ms"] = sum(c["weight"] * c["addmm_ms"] for c in out["linear"].values())
    rows = list(out["fused"].values())
    out["fused_pair_ms"] = sum(c["weight"] * c["ms"] for c in rows[:2])
    out["sdpa_pair_ms"] = sum(c["weight"] * c["sdpa_ms"] for c in rows[:2])
    out["step_ring_ms"] = step["fp32 stats_ms"] * STEP_LAUNCHES
    out["digest"] = digest.hexdigest()[:16]
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("roots", nargs="*", default=["."])
    parser.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS),
                        help="this checkout built with that variant's flags, timed last")
    parser.add_argument("--worker", nargs=2, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        root, lib = args.worker
        print("RESULT " + json.dumps(worker(Path(root), Path(lib))), flush=True)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    runs, builds = [], {}
    for root in map(Path, args.roots):
        key = str(root.resolve())
        if key not in builds:
            builds[key] = build(root, f"root{len(builds)}")
        runs.append((str(root), root, builds[key][0]))
    for name in args.variant:
        builds[name] = build(HERE, name, edited_csrc(name, VARIANTS[name]))
        runs.append((name, HERE, builds[name][0]))
    for key, (lib, proc) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc {lib.name} failed:\n{log[-6000:]}")
        for ln in ptxas_lines(log):
            print(f"ptxas {Path(key).name}: {ln}", flush=True)
    for label, root, lib in runs:
        proc = subprocess.run([sys.executable, __file__, "--worker", str(root), str(lib)],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:])
            raise SystemExit(f"{label}: worker failed")
        r = json.loads(lines[-1][len("RESULT "):])
        lin = ", ".join(f"{k} {c['ms'] * 1e3:.1f} us (addmm {c['addmm_ms'] * 1e3:.1f})"
                        for k, c in r["linear"].items())
        print(f"{label}: linear FP32 {r['linear_pair_ms']:.4f} ms a pair (addmm "
              f"{r['addmm_pair_ms']:.4f}) | {lin}", flush=True)
        fused = ", ".join(f"{k} {c['ms'] * 1e3:.1f} us (sdpa {c['sdpa_ms'] * 1e3:.1f})"
                          for k, c in r["fused"].items())
        print(f"{label}: fused_mha FP32 {r['fused_pair_ms']:.4f} ms a 2048 pair (sdpa "
              f"{r['sdpa_pair_ms']:.4f}) | {fused}", flush=True)
        f, s = r["flash"], r["step"]
        print(f"{label}: flash_attention (2, 4, 2048, 64) FP32 {f['ms'] * 1e3:.1f} us (sdpa "
              f"{f['sdpa_ms'] * 1e3:.1f}) | step 512 fp32 stats {s['fp32 stats_ms'] * 1e3:.2f} us "
              f"({r['step_ring_ms']:.4f} ms a forward_ring), bf16 stats "
              f"{s['bf16 stats_ms'] * 1e3:.2f} us | outputs {r['digest']}", flush=True)
        print("JSON " + json.dumps(dict(r, label=label)), flush=True)


if __name__ == "__main__":
    main()
