"""Time flash_attn.cu's bf16 kernel of one or more checkouts on one CUDA card.

Each root (a checkout's root directory) is timed in its own process, which
runs that root's ``flash_attn.cu`` through that root's wrappers at the
shapes the routes give them (four heads of 64 unless a TP shard's, E =
64 H):

- ``fused_mha`` on the 2048-keypoint route: self with RoPE, two images
  stacked (B = 2, q, k, v column slices of one qkv projection), and each
  cross direction (B = 1, k and v slices of one [qk | v] projection), at
  BF16 (bf16 stats and out) and MIXED (fp32 stats and out); per 2048 pair
  9 self and 18 cross launches;
- ``fused_mha`` on the pad-to-64 route's 960-row self block (B = 2, 9 a
  pair);
- the TP shards' ``fused_mha`` at H = 2 and H = 1 (self B = 2, cross B =
  1, 9 + 18 a pair);
- ``flash_attention`` at (2, 4, 2048, 64), the generic entry point (one
  call);
- ``flash_attention_step`` at the ring's 512-row stripes (B = 1, fp32
  stats as ``forward_ring`` runs it, and bf16 stats; 576 launches a
  ``forward_ring``).

Each output is checked against the plain version first (bf16 2e-2, MIXED
1e-3, the step's carries at 2e-2 of their magnitude), then timed with
``chip_smoke.cuda_ms`` (a CUDA graph of ten calls, median of ten replays)
beside ``scaled_dot_product_attention`` on the same heads (no RoPE, no
per-tile rounding: the library's yardstick). Per root it prints the
per-pair sums, the host microseconds of one eager call (enqueue only, the
tensor maps' encoding included), and a digest of the outputs (two roots
that print the same digest computed every output bit for bit alike).
Each root's ``csrc/flash_attn.cu`` alone is compiled into its own shared
library (every root's nvcc at once), which the worker's wrappers run
(``_build._lib``): those wrappers call nothing else. ``--variant NAME``
times this checkout with one of ``VARIANTS``' edits of its flash_attn.cu
(written under build/tune_flash/). Roots run in the order given, variants
after them; give a parent first and last to bracket drift:

    git archive <parent> | tar -x -C build/parent
    python3 scripts/tune_torch_flash.py build/parent . . build/parent
    python3 scripts/tune_torch_flash.py . --variant split4 --variant d_l2
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
N, PAD64, RING_N = 2048, 960, 512
# label, heads, B, nq, nk, rope, launches a pair (a forward_ring for the step)
FUSED = (("self 2x2048", 4, 2, N, N, True, 9), ("cross 2048", 4, 1, N, N, False, 18),
         ("self 2x960", 4, 2, PAD64, PAD64, True, 9),
         ("TP H=2 self", 2, 2, N, N, True, 9), ("TP H=2 cross", 2, 1, N, N, False, 18),
         ("TP H=1 self", 1, 2, N, N, True, 9), ("TP H=1 cross", 1, 1, N, N, False, 18))
STEP_LAUNCHES = 576
FLASH_ENTRIES = ("lg_fused_mha", "lg_flash_attention", "lg_flash_attention_step")

# pass 2 at bf16 stats with the next chunk's p formed while the tensor cores
# run this chunk's P.V (two P operands in registers)
PIPE_PASS2 = """      int c = v * OWN;
      if constexpr (STORE) {
        // the p of a chunk from pass 1's rounded s: bf16 stats, p in pairs
        // (one row, columns 2 t4, 2 t4 + 1) rounded in one packed conversion,
        // which is also P.V's A operand (keys 16 kk.. of the chunk: n-tiles
        // 2 kk and 2 kk + 1); the next chunk's p is formed while the tensor
        // cores run this one's P.V
        auto form = [&](unsigned (&pa)[D / 16][4], int cs) {
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            const unsigned w = store[(cs * 16 + k) * 128 + tid];
            const int r = k & 1;  // row0 or row0 + 8
            const unsigned p = pack_bf16(expf(__uint_as_float(w << 16) - m[r]),
                                         expf(__uint_as_float(w & 0xffff0000u) - m[r]));
            ps[r] += __uint_as_float(p << 16);
            ps[r] += __uint_as_float(p & 0xffff0000u);
            pa[k / 4][k % 4] = p;
          }
        };
        unsigned cur[D / 16][4], nxt[D / 16][4];
        int j = first(v, wg);
        if (j < nct) {
          mbar_wait(full(wg, i % STAGES), (i / STAGES) & 1);
          form(cur, c);
        }
        for (; j < nct; j += SPLIT, ++i, ++c) {
          const int s = i % STAGES;
          const bf16_t* vs = slot(wg, s);
          fence_operand(pv);
          wgmma_fence();
#pragma unroll
          for (int k16 = 0; k16 < 4; ++k16)
            wgmma_m64n64_rs(pv, cur[k16], mnmajor_desc(vs, 128, k16), 1);
          wgmma_commit();
          const bool more = j + SPLIT < nct;
          if (more) {
            mbar_wait(full(wg, (i + 1) % STAGES), ((i + 1) / STAGES) & 1);
            form(nxt, c + 1);
          }
          wgmma_wait<0>();
          fence_operand(pv);
#pragma unroll
          for (int k16 = 0; k16 < 4; ++k16) fence_operand(cur[k16]);
          release(s);
          if (more) {
#pragma unroll
            for (int k16 = 0; k16 < 4; ++k16)
#pragma unroll
              for (int e = 0; e < 4; ++e) cur[k16][e] = nxt[k16][e];
          }
        }
      } else {
      for (int j = first(v, wg); j < nct; j += SPLIT, ++i, ++c) {
        const int s = i % STAGES;
        mbar_wait(full(wg, s), (i / STAGES) & 1);
        {
"""
# Edits of flash_attn.cu, NAME: (edits, split, checked). Each edit replaces
# the source's text from its first string through the first match of its
# second at or after it with its third; `split`, where set, is what the
# Python flash_split returns to match the variant's C rule; an unchecked
# variant computes another function (a diagnostic) and is timed only.
VARIANTS = {
    # one split at every shape
    "split4": ([("inline int flash_split(", "}\n",
                 "inline int flash_split(int, int) { return 4; }\n")], 4, True),
    "split8": ([("inline int flash_split(", "}\n",
                 "inline int flash_split(int, int) { return 8; }\n")], 8, True),
    "pipe": ([("      int c = v * OWN;\n      for (int j = first(v, wg); j < nct;",
               "        } else {  // S again, in halves of 32 keys, and their P.V\n", PIPE_PASS2),
              ("        release(s);\n      }\n      ps[0] = quad_sum", "quad_sum",
               "        release(s);\n      }\n      }\n      ps[0] = quad_sum")], 0, True),
    # every chunk from the head's first 64 keys: the same work on data that
    # stays in L2 (the stream's cost)
    "d_l2": ([("if (!pass || !STORE) load(", ";\n",
               "if (!pass || !STORE) load(slot(r, s), &kmap, 1, full(r, s), 0);\n"),
              ("if (pass) load(", ";\n",
               "if (pass) load(slot(r, s) + (STORE ? 0 : TILE), &vmap, 2, full(r, s), 0);\n")],
             0, False),
    # no pass 2: neither its loads nor its products (the meetings stay)
    "d_nopass2": ([("for (int pass = 0; pass < 2;", "pass < 2;", "for (int pass = 0; pass < 1;"),
                   ("      int c = v * OWN;\n      for (int j = first(v, wg); j < nct;", "j < nct;",
                    "      int c = v * OWN;\n      for (int j = first(v, wg); j < 0;")], 0, False),
    # no exp at bf16 stats' pass 2 (the exponential's cost)
    "d_noexp": ([("const unsigned w = pack_bf16(expf(sc[2 * k] - m[r])", ";\n",
                  "const unsigned w = pack_bf16(sc[2 * k] - m[r], sc[2 * k + 1] - m[r]);\n")],
                0, False),
}


def edited(text: str, edits) -> str:
    for start, end, new in edits:
        if text.count(start) != 1:
            raise SystemExit(f"variant: {start[:50]!r} is not in flash_attn.cu once")
        a = text.index(start)
        b = text.index(end, a) + len(end)
        text = text[:a] + new + text[b:]
    return text


def build(root: Path, source: Path, name: str):
    """nvcc of one flash_attn.cu (with its root's headers) into a shared
    library under build/tune_flash/, started and returned unwaited."""
    out = HERE / "build" / "tune_flash"
    out.mkdir(parents=True, exist_ok=True)
    sys.path[:0] = [str(HERE / "src")]
    from lightglue_tpu_torch.kernels import _build

    lib = out / f"{name}.so"
    lib.unlink(missing_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
           str(root / "src" / "lightglue_tpu_torch" / "csrc"), str(source), "-o", str(lib)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def worker(root: Path, lib: Path, split: int, check: bool) -> dict:
    sys.path[:0] = [str(HERE)]
    import chip_smoke as cs  # puts this checkout's src first; the root's goes before it

    sys.path.insert(0, str(root / "src"))
    import torch
    import torch.nn.functional as F

    from lightglue_tpu_torch.kernels import _build
    from lightglue_tpu_torch.kernels import attention as at

    assert Path(at.__file__).resolve().is_relative_to(root.resolve()), at.__file__
    handle = ctypes.CDLL(str(lib))
    for name in FLASH_ENTRIES:
        fn = getattr(handle, name)
        fn.argtypes, fn.restype = _build._SIGNATURES[name], ctypes.c_int
    _build._lib = handle  # the wrappers below call these three entries alone
    if split:
        at.flash_split = lambda heads, nq: split
    compare = cs.compare if check else (lambda *a, **k: float("nan"))
    dev, bf16, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
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

    def freqs(b, n):
        ang = torch.rand(b, n, 32, generator=gen, device=dev) * 4
        emb = torch.stack([torch.cos(ang), torch.sin(ang)], 1)
        return torch.cat([emb, emb], -1).contiguous()

    digest = hashlib.sha256()  # the outputs' bits: equal roots compute alike
    out = {"root": str(root), "fused": {}}
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
        row = {"weight": weight,
               "sdpa_ms": cs.cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))}
        for rung, kw, tol in (("bf16", dict(stat_dtype=bf16), cs.TOL["bf16"]),
                              ("mixed", dict(stat_dtype=f32, out_dtype=f32),
                               dict(atol=1e-3, rtol=1e-3))):
            got = at.fused_mha(*args, num_heads=heads, **kw)
            row[rung + "_err"] = compare(f"{label} {rung}", got,
                                            at.fused_mha_plain(*args, num_heads=heads, **kw),
                                            **tol)
            digest.update(got.float().cpu().numpy().tobytes())
            row[rung + "_ms"] = cs.cuda_ms(lambda: at.fused_mha(*args, num_heads=heads, **kw))
        row["host_us"] = host_us(lambda: at.fused_mha(*args, num_heads=heads, stat_dtype=bf16))
        out["fused"][label] = row
    q, k, v = (rand(2, 4, N, 64) for _ in range(3))
    flash = {"sdpa_ms": cs.cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))}
    for rung, kw, tol in (("bf16", dict(stat_dtype=bf16), cs.TOL["bf16"]),
                          ("mixed", dict(stat_dtype=f32, out_dtype=f32),
                           dict(atol=1e-3, rtol=1e-3))):
        got = at.flash_attention(q, k, v, **kw)
        flash[rung + "_err"] = compare(f"flash_attention {rung}", got,
                                          at.flash_attention_plain(q, k, v, **kw), **tol)
        digest.update(got.float().cpu().numpy().tobytes())
        flash[rung + "_ms"] = cs.cuda_ms(lambda: at.flash_attention(q, k, v, **kw))
    out["flash"] = flash
    # the ring step: a 512-row stripe against a 512-key block, running carries
    q, k, v = (rand(1, 4, RING_N, 64) for _ in range(3))
    m = torch.randn(1, 4, RING_N, 1, generator=gen, device=dev)
    l = torch.rand(1, 4, RING_N, 1, generator=gen, device=dev) * 64 + 1
    acc = torch.randn(1, 4, RING_N, 64, generator=gen, device=dev) * 8
    step = {}
    for rung, sdt in (("fp32 stats", f32), ("bf16 stats", bf16)):
        kw = dict(row0=RING_N, col0=2 * RING_N, stat_dtype=sdt)
        got = at.flash_attention_step(q, k, v, m, l, acc, None, **kw)
        want = at.flash_attention_step_plain(q, k, v, m, l, acc, None, **kw)
        step[rung + "_err"] = max(compare(f"step {rung} {name}", g, w, atol=2e-2,
                                             rtol=2e-2 if sdt == bf16 else 1e-4)
                                  for name, g, w in zip("mla", got, want))
        for g in got:
            digest.update(g.cpu().numpy().tobytes())
        step[rung + "_ms"] = cs.cuda_ms(
            lambda: at.flash_attention_step(q, k, v, m, l, acc, None, **kw))
    step["host_us"] = host_us(lambda: at.flash_attention_step(q, k, v, m, l, acc, None,
                                                              row0=RING_N, col0=0))
    out["step"] = step
    rows = out["fused"].values()
    for rung in ("bf16", "mixed"):
        out[f"fused_{rung}_pair_ms"] = sum(c["weight"] * c[rung + "_ms"] for c in
                                           list(rows)[:2])
    out["sdpa_pair_ms"] = sum(c["weight"] * c["sdpa_ms"] for c in list(rows)[:2])
    out["digest"] = digest.hexdigest()[:16]
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("roots", nargs="*", default=["."])
    parser.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS),
                        help="this checkout with that edit of csrc/flash_attn.cu, timed last")
    parser.add_argument("--worker", nargs=4, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        root, lib, split, check = args.worker
        print("RESULT " + json.dumps(worker(Path(root), Path(lib), int(split), check == "1")),
              flush=True)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    runs, builds = [], {}
    for i, root in enumerate(map(Path, args.roots)):
        key = str(root.resolve())
        if key not in builds:
            builds[key] = build(root, root / "src/lightglue_tpu_torch/csrc/flash_attn.cu",
                                f"root{len(builds)}")
        runs.append((str(root), root, builds[key][0], 0, True))
    source = (HERE / "src/lightglue_tpu_torch/csrc/flash_attn.cu").read_text()
    for name in args.variant:
        edits, split, checked = VARIANTS[name]
        copy = HERE / "build" / "tune_flash" / f"{name}.cu"
        copy.parent.mkdir(parents=True, exist_ok=True)
        copy.write_text(edited(source, edits))
        builds[name] = build(HERE, copy, name)
        runs.append((name, HERE, builds[name][0], split, checked))
    for lib, proc in builds.values():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc {lib.name} failed:\n{log[-3000:]}")
    for label, root, lib, split, check in runs:
        proc = subprocess.run([sys.executable, __file__, "--worker", str(root), str(lib),
                               str(split), str(int(check))], capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:])
            raise SystemExit(f"{label}: worker failed")
        r = json.loads(lines[-1][len("RESULT "):])
        parts = ", ".join(f"{k} {c['bf16_ms'] * 1e3:.1f} / {c['mixed_ms'] * 1e3:.1f} us (sdpa "
                          f"{c['sdpa_ms'] * 1e3:.1f}, host {c['host_us']:.1f})"
                          for k, c in r["fused"].items())
        print(f"{label}: fused_mha a 2048 pair BF16 {r['fused_bf16_pair_ms']:.4f} / MIXED "
              f"{r['fused_mixed_pair_ms']:.4f} ms (sdpa {r['sdpa_pair_ms']:.4f}) | per call "
              f"BF16 / MIXED: {parts}", flush=True)
        f, s = r["flash"], r["step"]
        print(f"{label}: flash_attention (2, 4, 2048, 64) BF16 {f['bf16_ms'] * 1e3:.1f} / MIXED "
              f"{f['mixed_ms'] * 1e3:.1f} us (sdpa {f['sdpa_ms'] * 1e3:.1f}) | step 512: fp32 "
              f"stats {s['fp32 stats_ms'] * 1e3:.2f} us ({s['fp32 stats_ms'] * STEP_LAUNCHES:.4f} "
              f"ms a forward_ring), bf16 stats {s['bf16 stats_ms'] * 1e3:.2f} us, host "
              f"{s['host_us']:.1f} us | outputs {r['digest']}", flush=True)
        print("JSON " + json.dumps(dict(r, label=label)), flush=True)


if __name__ == "__main__":
    main()
