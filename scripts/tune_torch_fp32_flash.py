"""Time variants of the FP32 rung's 3xTF32 kernels on one card.

``csrc/flash_attn.cu:flash_tf32_kernel`` splits each fp32 K and V element
into its (hi, lo) TF32 pair as the warp loads it as a B fragment: with one
row group a block (C = 1) each of the four warps splits the whole chunk,
and S is computed twice (two passes a tile), so an element is split up to
eight times. ``SPLIT_ONCE`` below splits each landed chunk once for the
block into (hi, lo) pair buffers (K at a 68-pair pitch, V at 70, so that a
half-warp's 8-byte loads fall in 16 different bank pairs), one more barrier
a chunk and 70 KB more shared memory: one block an SM where the source fits
two. The split by rounding (both kernels) splits with ``cvt.rna`` for hi
and lo (``mma.cuh:split_tf32``, the fp32 model conv's) in place of the
sources' truncation (``split_tf32_rz``). ``csrc/linear.cu:linear_tf32_kernel``
is also timed at its 64-deep chunks and ``linear_tile``'s tiles against
32-deep chunks and a tile rule that aims for 128 blocks instead of 256
(larger tiles: more products per split). Each variant's registers and its
most frequent SASS opcodes are printed.

Each variant is a copy of the source with those lines replaced, built into
its own library under ``build/tune/`` (``tune_torch_stack_kernels.build``),
its registers and shared memory printed; the port's wrappers run it
(``_build._lib`` set to its handle) at the FP32 rung's shapes: ``fused_mha``
self (RoPE, B = 2) and cross (B = 1) at 2048 keypoints, ``flash_attention``
(2, 4, 2048, 64), the ring step (1, 4, 512, 64) with carries, and the five
projections of one stack layer at 1024 rows. Each output is checked against
its plain version at ``chip_smoke.TOL["fp32"]``, then timed with
``chip_smoke.cuda_ms``, variants in one order and then the reverse. From the
root of a checkout, on a machine with nvcc:

    python3 scripts/tune_torch_fp32_flash.py [PARENT]

PARENT, the root of an earlier checkout whose ``lg_fused_mha``,
``lg_flash_attention``, ``lg_flash_attention_step`` and ``lg_linear`` take
the same arguments: its ``flash_attn.cu`` and ``linear.cu`` (with its own
headers) are built and timed as one more variant each, in the same process
and on the same inputs, through this checkout's wrappers.
"""

import math
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]

import chip_smoke as cs  # noqa: E402
import tune_torch_stack_kernels as tune  # noqa: E402
from lightglue_tpu_torch.kernels import _build  # noqa: E402
from lightglue_tpu_torch.kernels import attention as at  # noqa: E402
from lightglue_tpu_torch.kernels import layer_stack as ls  # noqa: E402
from lightglue_tpu_torch.precision import Precision, policy_for, precision_scope  # noqa: E402

# (old, new) line replacements of flash_attn.cu that make SPLIT_ONCE
SPLIT_ONCE = [
    ("constexpr float NEG = -1e30f;",
     "constexpr float NEG = -1e30f;\nconstexpr int VPP = HD + 6;  // V pair pitch"),
    ("  float* red = kv + TF32_STAGES * 2 * KC * FP;      // C > 1: [WARPS][16][RS]",
     "  float* red = kv + TF32_STAGES * 2 * KC * FP;      // C > 1: [WARPS][16][RS]\n"
     "  uint2* kp = reinterpret_cast<uint2*>(red + WARPS * 16 * RS);  // [KC][FP] K pairs\n"
     "  uint2* vp = kp + KC * FP;                                     // [KC][VPP] V pairs"),
    ("  // s = quant(Q.K^T * scale) over this warp's KW keys of chunk c\n"
     "  // (mma.cuh:tf32_scores)",
     """  auto split_chunk = [&](int c, bool with_v) {
    const float* kr = kbuf(c);
    for (int s = tid; s < KC * D; s += blockDim.x) {
      const int j = s / D, d = s % D;
      unsigned hi, lo;
      split_tf32_rz(kr[j * FP + d], hi, lo);
      kp[j * FP + d] = make_uint2(hi, lo);
      if (with_v) {
        split_tf32_rz(kr[KC * FP + j * FP + d], hi, lo);
        vp[j * VPP + d] = make_uint2(hi, lo);
      }
    }
    __syncthreads();
  };
  // s = quant(Q.K^T * scale) over this warp's KW keys of chunk c
  // (mma.cuh:tf32_scores)"""),
    ("    tf32_scores<NT>(s, qh, ql, kbuf(c) + part * KW * FP, g, t4);",
     """    const uint2* kb = kp + (part * KW + g) * FP + t4;
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint2* kr = kb + n * 8 * FP + kk * 8;
        const uint2 b0 = kr[0], b1 = kr[4];
        mma_3xtf32(s[n], qh[kk], ql[kk], b0.x, b0.y, b1.x, b1.y);
      }
    }"""),
    ("""      if (c + 1 < nc) fetch(base, c + 1, false);  // the buffer of chunk c - 1
      land(c);""",
     """      if (c + 1 < nc) fetch(base, c + 1, false);  // the buffer of chunk c - 1
      land(c);
      split_chunk(c, false);"""),
    ("""      if (c + 1 < nc) fetch(base, c + 1, true);
      land(c);""",
     """      if (c + 1 < nc) fetch(base, c + 1, true);
      land(c);
      split_chunk(c, true);"""),
    ("      tf32_pv<NT>(pv, s, kbuf(c) + KC * FP + part * KW * FP, g, t4);",
     """      const uint2* vb = vp + (part * KW + 2 * t4) * VPP + g;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        unsigned ah[4], al[4];
        split_tf32_rz(s[kk][0], ah[0], al[0]);
        split_tf32_rz(s[kk][2], ah[1], al[1]);
        split_tf32_rz(s[kk][1], ah[2], al[2]);
        split_tf32_rz(s[kk][3], ah[3], al[3]);
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          const uint2* vr = vb + kk * 8 * VPP + dn * 8;
          const uint2 b0 = vr[0], b1 = vr[VPP];
          mma_3xtf32(pv[dn], ah, al, b0.x, b0.y, b1.x, b1.y);
        }
      }"""),
    ("  constexpr size_t smem = tf32_smem(C, TF32_STAGES);",
     "  constexpr size_t smem = tf32_smem(C, TF32_STAGES) +\n"
     "      (C > 1 ? 0 : sizeof(float) * WARPS * 16 * RS) + sizeof(uint2) * KC * (FP + VPP);"),
]


def rounded_split(text):
    """The kernels' split by rounding (mma.cuh:split_tf32, cvt.rna for hi and
    for lo) in place of their split by truncation (split_tf32_rz) at every
    call in ``text``; the definition of split_tf32_rz stays."""
    return (text.replace("void split_tf32_rz(", "void SPLIT_TF32_RZ(")
            .replace("split_tf32_rz(", "split_tf32(")
            .replace("void SPLIT_TF32_RZ(", "void split_tf32_rz("))


def replaced(pairs):
    def patch(text):
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant: {old[:60]!r} is not in the source once")
            text = text.replace(old, new)
        return text
    return patch


LINEAR = {"source (bk64, 256 blocks)": tune.same,
          "split by rounding": rounded_split,
          "bk32": tune.constant("TF32_BK", 32),
          "128 blocks": tune.constant("MIN_BLOCKS", 128),
          "bk32, 128 blocks": lambda t: tune.constant("MIN_BLOCKS", 128)(
              tune.constant("TF32_BK", 32)(t))}


def build_tree(name, csrc, source):
    """Another checkout's ``source`` with its own headers -> its library."""
    d = tune.OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for f in ("common.cuh", "mma.cuh", source):
        shutil.copy(csrc / f, d / f)
    return d, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(d / source),
                                "-o", str(d / "lib.so")])


def resource_usage(lib, kernels):
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "--dump-resource-usage", str(lib)], check=True,
                         capture_output=True, text=True).stdout
    usage, name = [], None
    for line in out.splitlines():
        if "Function" in line:
            name = line.split("Function")[1].strip(" :")
        elif name and "REG:" in line and any(k in name for k in kernels):
            usage.append(" ".join(f for f in line.split()
                                  if f.split(":")[0] in ("REG", "STACK", "SHARED")))
    return "; ".join(usage)


def sass_mix(lib, kernels):
    """The most frequent opcodes of the first matching kernel's SASS."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            if counts:
                break
            name = line.split("Function :")[1].strip()
            name = name if any(k in name for k in kernels) else None
        elif name and "/*" in line and ";" in line:
            words = line.split("*/", 1)[1].split()
            op = words[1] if words[0].startswith("@") else words[0]  # past a predicate
            counts[op.split(".")[0]] = counts.get(op.split(".")[0], 0) + 1
    return " ".join(f"{op} {n}" for op, n in sorted(counts.items(), key=lambda x: -x[1])[:10])


def timed(libs, cases):
    """Each case checked and timed under each library, in order and back."""
    for name in (*libs, *list(libs)[::-1]):
        _build._lib = libs[name]
        times = []
        for label, call, want, weight in cases:
            cs.compare(f"{name} {label}", call(), want, **cs.TOL["fp32"])
            times.append(weight * cs.cuda_ms(call))
        print(f"{name}: " + ", ".join(f"{c[0]} {t:.4f}" for c, t in zip(cases, times))
              + f"; sum {sum(times):.4f} ms", flush=True)


def main():
    builds = {"split at load (the source)": tune.build("fp32flash_at_load", "flash_attn.cu",
                                                        tune.same, tune.same),
              "split once per chunk": tune.build("fp32flash_once", "flash_attn.cu", tune.same,
                                                 replaced(SPLIT_ONCE)),
              # flash_attn.cu's splits are mma.cuh's tf32_* helpers
              "split by rounding": tune.build("fp32flash_rna", "flash_attn.cu", rounded_split,
                                              tune.same)}
    lin_builds = {name: tune.build("fp32lin_" + str(i), "linear.cu", tune.same, patch)
                  for i, (name, patch) in enumerate(LINEAR.items())}
    if len(sys.argv) > 1:  # the parent's kernels, timed beside
        csrc = Path(sys.argv[1]).resolve() / "src" / "lightglue_tpu_torch" / "csrc"
        builds["parent"] = build_tree("fp32flash_parent", csrc, "flash_attn.cu")
        lin_builds["parent"] = build_tree("fp32lin_parent", csrc, "linear.cu")
    # the fp32 kernel of the source or of the parent (its FMA kernel)
    for group, kernels in ((builds, ("flash_tf32_kernel", "flash_kernel")),
                           (lin_builds, ("linear_tf32_kernel", "linear_kernel"))):
        for name, (d, proc) in group.items():
            if proc.wait():
                raise RuntimeError(f"nvcc failed for {name}")
            print(f"{name}: {resource_usage(d / 'lib.so', kernels)}; "
                  f"{sass_mix(d / 'lib.so', kernels)}", flush=True)
    flash_libs = {name: tune.load(d, ["lg_fused_mha", "lg_flash_attention",
                                      "lg_flash_attention_step"])
                  for name, (d, _) in builds.items()}
    lin_libs = {name: tune.load(d, ["lg_linear"]) for name, (d, _) in lin_builds.items()}

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    e, hd = 256, 64
    qkv = rand(2, 2048, 3 * e)
    ang = rand(2, 2048, hd // 2) * 2
    freqs = torch.cat([torch.stack([torch.cos(ang), torch.sin(ang)], 1)] * 2, -1).contiguous()
    q1, kv1 = rand(1, 2048, e), rand(1, 2048, 2 * e)
    fq, fk, fv = (rand(2, 4, 2048, hd) for _ in range(3))
    sq, sk, sv = (rand(1, 4, 512, hd) for _ in range(3))
    carries = (rand(1, 4, 512, 1), 1.0 + rand(1, 4, 512, 1).abs(), rand(1, 4, 512, hd))
    ln = torch.tensor([[2048, 2048]], dtype=torch.int32, device=dev)
    calls = {  # label -> (call, launches per pair / per call / per forward_ring)
        "fused self x9": (lambda: at.fused_mha(qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:],
                                               freqs, num_heads=4), 9),
        "fused cross x18": (lambda: at.fused_mha(q1, kv1[..., :e], kv1[..., e:], num_heads=4), 18),
        "flash x1": (lambda: at.flash_attention(fq, fk, fv), 1),
        "step x576": (lambda: at.flash_attention_step(sq, sk, sv, *carries, ln, 512, 1024)[2],
                      576),
    }
    m = 1024
    lin_calls = {}
    for label, k1, k2, n, res, per_layer in (("qkv", e, 0, 3 * e, False, 2), ("out", e, 0, e, False, 4),
                                             ("ffn1", e, e, 2 * e, False, 4),
                                             ("ffn2", 2 * e, 0, e, True, 4),
                                             ("qk_v", e, 0, 2 * e, False, 2)):
        a, a2 = rand(1, m, k1), (rand(1, m, k2) if k2 else None)
        w = rand(k1 + k2, n) / math.sqrt(k1 + k2)
        b, r = rand(n) / 16, (rand(1, m, n) if res else None)
        lin_calls[f"{label} x{9 * per_layer}"] = (
            lambda a=a, w=w, b=b, a2=a2, r=r: ls.linear(a, w, b, a2=a2, residual=r),
            lambda a=a, w=w, b=b, a2=a2, r=r: ls.linear_plain(a, w, b, a2, r), 9 * per_layer)
    with precision_scope(policy_for(Precision.FP32)):
        plain = {"fused self x9": at.fused_mha_plain(qkv[..., :e], qkv[..., e:2 * e],
                                                     qkv[..., 2 * e:], freqs, num_heads=4),
                 "fused cross x18": at.fused_mha_plain(q1, kv1[..., :e], kv1[..., e:],
                                                       num_heads=4),
                 "flash x1": at.flash_attention_plain(fq, fk, fv),
                 "step x576": at.flash_attention_step_plain(sq, sk, sv, *carries, ln, 512,
                                                            1024)[2]}
        timed(flash_libs, [(label, call, plain[label], w) for label, (call, w) in calls.items()])
        timed(lin_libs, [(label, call, want(), w) for label, (call, want, w) in lin_calls.items()])


if __name__ == "__main__":
    main()
