"""Time the W8A8 projection's kernels on one card: csrc/linear.cu's
row_quant_kernel and linear_s8_kernel, their variants, and a parent
checkout's.

W8A8 (``LGTPU_W8A8=1`` on the INT8 rung) runs each projection of the layer
stack as two launches: ``row_quant`` quantizes the activation rows, then the
s8 GEMM multiplies them by the K-major int8 weight. The variants, each a copy
of ``linear.cu`` built into its own library under ``build/tune/``
(``tune_torch_stack_kernels.build``), its registers and most frequent SASS
opcodes printed:

- the source: ``s8_plan`` aiming for 128 blocks, A in one cp.async group
  (``S8_KC`` 512), 8-warp GEMM blocks (the warps left over by the tile
  splitting K), two-warp ``row_quant`` blocks, both kernels launched as
  programmatic dependents of the stream's previous kernel (``S8_PDL``);
- ``S8_PDL`` 0: plain launches;
- ``EARLY_TRIGGER``: row_quant lets the GEMM start at once, so the GEMM
  stages its weights while row_quant runs;
- the staging loop indexed by a division by each row's segment count
  (``DIVIDED``), where the source shifts;
- ``S8_MIN_BLOCKS`` 256 (smaller tiles) and 64 (64 x 64 everywhere);
- ``S8_WARPS`` 4 and 16 (GEMM blocks of 4 / 16 warps);
- ``S8_KC`` 128 (A in four groups, each multiplied as it lands);
- ``QUANT_WARPS`` 4 and 8 (``row_quant`` blocks of 4 / 8 warps);
- row quantization folded into the GEMM's prologue (``FOLD``): one launch,
  each block quantizing its rows of bf16 [A | A2] into shared memory (amax
  over the whole row first), the quantization repeated once per column
  tile; it takes optional q and sa outputs, written by column tile 0.

PARENT, the root of an earlier checkout (the W8A8 kernels before the
redesign: ``lg_linear_s8`` there takes the weight (K, N), row-major): its
``linear.cu`` is built with its own headers and timed first and last. Every
case runs at the main path's five projections at 1024 rows (the launches of
one ``match_pair``: x18 for qkv and qk_v, x36 for out, ffn1 and ffn2), the
output of each library held exactly against the plain versions (q, sa and
y), then timed with ``chip_smoke.cuda_ms``: row_quant, the GEMM, the two as
one projection, and the fold; libraries in one order and then the reverse.
From the root of a checkout, on a machine with nvcc:

    python3 scripts/tune_torch_w8a8.py [PARENT]
"""

import ctypes
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]

import chip_smoke as cs  # noqa: E402
import tune_torch_fp32_flash as flash_tune  # noqa: E402
import tune_torch_stack_kernels as tune  # noqa: E402
from lightglue_tpu_torch.kernels import _build  # noqa: E402
from lightglue_tpu_torch.kernels import layer_stack as ls  # noqa: E402

# row quantization folded into the s8 GEMM: a kernel and C entry appended to
# linear.cu, built from its s8_stage, s8_product and s8_epilogue
FOLD = r'''
namespace {

using namespace lg;

template <int WM, int WN>
__global__ void __launch_bounds__(S8_WARPS * 32)
linear_s8_fold_kernel(const bf16_t* __restrict__ a, const bf16_t* __restrict__ a2, int k1,
                      const int8_t* __restrict__ wt, const float* __restrict__ wscale,
                      const float* __restrict__ bias, const bf16_t* __restrict__ res,
                      bf16_t* __restrict__ y, int M, int N, int K,
                      const float* __restrict__ exit_reg, int layer, int rows_per_pair,
                      int8_t* __restrict__ q_out, float* __restrict__ sa_out) {
  constexpr int TM = 32 * WM, TN = 32 * WN, THREADS = S8_WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const S8Smem<TM, TN> sm(smem_raw, K);
  float* const sa_s = sm.bias + TN;  // the block's row scales
  const int P = s8_pitch(K);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  if (retired(exit_reg, layer, rows_per_pair, m0, n0, TM, TN, M, N, res, y, tid, THREADS))
    return;
  s8_stage_weights<TM, TN, THREADS>(sm, wt, wscale, bias, res, m0, n0, M, N, K, tid);
  const int k2 = K - k1, c0 = 16 * lane;  // a lane: 16 values of the row (K <= 512)
  for (int r = warp; r < TM; r += S8_WARPS) {
    const int gm = m0 + r;
    float v[2][8] = {}, amax = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 8 * h;
      if (gm < M && c < K)
        load8(c < k1 ? a + (size_t)gm * k1 + c : a2 + (size_t)gm * k2 + c - k1, v[h], true);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[h][e]));
    }
    const float s = __fmul_rn(fmaxf(warp_max(amax), 1e-6f), static_cast<float>(1.0 / 127.0));
    if (c0 < s8_k32(K)) {
      unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int qi =
            static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v[e / 8][e % 8], s)), -127.f), 127.f));
        w[e / 4] |= (static_cast<unsigned>(qi) & 0xffu) << (8 * (e % 4));
      }
      const uint4 word = make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(sm.a + r * P + c0) = word;
      if (q_out && blockIdx.x == 0 && gm < M && c0 < K)
        *reinterpret_cast<uint4*>(q_out + (size_t)gm * K + c0) = word;
    }
    if (lane == 0) {
      sa_s[r] = s;
      if (sa_out && blockIdx.x == 0 && gm < M) sa_out[gm] = s;
    }
  }
  cp_async_commit();  // an empty group: s8_product counts A's groups (one)
  s8_product<WM, WN>(sm.a, sm.w, sm.sums, K);  // its first barrier also orders the rows
  __syncthreads();
  s8_epilogue<TM, TN, THREADS>(sm, sa_s, res != nullptr, y, m0, n0, M, N);
}

template <int WM, int WN>
int launch_fold(const void* a, const void* a2, int k1, const void* wt, const void* wscale,
                const void* bias, const void* res, void* y, int M, int N, int K,
                const void* exit_reg, int layer, int rows_per_pair, void* q_out, void* sa_out,
                cudaStream_t stream) {
  constexpr int TM = 32 * WM, TN = 32 * WN;
  auto kernel = linear_s8_fold_kernel<WM, WN>;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(s8_smem(TM, TN, S8_MAX_K) + TM * sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  dim3 grid(N / TN, (M + TM - 1) / TM);
  kernel<<<grid, S8_WARPS * 32, s8_smem(TM, TN, K) + TM * sizeof(float), stream>>>(
      static_cast<const bf16_t*>(a), static_cast<const bf16_t*>(a2), k1,
      static_cast<const int8_t*>(wt), static_cast<const float*>(wscale),
      static_cast<const float*>(bias), static_cast<const bf16_t*>(res), static_cast<bf16_t*>(y),
      M, N, K, static_cast<const float*>(exit_reg), layer, rows_per_pair,
      static_cast<int8_t*>(q_out), static_cast<float*>(sa_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lg_linear_s8_fold(const void* a, const void* a2, int k1, const void* wt,
                                 const void* wscale, const void* bias, const void* res, void* y,
                                 int M, int N, int K, const void* exit_reg, int layer,
                                 int rows_per_pair, void* q_out, void* sa_out, void* stream) {
  if (K % 16 || K > S8_MAX_K || N % 64 || k1 % 8 || !on16(a) || !on16(a2) || !on16(wt) ||
      !on16(wscale) || !on16(bias) || !on16(res) || !on16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  int wm, wn;
  s8_plan(M, N, &wm, &wn);
  auto run = wm == 2 ? launch_fold<2, 2> : wn == 2 ? launch_fold<1, 2> : launch_fold<1, 1>;
  return run(a, a2, k1, wt, wscale, bias, res, y, M, N, K, exit_reg, layer, rows_per_pair,
             q_out, sa_out, static_cast<cudaStream_t>(stream));
}
'''
# row_quant letting the s8 GEMM after it start at once (an early trigger):
# the GEMM's blocks stage its weights, scale, bias and residual while
# row_quant runs, then wait for it
EARLY_TRIGGER = [
    ("bool on16(const void* p) {",
     "__device__ __forceinline__ void launch_dependents() {\n"
     "  asm volatile(\"griddepcontrol.launch_dependents;\\n\" ::: \"memory\");\n}\n"
     "bool on16(const void* p) {"),
    ("  wait_prerequisites();  // a and a2\n",
     "  wait_prerequisites();  // a and a2\n  launch_dependents();\n")]
# the staging loop indexed by a division by the row's segment count (the
# source shifts by a power of two and skips the segments past the row)
DIVIDED = [("  for (int i = tid; i < rows * SEGS; i += THREADS) {\n"
            "    const int r = i / SEGS, s = s0 + i % SEGS;\n"
            "    if (s >= s1) continue;\n",
            "  const int segs = s1 - s0;\n"
            "  for (int i = tid; i < rows * segs; i += THREADS) {\n"
            "    const int r = i / segs, s = s0 + i % segs;\n")]
_P, _I = ctypes.c_void_p, ctypes.c_int
FOLD_ARGS = [_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _P, _P, _P]

VARIANTS = {"source": tune.same,
            "fold": lambda text: text + FOLD,
            "min blocks 256": tune.constant("S8_MIN_BLOCKS", 256),
            "min blocks 64": tune.constant("S8_MIN_BLOCKS", 64),
            "no PDL": tune.constant("S8_PDL", 0),
            "early trigger": flash_tune.replaced(EARLY_TRIGGER),
            "staging by division": flash_tune.replaced(DIVIDED),
            "kc 128": tune.constant("S8_KC", 128),
            "4 warps a block": tune.constant("S8_WARPS", 4),
            "16 warps a block": tune.constant("S8_WARPS", 16),
            "row_quant 4 warps": tune.constant("QUANT_WARPS", 4),
            "row_quant 8 warps": tune.constant("QUANT_WARPS", 8)}
KERNELS = ("linear_s8_kernel", "linear_s8_fold_kernel", "row_quant_kernel")


def main():
    builds = {name: tune.build(f"w8a8_{i}", "linear.cu", tune.same, patch)
              for i, (name, patch) in enumerate(VARIANTS.items())}
    if len(sys.argv) > 1:
        csrc = Path(sys.argv[1]).resolve() / "src" / "lightglue_tpu_torch" / "csrc"
        builds = {"parent": flash_tune.build_tree("w8a8_parent", csrc, "linear.cu"), **builds}
    libs = {}
    for name, (d, proc) in builds.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed for {name}")
        for kernel in KERNELS:
            usage = flash_tune.resource_usage(d / "lib.so", (kernel,))
            if usage:
                print(f"{name} {kernel}: {usage}; {flash_tune.sass_mix(d / 'lib.so', (kernel,))}",
                      flush=True)
        libs[name] = tune.load(d, ["lg_row_quant", "lg_linear_s8"])
        if name == "fold":
            libs[name].lg_linear_s8_fold.argtypes = FOLD_ARGS
            libs[name].lg_linear_s8_fold.restype = ctypes.c_int

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    m = cs.BUCKET
    cases = []
    for label, k1, k2, n, res, per_layer in cs.LIN_CASES:
        k = k1 + k2
        w32 = (torch.rand(k, n, generator=gen, device=dev) * 2 - 1) / math.sqrt(k)
        wq, sc = cs.quantized_weight(w32, dev)
        x = (torch.randn(m, k, generator=gen, device=dev)
             * torch.rand(m, 1, generator=gen, device=dev) * 4).to(bf16)
        cases.append(dict(
            label=label, k1=k1, k=k, n=n, weight=per_layer * cs.N_LAYERS, wq=wq,
            wt=wq.t().contiguous(), sc=sc,
            b=(torch.rand(n, generator=gen, device=dev) * 2 - 1) / math.sqrt(k),
            a=x[:, :k1].contiguous(), a2=x[:, k1:].contiguous() if k2 else None,
            r=torch.randn(m, n, generator=gen, device=dev).to(bf16) if res else None))
    for c in cases:
        c["q"], c["sa"] = ls.row_quant_plain(c["a"], c["a2"])
        c["want"] = ls.linear_plain(c["a"], c["wq"], c["b"], c["a2"], c["r"], scale=c["sc"],
                                    w8a8=True)
    def stream():  # the current stream at each call: cuda_ms captures on its own
        return torch.cuda.current_stream().cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    def row_quant(lib, c, q, sa):
        _build.check(lib.lg_row_quant(c["a"].data_ptr(), ptr(c["a2"]), c["k1"], c["k"], m,
                                      q.data_ptr(), sa.data_ptr(), stream()), "row_quant")

    def gemm(lib, c, q, sa, y, parent):
        w = c["wq"] if parent else c["wt"]  # the parent's GEMM takes (K, N)
        _build.check(lib.lg_linear_s8(q.data_ptr(), sa.data_ptr(), w.data_ptr(),
                                      c["sc"].data_ptr(), c["b"].data_ptr(), ptr(c["r"]),
                                      y.data_ptr(), m, c["n"], c["k"], None, 0, 1, stream()),
                     "linear_s8")

    def fold(lib, c, y, q=None, sa=None):
        _build.check(lib.lg_linear_s8_fold(c["a"].data_ptr(), ptr(c["a2"]), c["k1"],
                                           c["wt"].data_ptr(), c["sc"].data_ptr(),
                                           c["b"].data_ptr(), ptr(c["r"]), y.data_ptr(), m,
                                           c["n"], c["k"], None, 0, 1, ptr(q), ptr(sa), stream()),
                     "linear_s8_fold")

    for name in (*libs, *list(libs)[::-1]):
        lib, parent = libs[name], name == "parent"
        sums = {"row_quant": 0.0, "s8 GEMM": 0.0, "projection": 0.0}
        parts = []
        for c in cases:
            q = torch.empty(m, c["k"], dtype=torch.int8, device=dev)
            sa = torch.empty(m, dtype=torch.float32, device=dev)
            y = torch.empty(m, c["n"], dtype=bf16, device=dev)
            if name == "fold":
                q.zero_(), sa.zero_()
                fold(lib, c, y, q, sa)
            else:
                row_quant(lib, c, q, sa)
                gemm(lib, c, q, sa, y, parent)
            cs.compare(f"{name} {c['label']} q", q, c["q"], 0, 0, exact=True)
            cs.compare(f"{name} {c['label']} sa", sa, c["sa"], 0, 0, exact=True)
            cs.compare(f"{name} {c['label']} y", y, c["want"], 0, 0, exact=True)
            if name == "fold":
                times = {"projection": cs.cuda_ms(lambda c=c, y=y: fold(lib, c, y))}
            else:
                times = {"row_quant": cs.cuda_ms(lambda c=c, q=q, sa=sa: row_quant(lib, c, q, sa)),
                         "s8 GEMM": cs.cuda_ms(
                             lambda c=c, q=q, sa=sa, y=y: gemm(lib, c, q, sa, y, parent)),
                         "projection": cs.cuda_ms(
                             lambda c=c, q=q, sa=sa, y=y: (row_quant(lib, c, q, sa),
                                                           gemm(lib, c, q, sa, y, parent)))}
            for key, ms in times.items():
                sums[key] += c["weight"] * ms
            parts.append(f"{c['label']} " + "/".join(f"{1e3 * ms:.2f}" for ms in times.values()))
        print(f"{name}: per match_pair " + ", ".join(f"{k} {v:.4f} ms" for k, v in sums.items()
                                                      if v) +
              " | us per launch (row_quant/GEMM/both, or the fold): " + ", ".join(parts),
              flush=True)


if __name__ == "__main__":
    main()
