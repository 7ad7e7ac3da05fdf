// LayerNorm (fp32 statistics, eps 1e-5) + exact-erf GELU over rows, cast to
// the activation type: the middle of the LightGlue FFN.
//
// Replaces the normalisation inside the TPU kernel
// lightglue_tpu/kernels/layer_stack.py:transformer_stack (wrapper :801,
// pallas_call :894; _ffn :386-398): mean and var = E[x^2] - mean^2 in fp32
// (not Welford; the product mean * mean and the difference each rounded, as
// the reference rounds them), (x - mean) * rsqrt(var + eps) * gamma + beta,
// GELU with erf. The TPU kernel approximates erf by a polynomial (Mosaic has
// none); this kernel calls erff.
//
// Bound on the H100: it reads and writes each element once and does ~20
// operations on it, so HBM bounds it: 0.63 us for 1024 x 512 bf16 rows in and
// out (1.25 us in fp32). At that size the launch and one dependent round
// trip to memory set the pace, not the bytes.
//
// The first design took one warp per row, a lane reading 16 scalars
// 32 apart (16 load instructions of 64 B a warp in bf16), and loaded gamma
// and beta after the two warp reductions: a second dependent round trip.
// 5.8 us a launch in bf16 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
// This design, 3.3 us a launch there (scripts/tune_torch_ln_gelu_conv.py):
// - ROW_LANES lanes of a warp per row (ln_gelu_plan: lane l takes the
//   16-byte vectors l, l + ROW_LANES, ... of the row: a warp's load of its
//   row is 512 contiguous bytes); a row of 512 is 64 vectors in bf16, 128 in
//   fp32. A row whose width is not a multiple of the vector (its rows then
//   do not start on 16 B) is read and written element by element, masked at
//   C, on the same lane map. 16 lanes a row (two rows a warp) ran slower;
// - gamma, beta and the row loaded together, into registers, before the
//   reductions: one round trip to memory (two under liveness, where the
//   exit register decides first whether the row loads at all: a retired
//   pair's rows load nothing, not even gamma and beta, which took a launch
//   on retired rows from 2.5 to 3.3 us; the first design's took 1.9).
//   Loaded before the wait for the previous kernel, gamma and beta ran no
//   faster, and would have had to be written before that kernel ran;
// - a programmatic dependent launch (LN_PDL, common.cuh:launch_dependent):
//   set up while the previous kernel runs, it waits for it before its first
//   load. 10 % faster after another ln_gelu; between ffn1 and ffn2, as the
//   stack runs it, the same as a plain launch;
// - LN_THREADS threads a block, so 1024 rows spread over every SM (64- and
//   256-thread blocks ran the same).
//
// gamma and beta are read in their own type TG, as g.astype(f32): the
// activation type (FP32, BF16) or fp32 beside bf16 rows (INT8, whose
// quantized tree keeps LayerNorm in fp32, session.py:75-78).
//
// Liveness (transformer_stack_adaptive, :734-745): with an exit register
// (B,) fp32 and the global layer g, a row whose pair has exit <= g is left
// unwritten; the stack never reads it.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int MAX_C = 512;       // the widest row
constexpr int ROW_LANES = 32;    // lanes of a row: a power of two, at most a warp
constexpr int LN_THREADS = 128;  // threads of a block
constexpr int LN_PDL = 1;        // launched as a programmatic dependent of the previous kernel

// N consecutive elements of T at p as fp32: 16 B loads when vec (p on 16 B),
// else element loads of the first n, zeros past them
template <typename T, int N>
__device__ __forceinline__ void load_cols(const T* p, float (&v)[N], bool vec, int n) {
  constexpr int E = 16 / sizeof(T);  // elements of a 16 B load
  if (vec) {
#pragma unroll
    for (int u = 0; u < N / E; ++u) {
      alignas(16) T e[E];
      *reinterpret_cast<uint4*>(e) = reinterpret_cast<const uint4*>(p)[u];
#pragma unroll
      for (int i = 0; i < E; ++i) v[u * E + i] = lg::to_f(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = i < n ? lg::to_f(p[i]) : 0.f;
  }
}

// the same back, each value cast to T once: 16 B stores when vec, else the
// first n elements
template <typename T, int N>
__device__ __forceinline__ void store_cols(T* p, const float (&v)[N], bool vec, int n) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
#pragma unroll
    for (int u = 0; u < N / E; ++u) {
      alignas(16) T e[E];
#pragma unroll
      for (int i = 0; i < E; ++i) e[i] = lg::from_f<T>(v[u * E + i]);
      reinterpret_cast<uint4*>(p)[u] = *reinterpret_cast<const uint4*>(e);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < n) p[i] = lg::from_f<T>(v[i]);
  }
}

// vec: every row, gamma and beta start on 16 B (C a multiple of the vector)
template <typename T, typename TG>
__global__ void __launch_bounds__(LN_THREADS)
ln_gelu_kernel(const T* __restrict__ x, const TG* __restrict__ gamma,
               const TG* __restrict__ beta, T* __restrict__ y, int M, int C,
               const float* __restrict__ exit_reg, int layer, int rows_per_pair,
               int vec) {
  constexpr int V = 16 / sizeof(T);                // columns of a 16 B vector of the row
  constexpr int NV = MAX_C / (V * ROW_LANES);      // vectors of a lane
  const int lane = threadIdx.x % ROW_LANES;
  const int row = (blockIdx.x * LN_THREADS + threadIdx.x) / ROW_LANES;

  lg::wait_prerequisites();  // the rows, and anything else the previous kernel wrote
  const bool live = row < M && !(exit_reg && !(exit_reg[row / rows_per_pair] >
                                               static_cast<float>(layer)));
  const int width = live ? C : 0;  // lanes past the last row or retired load nothing
  float g[NV][V], b[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (lane + ROW_LANES * j) * V;  // the vector's first column
    load_cols(gamma + c, g[j], vec && c < width, width - c);
    load_cols(beta + c, b[j], vec && c < width, width - c);
  }
  const T* xr = x + (size_t)row * C;
  float v[NV][V], s = 0.f, ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (lane + ROW_LANES * j) * V;
    load_cols(xr + c, v[j], vec && c < width, width - c);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      s += v[j][e];
      ss += v[j][e] * v[j][e];
    }
  }
#pragma unroll
  for (int o = ROW_LANES / 2; o > 0; o >>= 1) {  // the row's lanes, every lane taking part
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const float mean = s / C;
  const float var = __fsub_rn(ss / C, __fmul_rn(mean, mean));
  const float inv = rsqrtf(var + 1e-5f);
  if (!live) return;

  T* yr = y + (size_t)row * C;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (lane + ROW_LANES * j) * V;
    if (c >= C) break;
    float o[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float n = (v[j][e] - mean) * inv * g[j][e] + b[j][e];
      o[e] = 0.5f * n * (1.f + erff(n * 0.70710678118654752f));
    }
    store_cols(yr + c, o, vec, C - c);
  }
}

bool on16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, typename TG>
int launch(const void* x, const void* gamma, const void* beta, void* y, int M,
           int C, const void* exit_reg, int layer, int rows_per_pair,
           cudaStream_t stream) {
  const int rows_per_block = LN_THREADS / ROW_LANES;
  const int vec = C % (16 / sizeof(T)) == 0 && on16(x) && on16(y) && on16(gamma) && on16(beta);
  return static_cast<int>(lg::launch_dependent(
      ln_gelu_kernel<T, TG>, dim3((M + rows_per_block - 1) / rows_per_block), LN_THREADS, 0,
      stream, LN_PDL, static_cast<const T*>(x), static_cast<const TG*>(gamma),
      static_cast<const TG*>(beta), static_cast<T*>(y), M, C,
      static_cast<const float*>(exit_reg), layer, rows_per_pair, vec));
}

// operand modes (kernels/layer_stack.py:ln_gelu mirrors them)
enum Mode { FP32 = 0, BF16 = 1, BF16_F32_GAMMA = 2 };

}  // namespace

// x, y: (M, C) with C <= 512; gamma, beta: (C,). mode: FP32 (all fp32),
// BF16 (all bf16) or BF16_F32_GAMMA (bf16 x and y, fp32 gamma and beta).
// exit_reg: (B,) fp32 or null; layer: the global layer index; pair b owns
// rows [b * rows_per_pair, (b + 1) * rows_per_pair).
extern "C" int lg_ln_gelu(const void* x, const void* gamma, const void* beta,
                          void* y, int M, int C, const void* exit_reg,
                          int layer, int rows_per_pair, int mode,
                          void* stream) {
  if (C < 1 || C > MAX_C) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  switch (mode) {
    case FP32:
      return launch<float, float>(x, gamma, beta, y, M, C, exit_reg, layer, rows_per_pair, s);
    case BF16:
      return launch<bf16, bf16>(x, gamma, beta, y, M, C, exit_reg, layer, rows_per_pair, s);
    case BF16_F32_GAMMA:
      return launch<bf16, float>(x, gamma, beta, y, M, C, exit_reg, layer, rows_per_pair, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The lane map of a mode's rows (kernels/layer_stack.py:ln_gelu_plan mirrors
// it): out = {lanes of a row, 16 B vectors of a lane, columns of a vector,
// threads of a block}.
extern "C" int lg_ln_gelu_plan(int mode, int* out) {
  const int v = mode == FP32 ? 4 : 8;
  out[0] = ROW_LANES;
  out[1] = MAX_C / (v * ROW_LANES);
  out[2] = v;
  out[3] = LN_THREADS;
  return 0;
}
