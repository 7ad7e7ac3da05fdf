// LayerNorm (fp32 statistics, eps 1e-5) + exact-erf GELU over rows, cast to
// the activation type: the middle of the LightGlue FFN.
//
// Replaces the normalisation inside the TPU kernel
// lightglue_tpu/kernels/layer_stack.py:transformer_stack (wrapper :801,
// pallas_call :894; _ffn :386-398): mean and var = E[x^2] - mean^2 in fp32,
// (x - mean) * rsqrt(var + eps) * gamma + beta, GELU with erf. The TPU kernel
// approximates erf by a polynomial (Mosaic has none); this kernel calls erff.
//
// Bound on the H100: it reads and writes each element once and does ~20
// operations on it, so HBM bounds it (~0.6 us for 1024 x 512 bf16 rows in
// and out). Design: one warp per row, 16 elements per lane kept in registers
// between the statistics and the output pass.
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

constexpr int THREADS = 256;
constexpr int MAX_PER_LANE = 16;  // rows up to 512 wide

template <typename T, typename TG>
__global__ void __launch_bounds__(THREADS)
ln_gelu_kernel(const T* __restrict__ x, const TG* __restrict__ gamma,
               const TG* __restrict__ beta, T* __restrict__ y, int M, int C,
               const float* __restrict__ exit_reg, int layer,
               int rows_per_pair) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (THREADS / 32) + warp;
  if (row >= M) return;
  if (exit_reg && !(exit_reg[row / rows_per_pair] > static_cast<float>(layer)))
    return;
  const T* xr = x + (size_t)row * C;
  float v[MAX_PER_LANE];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int q = 0; q < MAX_PER_LANE; ++q) {
    const int c = lane + 32 * q;
    v[q] = c < C ? lg::to_f(xr[c]) : 0.f;
    s += v[q];
    ss += v[q] * v[q];
  }
  const float mean = lg::warp_sum(s) / C;
  const float var = lg::warp_sum(ss) / C - mean * mean;
  const float inv = rsqrtf(var + 1e-5f);
  T* yr = y + (size_t)row * C;
#pragma unroll
  for (int q = 0; q < MAX_PER_LANE; ++q) {
    const int c = lane + 32 * q;
    if (c >= C) continue;
    const float n = (v[q] - mean) * inv * lg::to_f(gamma[c]) + lg::to_f(beta[c]);
    yr[c] = lg::from_f<T>(0.5f * n * (1.f + erff(n * 0.70710678118654752f)));
  }
}

template <typename T, typename TG>
int launch(const void* x, const void* gamma, const void* beta, void* y, int M,
           int C, const void* exit_reg, int layer, int rows_per_pair,
           cudaStream_t stream) {
  const int rows_per_block = THREADS / 32;
  ln_gelu_kernel<T, TG><<<(M + rows_per_block - 1) / rows_per_block, THREADS, 0,
                          stream>>>(
      static_cast<const T*>(x), static_cast<const TG*>(gamma),
      static_cast<const TG*>(beta), static_cast<T*>(y), M, C,
      static_cast<const float*>(exit_reg), layer, rows_per_pair);
  return static_cast<int>(cudaGetLastError());
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
