// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel is templated on its storage type T (float for the FP32 rung,
// __nv_bfloat16 for the BF16 main path), computes in fp32 and rounds to T
// exactly where the JAX reference rounds, so that a kernel and its plain
// PyTorch version agree up to the order of fp32 sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lg {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch and XLA do
}

// Round an fp32 value through T and back: the re-quantization points of
// the reference (a no-op for float).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// The attention statistics' rounding (s, m, p, l, ...): through bf16 when
// quant is set (stat_dtype bf16), whatever the operands' storage type.
__device__ __forceinline__ float quant_stat(float x, int quant) {
  return quant ? round_to<__nv_bfloat16>(x) : x;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Half-split RoPE of the pair (x[d], x[d + D/2]) of one row at sequence
// position pos: x * cos + rotate_half(x) * sin with the freqs cast to T and
// each product and the sum rounded to T (layer_stack.py:377-384,
// attention.py:575-582). freqs: [cos; sin], n rows of D each. __fmul_rn /
// __fadd_rn keep nvcc from contracting a product and the sum into one FMA,
// which at T = float would round once where the reference rounds twice.
template <typename T, int D>
__device__ __forceinline__ void rope_pair(float& x1, float& x2, int d, int pos,
                                          const float* freqs, int n) {
  const float* cosv = freqs + (size_t)pos * D;
  const float* sinv = cosv + (size_t)n * D;
  const float c1 = round_to<T>(cosv[d]);
  const float s1 = round_to<T>(sinv[d]);
  const float c2 = round_to<T>(cosv[d + D / 2]);
  const float s2 = round_to<T>(sinv[d + D / 2]);
  const float y1 =
      round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(x1, c1)), round_to<T>(__fmul_rn(-x2, s1))));
  x2 = round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(x2, c2)), round_to<T>(__fmul_rn(x1, s2))));
  x1 = y1;
}

// Programmatic dependent launch (Hopper): a kernel launched with the
// attribute is set up while the stream's previous kernel runs and may start
// as that kernel's blocks exit; this waits until the previous kernel has
// finished and its writes are visible (at once without the attribute).
// Such a kernel reads what the previous kernel may have written, and writes
// anything, only after the wait.
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// a launch, as a programmatic dependent of the stream's previous kernel
// where `dependent` is set (the kernel waits for it with wait_prerequisites)
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                             cudaStream_t stream, bool dependent, Args... args) {
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = dependent;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace lg
