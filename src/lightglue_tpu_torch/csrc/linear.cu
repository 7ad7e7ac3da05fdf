// Y = [A | A2] . W + b (+ R): the projections of the LightGlue layer stack.
//
// Replaces the matrix products inside the TPU kernel
// lightglue_tpu/kernels/layer_stack.py:transformer_stack (wrapper :801,
// pallas_call :894): _linear (:357-375) for the fused qkv, the out
// projections, ffn1 over cat(x, message) (:386-388, taken here as two A
// operands so the concat is never materialised) and ffn2 with its residual
// add (:399). Rounding follows the reference exactly: the fp32 accumulator
// is cast to T, the bias is added in T, and the residual is added in T.
//
// Bound on the H100: at M = 1024 rows, K <= 512 and N <= 768 a product is
// ~0.5-0.8 GFLOP on ~2 MB, so the tensor cores bound it (under 1 us at the
// bf16 peak). This first version is a classic 64x64 shared-memory tile with
// 4x4 fp32 FMA accumulators per thread; wgmma and TMA are later work.
//
// Liveness (transformer_stack_adaptive, wrapper :974, pallas_call :1229):
// with an exit register (B,) fp32 and the global layer g, a tile whose pair
// has exit <= g (rows_per_pair % 64 == 0, so a tile holds one pair) skips
// the product, the pl.when(live) gate of :734-745. With a residual (ffn2)
// it writes y = R, so a retired pair's activations pass through the layer
// bit for bit; without one its rows are left unwritten and never read.

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
linear_kernel(const T* __restrict__ a, const T* __restrict__ a2, int k1,
              const T* __restrict__ w, const T* __restrict__ bias,
              const T* __restrict__ res, T* __restrict__ y, int M, int N,
              int K, const float* __restrict__ exit_reg, int layer,
              int rows_per_pair) {
  __shared__ __align__(16) float as[BK][BM];  // A tile, transposed
  __shared__ __align__(16) float bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k2 = K - k1;  // width of the second A operand (0 without one)
  if (exit_reg && !(exit_reg[m0 / rows_per_pair] > static_cast<float>(layer))) {
    if (res) {
      for (int i = tid; i < BM * BN; i += THREADS) {
        const int gm = m0 + i / BN, gn = n0 + i % BN;
        if (gm < M) y[(size_t)gm * N + gn] = res[(size_t)gm * N + gn];
      }
    }
    return;
  }

  float acc[4][4] = {};
  for (int kk = 0; kk < K; kk += BK) {
    // A tile: 64 rows x 16 cols, 4 elements per thread
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = tid + q * THREADS;
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = kk + c;
      float v = 0.f;
      if (gm < M)
        v = gk < k1 ? lg::to_f(a[(size_t)gm * k1 + gk])
                    : lg::to_f(a2[(size_t)gm * k2 + gk - k1]);
      as[c][r] = v;
    }
    // W tile: 16 rows x 64 cols (N % 64 == 0, K % 16 == 0)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = tid + q * THREADS;
      const int r = i / BN, c = i % BN;
      bs[r][c] = lg::to_f(w[(size_t)(kk + r) * N + n0 + c]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      float v = lg::round_to<T>(acc[i][j]);
      v = lg::round_to<T>(v + lg::to_f(bias[gn]));
      if (res) v = lg::round_to<T>(v + lg::to_f(res[(size_t)gm * N + gn]));
      y[(size_t)gm * N + gn] = lg::from_f<T>(v);
    }
  }
}

template <typename T>
int launch(const void* a, const void* a2, int k1, const void* w,
           const void* bias, const void* res, void* y, int M, int N, int K,
           const void* exit_reg, int layer, int rows_per_pair,
           cudaStream_t stream) {
  dim3 grid(N / BN, (M + BM - 1) / BM);
  linear_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(a2), k1,
      static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<const T*>(res), static_cast<T*>(y), M, N, K,
      static_cast<const float*>(exit_reg), layer, rows_per_pair);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (M, k1) T; a2: (M, K - k1) T or null with k1 == K; w: (K, N) T;
// bias: (N,) T; res: (M, N) T or null; y: (M, N) T. N % 64 == 0, K % 16 == 0.
// exit_reg: (B,) fp32 or null; layer: the global layer index; the rows of
// pair b are [b * rows_per_pair, (b + 1) * rows_per_pair).
extern "C" int lg_linear(const void* a, const void* a2, int k1, const void* w,
                         const void* bias, const void* res, void* y, int M,
                         int N, int K, const void* exit_reg, int layer,
                         int rows_per_pair, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(a, a2, k1, w, bias, res, y, M, N, K, exit_reg,
                                 layer, rows_per_pair, s);
  return launch<float>(a, a2, k1, w, bias, res, y, M, N, K, exit_reg, layer,
                       rows_per_pair, s);
}
