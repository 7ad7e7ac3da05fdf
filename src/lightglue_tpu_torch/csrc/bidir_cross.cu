// Both directions of LightGlue's symmetric cross-attention in one launch:
// image 0's rows attend to image 1 (the row softmax of S) and image 1's rows
// attend to image 0 (the column softmax of the same S).
//
// Replaces lightglue_tpu/kernels/attention.py:bidirectional_cross_attention
// (wrapper :925, pallas_call :985, body :811-919). The TPU kernel holds one
// S per head in VMEM and softmaxes it along both axes. Here a direction-1
// block computes rows of S^T as qk1_j . qk0_i with the same order of
// products over d as direction 0, so its scores are S's bit for bit.
//
// Contract (attention.py:855-910): s = quant(qk0 . qk1 * scale) once, no
// online rescaling; per direction the kv columns >= the other image's length
// become -1e30, m = quant(rowmax), p = quant(exp(s - m)), l = quant(sum p)
// (direction 1 sums P after its cast to the V type, :885-897), P.V
// accumulates in fp32 with P in the V type and is divided by l in fp32
// (l == 0 divides by 1), padded rows are 0. quant rounds through bf16 on the
// BF16 rung. There is no -5e29 clamp. One deliberate departure: a direction
// whose kv side has length 0 writes 0 rows, as fused_mha and the layer stack
// do; the TPU kernel gives the mean of the padded values in fp32 and NaN in
// bf16 there (ROADMAP queue 3).
//
// Bound on the H100: per head 2 * 2 * N0 * N1 * D FLOP for the two P.V
// products and 2 * N0 * N1 * D for S (the TPU kernel's one S; here S is
// computed twice), against (2 N0 + 2 N1) * D operands: tensor-core bound.
// Design: the grid runs over (row stripe of either direction, head, pair);
// a block keeps its 16 x Nk slab of S in shared memory (64 KB at Nk = 1024,
// which the model's _BIDIR_MAX_N gate guarantees) and takes max, exp, sum
// and P.V in the reference's order. A first version on the fp32 FMA units.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int D = 64;        // head dim
constexpr int BQ = 16;       // query rows per block
constexpr int KC = 64;       // keys per staged chunk
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;

struct Operand {
  const void* ptr;
  long long batch_stride, row_stride;  // in elements
};

template <typename T>
__device__ __forceinline__ const T* row_ptr(const Operand& o, int b, int row,
                                            int h) {
  return static_cast<const T*>(o.ptr) + b * o.batch_stride +
         (long long)row * o.row_stride + h * D;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
bidir_kernel(Operand qk0, Operand qk1, Operand v0, Operand v1,
             const int* __restrict__ lens, T* __restrict__ o0,
             T* __restrict__ o1, int N0, int N1, int H, float scale,
             int quant, int stripes0) {
  extern __shared__ float smem[];
  const int bx = blockIdx.x;
  const bool dir1 = bx >= stripes0;  // image 1's rows attend to image 0
  const int b = blockIdx.z, h = blockIdx.y;
  const int i0 = (dir1 ? bx - stripes0 : bx) * BQ;
  const Operand q = dir1 ? qk1 : qk0;
  const Operand k = dir1 ? qk0 : qk1;
  const Operand v = dir1 ? v0 : v1;
  T* out = dir1 ? o1 : o0;
  const int Nq = dir1 ? N1 : N0, Nk = dir1 ? N0 : N1;
  const int lq = lens ? lens[2 * b + dir1] : Nq;
  const int lk = lens ? lens[2 * b + !dir1] : Nk;

  float* qs = smem;               // [BQ][D]
  float* kv = qs + BQ * D;        // [KC][D + 1]
  float* ss = kv + KC * (D + 1);  // [BQ][Nk]
  float* ls = ss + BQ * Nk;       // [BQ]

  const int tid = threadIdx.x;
  const int cj = tid % KC;  // this thread's key within a chunk / output column
  const int r0 = tid / KC;  // rows r0, r0 + 4, r0 + 8, r0 + 12
  const size_t out_row = (size_t)H * D;
  T* ob = out + (size_t)b * Nq * out_row + h * D;

  if (i0 >= lq || lk == 0) {  // padded rows, or an empty kv side: zeros
#pragma unroll
    for (int rr = 0; rr < BQ / 4; ++rr) {
      const int gi = i0 + r0 + 4 * rr;
      if (gi < Nq) ob[gi * out_row + cj] = lg::from_f<T>(0.f);
    }
    return;
  }

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    qs[i] = i0 + r < Nq ? lg::to_f(row_ptr<T>(q, b, i0 + r, h)[d]) : 0.f;
  }

  // this direction's rows of S (or S^T): quant(dot * scale), products in
  // d order as qk0_i[d] * qk1_j[d] either way; kv columns >= lk at -1e30
  for (int j0 = 0; j0 < Nk; j0 += KC) {
    const int jn = min(KC, Nk - j0);
    __syncthreads();  // q rows loaded, or the previous chunk is done
    for (int i = tid; i < KC * D; i += THREADS) {
      const int j = i / D, d = i % D;
      kv[j * (D + 1) + d] = j < jn ? lg::to_f(row_ptr<T>(k, b, j0 + j, h)[d]) : 0.f;
    }
    __syncthreads();
    if (cj < jn) {
      const bool dead = lens != nullptr && j0 + cj >= lk;
#pragma unroll
      for (int rr = 0; rr < BQ / 4; ++rr) {
        const int r = r0 + 4 * rr;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d)
          dot = fmaf(qs[r * D + d], kv[cj * (D + 1) + d], dot);
        ss[r * Nk + j0 + cj] = dead ? NEG : lg::quant_stat(dot * scale, quant);
      }
    }
  }
  __syncthreads();

  // m = quant(max), p = quant(exp(s - m)), l = quant(sum p): a warp per 2 rows
  const int warp = tid / 32, lane = tid % 32;
  for (int rr = 0; rr < 2; ++rr) {
    const int r = 2 * warp + rr;
    float* srow = ss + r * Nk;
    float m = -INFINITY;
    for (int j = lane; j < Nk; j += 32) m = fmaxf(m, srow[j]);
    m = lg::quant_stat(lg::warp_max(m), quant);
    float sum = 0.f;
    for (int j = lane; j < Nk; j += 32) {
      const float p = lg::quant_stat(expf(srow[j] - m), quant);
      srow[j] = p;
      sum += dir1 ? lg::round_to<T>(p) : p;
    }
    sum = lg::quant_stat(lg::warp_sum(sum), quant);
    if (lane == 0) ls[r] = sum;
  }

  // O = P.V with P cast to the V type, divided by l in fp32
  float acc[BQ / 4] = {};
  for (int j0 = 0; j0 < Nk; j0 += KC) {
    const int jn = min(KC, Nk - j0);
    __syncthreads();  // the stats pass, or the previous chunk, is done
    for (int i = tid; i < KC * D; i += THREADS) {
      const int j = i / D, d = i % D;
      kv[j * (D + 1) + d] = j < jn ? lg::to_f(row_ptr<T>(v, b, j0 + j, h)[d]) : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < jn; ++j) {
      const float vv = kv[j * (D + 1) + cj];
#pragma unroll
      for (int rr = 0; rr < BQ / 4; ++rr)
        acc[rr] = fmaf(lg::round_to<T>(ss[(r0 + 4 * rr) * Nk + j0 + j]), vv, acc[rr]);
    }
  }

#pragma unroll
  for (int rr = 0; rr < BQ / 4; ++rr) {
    const int r = r0 + 4 * rr;
    const int gi = i0 + r;
    if (gi >= Nq) continue;
    const float l = ls[r];
    const float val = gi < lq ? acc[rr] / (l == 0.f ? 1.f : l) : 0.f;
    ob[gi * out_row + cj] = lg::from_f<T>(val);
  }
}

template <typename T>
int launch(Operand qk0, Operand qk1, Operand v0, Operand v1, const void* lens,
           void* o0, void* o1, int B, int N0, int N1, int H, float scale,
           int quant, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * D + KC * (D + 1) + BQ * max(N0, N1) + BQ);
  static size_t opted_in = 48 * 1024;  // raised once per size, not per launch
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        bidir_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const int stripes0 = (N0 + BQ - 1) / BQ, stripes1 = (N1 + BQ - 1) / BQ;
  dim3 grid(stripes0 + stripes1, H, B);
  bidir_kernel<T><<<grid, THREADS, smem, stream>>>(
      qk0, qk1, v0, v1, static_cast<const int*>(lens), static_cast<T*>(o0),
      static_cast<T*>(o1), N0, N1, H, scale, quant, stripes0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qk0/v0: rows of N0, qk1/v1: rows of N1; head h of a row at columns
// [h*64, h*64 + 64), addressed by (batch, row) strides in elements. lens:
// (B, 2) int32 [n0, n1] or null (unmasked). o0: (B, N0, H*64) and o1:
// (B, N1, H*64) T, contiguous.
extern "C" int lg_bidirectional_cross(
    const void* qk0, long long qk0_bs, long long qk0_rs, const void* qk1,
    long long qk1_bs, long long qk1_rs, const void* v0, long long v0_bs,
    long long v0_rs, const void* v1, long long v1_bs, long long v1_rs,
    const void* lens, void* o0, void* o1, int B, int N0, int N1, int H,
    float scale, int quant, int bf16, void* stream) {
  const Operand a{qk0, qk0_bs, qk0_rs}, c{qk1, qk1_bs, qk1_rs},
      w0{v0, v0_bs, v0_rs}, w1{v1, v1_bs, v1_rs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(a, c, w0, w1, lens, o0, o1, B, N0, N1, H,
                                 scale, quant, s);
  return launch<float>(a, c, w0, w1, lens, o0, o1, B, N0, N1, H, scale, quant,
                       s);
}
