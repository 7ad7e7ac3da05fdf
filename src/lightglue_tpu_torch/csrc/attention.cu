// Masked multi-head attention of the LightGlue layer stack, one kernel for
// the self block (half-split RoPE on q and k) and for either direction of
// the cross block (no RoPE).
//
// Replaces the attention inside the TPU kernel
// lightglue_tpu/kernels/layer_stack.py:transformer_stack (wrapper :801,
// pallas_call :894): self-attention :442-472, cross-attention :491-560.
// The TPU kernel shares one similarity matrix between the two cross
// directions to save VMEM; here each direction is its own launch (q=qk0,
// k=qk1, v=v1 and q=qk1, k=qk0, v=v0 with the lengths swapped), which
// computes the same function.
//
// Stats contract (layer_stack.py:267-292): S is scaled after Q.K^T; with
// `quant` (the BF16 rung) s, the row max m, p and the row sum l are each
// rounded through bf16; padded kv columns become -1e30; the row max is
// clamped at -5e29 so an all-masked row yields exactly 0; l == 0 divides
// by 1; padded q rows are zeroed. RoPE casts the freqs to the operand type
// and rounds each product and the sum (:377-384).
//
// Adaptive operands (transformer_stack_adaptive, wrapper :974, pallas_call
// :1229): under width pruning (B, N) fp32 0/1 keep vectors replace the
// lengths: kv columns with keep < 0.5 become -1e30 and each output row is
// multiplied by its own keep (:457, :468-469, :500, :523, :535, :553-555).
// With an exit register (B,) fp32 and the global layer g, a block whose
// pair has exit <= g returns at once (the pl.when(live) gate, :734-745):
// its output rows are left unwritten, and the stack never reads them. The
// keep masks are a template parameter, so the fixed-depth path runs the
// code it ran without them.
//
// Bound on the H100: per head 4*Nq*Nk*D FLOP against (Nq+2*Nk)*D operands,
// so at N = 1024 the tensor cores bound it (~1 us per call at the bf16
// peak). Design: one block per 16 query rows of one head keeps the whole
// 16 x Nk row block of S in shared memory (64 KB at Nk = 1024, which the
// N <= 1024 gate guarantees) and takes max, exp, sum and P.V in that order,
// so every rounding point of the reference is reproduced (an online
// softmax would rescale at other points). The products run on the fp32 FMA
// units in this first version. Asking for two blocks per SM in the launch
// bounds (two fit by shared memory either way) lets ptxas unroll the
// products over 72-95 registers instead of 32-48, without spills; the
// keep-masked variant gains most (PERF.md).

#include <math.h>

#include "common.cuh"

namespace {

constexpr int D = 64;        // head dim
constexpr int BQ = 16;       // query rows per block
constexpr int KC = 64;       // keys per staged chunk
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;
constexpr float DEAD = -5e29f;

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

template <typename T, bool KEEP>
__global__ void __launch_bounds__(THREADS, 2)
attention_kernel(Operand q, Operand k, Operand v, const float* __restrict__ freqs,
                 const int* __restrict__ len_q, const int* __restrict__ len_kv,
                 const float* __restrict__ keep_q,
                 const float* __restrict__ keep_kv,
                 const float* __restrict__ exit_reg, int layer,
                 T* __restrict__ out, int Nq, int Nk, int H, float scale,
                 int quant) {
  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][D]
  float* kv = qs + BQ * D;          // [KC][D + 1]
  float* ss = kv + KC * (D + 1);    // [BQ][Nk]
  float* ls = ss + BQ * Nk;         // [BQ]

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * BQ;
  if (exit_reg && !(exit_reg[b] > static_cast<float>(layer))) return;
  const bool masked = KEEP || len_q != nullptr;
  const int lq = len_q ? len_q[b] : Nq;
  const int lk = len_kv ? len_kv[b] : Nk;
  const float* kq = KEEP ? keep_q + (size_t)b * Nq : nullptr;
  const float* kk = KEEP ? keep_kv + (size_t)b * Nk : nullptr;
  const float* fb = freqs ? freqs + (size_t)b * 2 * Nq * D : nullptr;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    qs[i] = i0 + r < Nq ? lg::to_f(row_ptr<T>(q, b, i0 + r, h)[d]) : 0.f;
  }
  __syncthreads();
  if (fb) {
    lg::rope_rows<T, D>(qs, D, min(BQ, Nq - i0), i0, fb, Nq);
    __syncthreads();
  }

  // S = quant(Q.K^T * scale), masked columns -1e30
  const int cj = tid % KC;  // this thread's key within a chunk / output dim
  const int r0 = tid / KC;  // rows r0, r0+4, r0+8, r0+12
  for (int j0 = 0; j0 < Nk; j0 += KC) {
    const int jn = min(KC, Nk - j0);
    for (int i = tid; i < KC * D; i += THREADS) {
      const int j = i / D, d = i % D;
      kv[j * (D + 1) + d] = j < jn ? lg::to_f(row_ptr<T>(k, b, j0 + j, h)[d]) : 0.f;
    }
    __syncthreads();
    if (fb) {
      lg::rope_rows<T, D>(kv, D + 1, jn, j0, fb, Nk);
      __syncthreads();
    }
    if (cj < jn) {
      const bool dead_col = KEEP ? kk[j0 + cj] < 0.5f : (masked && j0 + cj >= lk);
#pragma unroll
      for (int rr = 0; rr < BQ / 4; ++rr) {
        const int r = r0 + 4 * rr;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qs[r * D + d], kv[cj * (D + 1) + d], dot);
        float s = lg::quant_stat(dot * scale, quant);
        if (dead_col) s = NEG;
        ss[r * Nk + j0 + cj] = s;
      }
    }
    __syncthreads();
  }

  // row max, p = quant(exp(s - m)), l = quant(sum p): one warp per 2 rows
  const int warp = tid / 32, lane = tid % 32;
  for (int rr = 0; rr < 2; ++rr) {
    const int r = 2 * warp + rr;
    float* srow = ss + r * Nk;
    float m = -INFINITY;
    for (int j = lane; j < Nk; j += 32) m = fmaxf(m, srow[j]);
    m = lg::quant_stat(lg::warp_max(m), quant);
    if (masked) m = fmaxf(m, DEAD);
    float sum = 0.f;
    for (int j = lane; j < Nk; j += 32) {
      const float p = lg::quant_stat(expf(srow[j] - m), quant);
      srow[j] = p;
      sum += p;
    }
    sum = lg::quant_stat(lg::warp_sum(sum), quant);
    if (lane == 0) ls[r] = sum;
  }

  // O = P.V with P cast to the operand type
  float acc[BQ / 4] = {};
  for (int j0 = 0; j0 < Nk; j0 += KC) {
    const int jn = min(KC, Nk - j0);
    __syncthreads();  // previous chunk (or the stats pass) is done
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
    float o = acc[rr] / (l == 0.f ? 1.f : l);
    if (KEEP)
      o *= kq[gi];
    else if (masked && gi >= lq)
      o = 0.f;
    out[((size_t)b * Nq + gi) * H * D + h * D + cj] = lg::from_f<T>(o);
  }
}

template <typename T, bool KEEP>
int launch(Operand q, Operand k, Operand v, const void* freqs,
           const void* len_q, const void* len_kv, const void* keep_q,
           const void* keep_kv, const void* exit_reg, int layer, void* out,
           int B, int Nq, int Nk, int H, float scale, int quant,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * D + KC * (D + 1) + BQ * Nk + BQ);
  static size_t opted_in = 48 * 1024;  // raised once per size, not per launch
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<T, KEEP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  dim3 grid((Nq + BQ - 1) / BQ, H, B);
  attention_kernel<T, KEEP><<<grid, THREADS, smem, stream>>>(
      q, k, v, static_cast<const float*>(freqs),
      static_cast<const int*>(len_q), static_cast<const int*>(len_kv),
      static_cast<const float*>(keep_q), static_cast<const float*>(keep_kv),
      static_cast<const float*>(exit_reg), layer, static_cast<T*>(out), Nq,
      Nk, H, scale, quant);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: rows of Nq, k/v: rows of Nk; head h of a row at columns [h*64, h*64+64),
// addressed by (batch, row) strides in elements. freqs: (B, 2, N, 64) fp32
// [cos; sin] with Nq == Nk == N, or null for no RoPE. len_q/len_kv: (B,)
// int32, both null for the unmasked variant. keep_q/keep_kv: (B, Nq)/(B, Nk)
// fp32 0/1 keep masks, both null or both set (then the lengths are
// ignored). exit_reg: (B,) fp32 or null; layer: the global layer index.
// out: (B, Nq, H*64) T.
extern "C" int lg_attention(const void* q, long long q_bs, long long q_rs,
                            const void* k, long long k_bs, long long k_rs,
                            const void* v, long long v_bs, long long v_rs,
                            const void* freqs, const void* len_q,
                            const void* len_kv, const void* keep_q,
                            const void* keep_kv, const void* exit_reg,
                            int layer, void* out, int B, int Nq, int Nk,
                            int H, float scale, int quant, int bf16,
                            void* stream) {
  const Operand oq{q, q_bs, q_rs}, ok{k, k_bs, k_rs}, ov{v, v_bs, v_rs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool keep = keep_q != nullptr;
  if (bf16)
    return (keep ? launch<__nv_bfloat16, true> : launch<__nv_bfloat16, false>)(
        oq, ok, ov, freqs, len_q, len_kv, keep_q, keep_kv, exit_reg, layer, out,
        B, Nq, Nk, H, scale, quant, s);
  return (keep ? launch<float, true> : launch<float, false>)(
      oq, ok, ov, freqs, len_q, len_kv, keep_q, keep_kv, exit_reg, layer, out, B,
      Nq, Nk, H, scale, quant, s);
}
