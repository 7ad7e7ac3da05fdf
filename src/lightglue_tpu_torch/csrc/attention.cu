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
// Stats contract (layer_stack.py:267-292): one softmax over the whole row
// (Nk <= 1024). S is scaled after Q.K^T; with `quant` (the BF16 rung) s,
// the row max m, p and the row sum l are each rounded through bf16; padded
// kv columns become -1e30 (unrounded); with lengths or keep masks the row
// max is clamped at -5e29, so an all-masked row (a length 0, a fully pruned
// keep vector) yields exactly 0; o = P.V / (l == 0 ? 1 : l) in fp32 with P
// cast to the operand type, and padded q rows are zeroed; then ONE cast to
// T. RoPE casts the freqs to the operand type and rounds each product and
// the sum (:377-384).
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
// so at N = 1024 the tensor cores bound it (~1.1 us per call at the bf16
// peak, B = 1, H = 4).
//
// The BF16 kernel (attention_mma_kernel) is flash_attn.cu's machinery
// (mma.cuh) at one tile of block_k = Nk:
// - mma.sync m16n8k16, bf16 in, fp32 sums; Q and K by ldmatrix, V by
//   ldmatrix.trans. Each warp keeps its 16 rows' Q fragments in registers
//   and S in registers; P goes from the S accumulator layout into the A
//   operand of the P.V mma, cast to bf16 there (p.astype(v.dtype)).
// - Two passes over the row: pass 1 computes S chunk by chunk and reduces
//   the row max; pass 2 recomputes S with the same instructions (bit for
//   bit the same), forms p, sums it and accumulates P.V. K (pass 1) and K
//   and V (pass 2) stage in 64-key chunks with 16 B cp.async, double
//   buffered, rows padded to 72 elements.
// - Where it differs from flash_attn.cu, because the stack's contract does:
//   1. acc is never rounded: pv / l in fp32, then the keep multiply or the
//      row zeroing, then one cast to T (the flash kernel rounds acc once
//      per tile, which here would round twice);
//   2. the max clamp: m = max(quant(rowmax), -5e29) when masked or keep
//      masked (the flash kernel skips tiles past kv_len instead; scattered
//      keep columns cannot be skipped, and without the clamp an all-dead
//      row gives m = quant(-1e30) = -1.000256e30 and exp(+2.6e26) = inf);
//   3. s is rounded and dead columns are set to exactly -1e30; under KEEP
//      the column mask applies in every chunk; with lengths only the
//      chunk that holds kv_len does, and chunks wholly past kv_len are not
//      computed (their p is exactly 0 at the clamped m, so that is exact);
//   4. keep masks and liveness as above;
//   5. Q, K and V are column slices of one (B, N, H*64) projection (row
//      stride 3E for self qkv, 2E for cross [qk | v]); rows not on 16 B
//      are staged by element loads (mma.cuh:stage_rows).
// - RoPE runs once, in mma.cuh's rope_kernel, over q and k into a bf16
//   scratch (lg_rope_qk, which the wrapper launches first); the kernel then
//   reads rotated rows. Rotating K in every block that reads it cost more
//   than the attention at N = 2048 (flash_attn.cu, PR 5).
// - A block has 4 warps and 16 * 4 / C rows; the launch picks C so that a
//   short grid still fills the card (mma.cuh:fill_row_groups: at B = 1,
//   H = 4, N = 1024 one 16-row group, its four warps splitting each chunk's
//   keys, 256 blocks); the split warps' row max, sum p and P.V meet in
//   shared memory, which changes only the order of fp32 sums.
//
// The FP32 kernel (attention_kernel, the fp32 rung) stays on the FMA units:
// one TF32 mma would miss the 1e-4 gate of the fp32 rung. One block per 16
// query rows keeps the whole 16 x Nk row block of S in shared memory and
// takes max, exp, sum and P.V in that order, with RoPE applied as it stages
// Q and K.

#include <math.h>

#include "mma.cuh"

namespace {

using namespace lg;  // Operand, row_ptr and the tensor-core helpers (mma.cuh)

constexpr int D = HD;        // head dim
constexpr int BQ = 16;       // query rows per block (FP32 kernel)
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;
constexpr float DEAD = -5e29f;

// ---------------------------------------------------------------------------
// The FP32 kernel: products on the FMA units
// ---------------------------------------------------------------------------

template <bool KEEP>
__global__ void __launch_bounds__(THREADS, 2)
attention_kernel(Operand q, Operand k, Operand v, const float* __restrict__ freqs,
                 const int* __restrict__ len_q, const int* __restrict__ len_kv,
                 const float* __restrict__ keep_q,
                 const float* __restrict__ keep_kv,
                 const float* __restrict__ exit_reg, int layer,
                 float* __restrict__ out, int Nq, int Nk, int H, float scale,
                 int quant) {
  using T = float;
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
    qs[i] = i0 + r < Nq ? lg::to_f(row_ptr<T>(q, b, h, i0 + r)[d]) : 0.f;
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
      kv[j * (D + 1) + d] = j < jn ? lg::to_f(row_ptr<T>(k, b, h, j0 + j)[d]) : 0.f;
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
      kv[j * (D + 1) + d] = j < jn ? lg::to_f(row_ptr<T>(v, b, h, j0 + j)[d]) : 0.f;
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

// ---------------------------------------------------------------------------
// The BF16 kernel: both products on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

template <bool KEEP, int C>
__global__ void __launch_bounds__(WARPS * 32)
attention_mma_kernel(Operand q, Operand k, Operand v, const int* __restrict__ len_q,
                     const int* __restrict__ len_kv, const float* __restrict__ keep_q,
                     const float* __restrict__ keep_kv, const float* __restrict__ exit_reg,
                     int layer, bf16_t* __restrict__ out, int Nq, int Nk, int H, float scale,
                     int quant, int aligned) {
  constexpr int BR = 16 * (WARPS / C);  // rows per block
  constexpr int KW = KC / C;            // keys of each chunk per warp
  constexpr int NT = KW / 8;            // S n-tiles per warp and chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* qs = reinterpret_cast<bf16_t*>(smem_raw);                 // [BR][LD]
  bf16_t* kv = qs + BR * LD;                                        // [2][K, V][KC][LD]
  float* red = reinterpret_cast<float*>(kv + 2 * 2 * KC * LD);      // C > 1: [WARPS][16][RS]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rg = warp / C, part = warp % C;  // 16-row group, share of each chunk's keys
  const int g = lane / 4, t4 = lane % 4;     // mma fragment row and column pair
  const int mi = lane / 8, mr = lane % 8;    // ldmatrix matrix and row of this lane
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * BR;
  if (exit_reg && !(exit_reg[b] > static_cast<float>(layer))) return;
  const bool masked = KEEP || len_q != nullptr;
  const int lq = (!KEEP && len_q) ? len_q[b] : Nq;
  // keys that can be live: every key under KEEP, the valid prefix with lengths
  const int live_k = (!KEEP && len_kv) ? max(min(len_kv[b], Nk), 0) : Nk;
  const float* kq = KEEP ? keep_q + (size_t)b * Nq : nullptr;
  const float* kk = KEEP ? keep_kv + (size_t)b * Nk : nullptr;
  bf16_t* ob = out + (size_t)b * Nq * H * D + h * D;  // row gi at ob + gi * H * D

  if (!KEEP && i0 >= lq) {  // a block wholly past q_len: zeros
    for (int i = tid; i < BR * D; i += blockDim.x)
      if (i0 + i / D < Nq) ob[(size_t)(i0 + i / D) * H * D + i % D] = __float2bfloat16(0.f);
    return;
  }

  // Q into registers: this warp's 16 rows as 4 A fragments
  stage_rows(qs, q, b, h, i0, BR, min(BR, Nq - i0), aligned);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  unsigned qf[D / 16][4];
#pragma unroll
  for (int kk16 = 0; kk16 < D / 16; ++kk16)
    ldsm_x4(qf[kk16], qs + (rg * 16 + mr + (mi & 1) * 8) * LD + kk16 * 16 + (mi >> 1) * 8);

  // chunks over the keys that can be live, two buffers: chunk c + 1 copies
  // while chunk c is in use
  const int nc = (live_k + KC - 1) / KC;
  auto kbuf = [&](int c) { return kv + (c & 1) * 2 * KC * LD; };
  auto fetch = [&](int c, bool with_v) {
    const int jn = min(KC, Nk - c * KC);
    stage_rows(kbuf(c), k, b, h, c * KC, KC, jn, aligned);
    if (with_v) stage_rows(kbuf(c) + KC * LD, v, b, h, c * KC, KC, jn, aligned);
    cp_async_commit();
  };
  auto land = [&](int c) {  // chunk c has landed (chunk c + 1 may be in flight)
    if (c + 1 < nc)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
  };
  // s = quant(Q.K^T * scale) over this warp's KW keys of chunk c. Pad
  // columns past Nk are -inf (no part in max, p or sum p); dead columns
  // (keep < 0.5, or at or past kv_len) are -1e30, as the reference sets
  // them. Without keep masks only the chunk that holds kv_len or Nk has
  // any; one select per element (no branches) in those.
  auto scores = [&](float (&s)[NT][4], int c) {
    const bf16_t* kb = kbuf(c) + part * KW * LD;
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk16 = 0; kk16 < D / 16; ++kk16) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned r[4];
        ldsm_x4(r, kb + (np * 16 + mr + (mi >> 1) * 8) * LD + kk16 * 16 + (mi & 1) * 8);
        mma_bf16(s[2 * np], qf[kk16], r[0], r[1]);
        mma_bf16(s[2 * np + 1], qf[kk16], r[2], r[3]);
      }
    }
    const int c0 = c * KC;
    const bool ragged = KEEP || c0 + KC > live_k;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + part * KW + n * 8 + 2 * t4 + (e & 1);
        float x = lg::quant_stat(s[n][e] * scale, quant);
        if (ragged) {
          const bool pad = col >= Nk;
          const bool dead = KEEP ? !pad && __ldg(kk + col) < 0.5f : col >= live_k;
          x = pad ? -INFINITY : (dead ? NEG : x);
        }
        s[n][e] = x;
      }
    }
  };

  // pass 1: the row max
  float mx[2] = {-INFINITY, -INFINITY};
  if (nc) fetch(0, false);
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) fetch(c + 1, false);  // the buffer of chunk c - 1
    land(c);
    float s[NT][4];
    scores(s, c);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    __syncthreads();  // this buffer is free for the next fetch
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  if (C > 1) {
    if (t4 == 0) {
      red[(warp * 16 + g) * RS] = mx[0];
      red[(warp * 16 + g + 8) * RS] = mx[1];
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < C; ++w) {
      mx[0] = fmaxf(mx[0], red[((rg * C + w) * 16 + g) * RS]);
      mx[1] = fmaxf(mx[1], red[((rg * C + w) * 16 + g + 8) * RS]);
    }
    __syncthreads();
  }
  float m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = lg::quant_stat(mx[i], quant);
    if (masked) m[i] = fmaxf(m[i], DEAD);
  }

  // pass 2: the same S again, p, sum p and P.V with P cast to bf16
  float ps[2] = {0.f, 0.f};
  float pv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
  if (nc) fetch(0, true);
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) fetch(c + 1, true);
    land(c);
    float s[NT][4];
    scores(s, c);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = lg::quant_stat(expf(s[n][e] - m[e / 2]), quant);
        ps[e / 2] += s[n][e];
      }
    }
    const bf16_t* vb = kbuf(c) + KC * LD + part * KW * LD;
#pragma unroll
    for (int kk16 = 0; kk16 < NT / 2; ++kk16) {  // 16 keys per k step
      const unsigned a[4] = {pack_bf16(s[2 * kk16][0], s[2 * kk16][1]),
                             pack_bf16(s[2 * kk16][2], s[2 * kk16][3]),
                             pack_bf16(s[2 * kk16 + 1][0], s[2 * kk16 + 1][1]),
                             pack_bf16(s[2 * kk16 + 1][2], s[2 * kk16 + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned r[4];
        ldsm_x4_trans(r, vb + (kk16 * 16 + mr + (mi & 1) * 8) * LD + dp * 16 + (mi >> 1) * 8);
        mma_bf16(pv[2 * dp], a, r[0], r[1]);
        mma_bf16(pv[2 * dp + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();  // this buffer is free for the next fetch
  }
  ps[0] = quad_sum(ps[0]);
  ps[1] = quad_sum(ps[1]);
  if (C > 1) {  // the C warps of a row group add their parts in one order
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* rec = red + (warp * 16 + g + 8 * i) * RS;
      if (t4 == 0) rec[1] = ps[i];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(rec + 2 + n * 8 + 2 * t4) =
            make_float2(pv[n][2 * i], pv[n][2 * i + 1]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ps[i] = 0.f;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) pv[n][2 * i] = pv[n][2 * i + 1] = 0.f;
#pragma unroll
      for (int w = 0; w < C; ++w) {
        const float* rec = red + ((rg * C + w) * 16 + g + 8 * i) * RS;
        ps[i] += rec[1];
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const float2 x = *reinterpret_cast<const float2*>(rec + 2 + n * 8 + 2 * t4);
          pv[n][2 * i] += x.x;
          pv[n][2 * i + 1] += x.y;
        }
      }
    }
  }

  if (part != 0) return;  // the C warps of a row group hold the same rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gi = i0 + rg * 16 + g + 8 * i;
    if (gi >= Nq) continue;
    const float l = lg::quant_stat(ps[i], quant);
    const float den = l == 0.f ? 1.f : l;
    const bool zero = !KEEP && masked && gi >= lq;
    const float keep = KEEP ? kq[gi] : 1.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float x0 = pv[n][2 * i] / den, x1 = pv[n][2 * i + 1] / den;
      if (KEEP) x0 *= keep, x1 *= keep;
      if (zero) x0 = x1 = 0.f;
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)gi * H * D + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <bool KEEP>
int launch_fma(Operand q, Operand k, Operand v, const void* freqs, const void* len_q,
               const void* len_kv, const void* keep_q, const void* keep_kv,
               const void* exit_reg, int layer, void* out, int B, int Nq, int Nk, int H,
               float scale, int quant, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * D + KC * (D + 1) + BQ * Nk + BQ);
  static size_t opted_in = 48 * 1024;  // raised once per size, not per launch
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<KEEP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  dim3 grid((Nq + BQ - 1) / BQ, H, B);
  attention_kernel<KEEP><<<grid, THREADS, smem, stream>>>(
      q, k, v, static_cast<const float*>(freqs),
      static_cast<const int*>(len_q), static_cast<const int*>(len_kv),
      static_cast<const float*>(keep_q), static_cast<const float*>(keep_kv),
      static_cast<const float*>(exit_reg), layer, static_cast<float*>(out), Nq,
      Nk, H, scale, quant);
  return static_cast<int>(cudaGetLastError());
}

template <bool KEEP, int C>
int launch_mma(Operand q, Operand k, Operand v, const void* len_q, const void* len_kv,
               const void* keep_q, const void* keep_kv, const void* exit_reg, int layer,
               void* out, int B, int Nq, int Nk, int H, float scale, int quant,
               cudaStream_t stream) {
  const size_t smem = mma_smem(C, 2);
  static size_t opted_in = 48 * 1024;  // raised once, not per launch
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(attention_mma_kernel<KEEP, C>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  constexpr int BR = 16 * (WARPS / C);
  const int aligned = aligned16(q) && aligned16(k) && aligned16(v);
  dim3 grid((Nq + BR - 1) / BR, H, B);
  attention_mma_kernel<KEEP, C><<<grid, WARPS * 32, smem, stream>>>(
      q, k, v, static_cast<const int*>(len_q), static_cast<const int*>(len_kv),
      static_cast<const float*>(keep_q), static_cast<const float*>(keep_kv),
      static_cast<const float*>(exit_reg), layer, static_cast<bf16_t*>(out), Nq, Nk, H, scale,
      quant, aligned);
  return static_cast<int>(cudaGetLastError());
}

template <bool KEEP>
int launch_bf16(Operand q, Operand k, Operand v, const void* len_q, const void* len_kv,
                const void* keep_q, const void* keep_kv, const void* exit_reg, int layer,
                void* out, int B, int Nq, int Nk, int H, float scale, int quant,
                cudaStream_t s) {
  switch (fill_row_groups(B, H, Nq)) {
    case 4:
      return launch_mma<KEEP, 1>(q, k, v, len_q, len_kv, keep_q, keep_kv, exit_reg, layer, out,
                                 B, Nq, Nk, H, scale, quant, s);
    case 2:
      return launch_mma<KEEP, 2>(q, k, v, len_q, len_kv, keep_q, keep_kv, exit_reg, layer, out,
                                 B, Nq, Nk, H, scale, quant, s);
    default:
      return launch_mma<KEEP, 4>(q, k, v, len_q, len_kv, keep_q, keep_kv, exit_reg, layer, out,
                                 B, Nq, Nk, H, scale, quant, s);
  }
}

}  // namespace

// q: rows of Nq, k/v: rows of Nk; head h of a row at columns [h*64, h*64+64),
// addressed by (batch, row) strides in elements. freqs: (B, 2, N, 64) fp32
// [cos; sin] with Nq == Nk == N, or null for no RoPE; with bf16 operands it
// must be null: the caller rotates q and k first (lg_rope_qk) and passes the
// rotated rows. len_q/len_kv: (B,) int32, both null for the unmasked
// variant. keep_q/keep_kv: (B, Nq)/(B, Nk) fp32 0/1 keep masks, both null
// or both set (then the lengths are ignored). exit_reg: (B,) fp32 or null;
// layer: the global layer index. out: (B, Nq, H*64) T. bf16 operands run
// attention_mma_kernel with mma.cuh:fill_row_groups' 16-row groups per
// block (kernels/layer_stack.py:attention_plan mirrors it), fp32 operands
// the FMA kernel.
extern "C" int lg_attention(const void* q, long long q_bs, long long q_rs,
                            const void* k, long long k_bs, long long k_rs,
                            const void* v, long long v_bs, long long v_rs,
                            const void* freqs, const void* len_q,
                            const void* len_kv, const void* keep_q,
                            const void* keep_kv, const void* exit_reg,
                            int layer, void* out, int B, int Nq, int Nk,
                            int H, float scale, int quant, int bf16,
                            void* stream) {
  const Operand oq{q, q_bs, D, q_rs}, ok{k, k_bs, D, k_rs}, ov{v, v_bs, D, v_rs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool keep = keep_q != nullptr;
  if (bf16) {
    if (freqs) return static_cast<int>(cudaErrorInvalidValue);
    return (keep ? launch_bf16<true> : launch_bf16<false>)(
        oq, ok, ov, len_q, len_kv, keep_q, keep_kv, exit_reg, layer, out, B, Nq, Nk, H, scale,
        quant, s);
  }
  return (keep ? launch_fma<true> : launch_fma<false>)(
      oq, ok, ov, freqs, len_q, len_kv, keep_q, keep_kv, exit_reg, layer, out, B, Nq, Nk, H,
      scale, quant, s);
}

// The bf16 self-attention's RoPE pre-pass: q and k ((B, N, H*64) bf16 rows
// addressed by (batch, row) strides) rotated with freqs (B, 2, N, 64) fp32
// into rot (2, B, N, H*64) bf16, which lg_attention then reads as q and k.
extern "C" int lg_rope_qk(const void* q, long long q_bs, long long q_rs, const void* k,
                          long long k_bs, long long k_rs, const void* freqs, void* rot, int B,
                          int N, int H, void* stream) {
  const Operand oq{q, q_bs, D, q_rs}, ok{k, k_bs, D, k_rs};
  return static_cast<int>(rope_qk(oq, ok, static_cast<const float*>(freqs),
                                  static_cast<bf16_t*>(rot), B, N, H,
                                  static_cast<cudaStream_t>(stream)));
}

// The 16-row groups per block of lg_attention's bf16 kernel at this shape
// (the wrapper's plan is held against it).
extern "C" int lg_attention_row_groups(int B, int H, int Nq) { return fill_row_groups(B, H, Nq); }
