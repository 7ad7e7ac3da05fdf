// Both directions of LightGlue's symmetric cross-attention in one launch:
// image 0's rows attend to image 1 (the row softmax of S) and image 1's rows
// attend to image 0 (the column softmax of the same S).
//
// Replaces lightglue_tpu/kernels/attention.py:bidirectional_cross_attention
// (wrapper :925, pallas_call :985, body :811-919). The TPU kernel holds one
// S per head in VMEM and softmaxes it along both axes. Here a direction-1
// block computes rows of S^T as qk1_j . qk0_i, the same products over d in
// the same k-step order as direction 0.
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
// products and 2 * N0 * N1 * D for S (the TPU kernel's one S; here each
// direction computes it twice), against (2 N0 + 2 N1) * D operands:
// tensor-core bound (~0.013 ms at 960 x 960, B = 1, H = 4, in bf16; ~0.077
// ms in fp32 at three TF32 products a product).
//
// The BF16 kernel (bidir_mma_kernel) is attention.cu's two-pass whole-row
// softmax on mma.cuh's machinery, both directions in one grid:
// - the grid runs over (the 16-row groups of direction 0, then those of
//   direction 1; head; pair). A direction-0 block takes Q = its qk0 rows,
//   K = qk1, V = v1; a direction-1 block Q = qk1, K = qk0, V = v0 with the
//   lengths swapped. All four are column slices of the [qk | v] projection,
//   addressed by the wrapper's row strides (mma.cuh:stage_rows).
// - mma.sync m16n8k16, bf16 in, fp32 sums; Q and K by ldmatrix, V by
//   ldmatrix.trans; Q's fragments and S stay in registers. Pass 1 computes S
//   chunk by chunk and reduces the row max; pass 2 recomputes S with the same
//   instructions (bit for bit), forms p and sum p, and takes P from the S
//   accumulator into the A operand of P.V (cast to bf16 there). K (pass 1)
//   and K and V (pass 2) stage in 64-key chunks, double buffered by 16 B
//   cp.async. Shared memory no longer grows with N.
// - Where it differs from attention.cu: no clamp, no RoPE, no keep or
//   liveness operands; direction 1 keeps the cast of p to the V type before
//   its sum (the identity at bf16 stats, the contract at fp32 stats); chunks
//   wholly past the kv length are skipped, which is exact: with a non-empty
//   kv side m comes from a live column and a dead p is exactly 0; an empty kv
//   side writes its zero rows before any work.
// - The output type TO is bf16 (the BF16 rung) or fp32 (MIXED: bf16
//   operands, fp32 stats, an fp32 out): the same instructions up to the
//   final store, which rounds to TO or does not.
// - mma.cuh:fill_row_groups counted over both directions' rows of one pair,
//   aiming for BIDIR_FILL_BLOCKS blocks, picks 4, 2 or 1 16-row groups per
//   block (kernels/attention.py:bidir_plan mirrors it); the C = 4 / groups
//   warps of a group split each chunk's keys and meet in shared memory,
//   which changes only the order of fp32 sums, and the pair's shape alone
//   sets it. Where a batch's launch still gives BIDIR_FILL_BLOCKS blocks,
//   a block takes two or four of those groups in one block of eight or
//   sixteen warps (mma.cuh:batch_plan; the fp32 kernel likewise), which
//   share each staged K and V chunk and change no row's arithmetic. At 960
//   x 960 (B = 1, H = 4) 128
//   blocks give 2 groups, 240 blocks, 0.049 ms; the stack attention's 256
//   give 1 group, 480 blocks, 0.081 ms; 64 give 4 groups, 0.064 ms
//   (scripts/tune_torch_bidir.py on an H100 at 700 W).
//
// The FP32 kernel (bidir_tf32_kernel: fp32 operands and out, fp32 or bf16
// stats) is the same grid and the same contract on the tensor cores in
// 3xTF32 (one TF32 product misses the fp32 rung's 1e-4 gate): every product
// hi*lo + lo*hi + hi*hi of operands split by truncation on mma.sync
// m16n8k8, from mma.cuh's 3xTF32 attention pieces (Q
// split once into register fragments, tf32_q_frags; S per chunk,
// tf32_scores, recomputed bit for bit in pass 2; P from the S accumulator
// into P.V unshuffled, tf32_pv; K and V raw fp32 at pitch FP through the
// two-stage cp.async ring, split as their fragments load; meet_max and
// meet_sums where warps split the keys). Its shared memory does not grow
// with N (mma.cuh:tf32_smem); its row groups are the bf16 kernel's, aiming
// for BIDIR_FILL_BLOCKS (kernels/attention.py:bidir_plan mirrors both): at
// 960 x 960 (B = 1, H = 4) 128 blocks give 2 groups, 240 blocks, 0.080 ms;
// 256 give 1 group, 480 blocks, 0.124 ms; 64 give 4 groups, 0.089 ms
// (scripts/tune_torch_fp32_stack_bidir.py on an H100 at 700 W).

#include <math.h>

#include "mma.cuh"

namespace {

using namespace lg;  // Operand, row_ptr and the tensor-core helpers (mma.cuh)

constexpr int D = HD;  // head dim
constexpr float NEG = -1e30f;
constexpr int BIDIR_FILL_BLOCKS = 128;  // blocks the row-group rule aims for (both kernels)

// ---------------------------------------------------------------------------
// The FP32 kernel: both products on the tensor cores in 3xTF32 (m16n8k8)
// ---------------------------------------------------------------------------

template <int G, int C>
__global__ void __launch_bounds__(G * C * 32, G * C > WARPS ? 1 : 2)
bidir_tf32_kernel(Operand qk0, Operand qk1, Operand v0, Operand v1, const int* __restrict__ lens,
                  float* __restrict__ o0, float* __restrict__ o1, int N0, int N1, int H,
                  float scale, int quant, int blocks0, int aligned) {
  constexpr int BR = 16 * G;   // rows per block
  constexpr int KW = KC / C;   // keys of each chunk per warp
  constexpr int NT = KW / 8;   // S n-tiles per warp and chunk (= P.V k steps)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [BR][FP]
  float* kv = qs + BR * FP;                         // [TF32_STAGES][K, V][KC][FP]
  float* red = kv + TF32_STAGES * 2 * KC * FP;      // C > 1: [G * C][16][RS]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rg = warp / C, part = warp % C;  // 16-row group, share of each chunk's keys
  const int g = lane / 4, t4 = lane % 4;     // mma fragment row and column
  const bool dir1 = blockIdx.x >= blocks0;   // image 1's rows attend to image 0
  const int b = blockIdx.z, h = blockIdx.y;
  const int i0 = (dir1 ? blockIdx.x - blocks0 : blockIdx.x) * BR;
  const Operand q = dir1 ? qk1 : qk0;
  const Operand k = dir1 ? qk0 : qk1;
  const Operand v = dir1 ? v0 : v1;
  const int Nq = dir1 ? N1 : N0, Nk = dir1 ? N0 : N1;
  const int lq = lens ? lens[2 * b + dir1] : Nq;
  // keys that can be live: the other image's valid prefix
  const int live_k = lens ? max(min(lens[2 * b + !dir1], Nk), 0) : Nk;
  float* ob = (dir1 ? o1 : o0) + (size_t)b * Nq * H * D + h * D;  // row gi at ob + gi * H * D

  if (i0 >= lq || live_k == 0) {  // padded rows, or an empty kv side: zeros
    for (int i = tid; i < BR * D; i += blockDim.x)
      if (i0 + i / D < Nq) ob[(size_t)(i0 + i / D) * H * D + i % D] = 0.f;
    return;
  }

  // Q into registers, split once: this warp's 16 rows as D / 8 (hi, lo) A
  // fragments
  stage_rows(qs, q, b, h, i0, BR, min(BR, Nq - i0), aligned);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  unsigned qh[D / 8][4], ql[D / 8][4];
  tf32_q_frags(qs + rg * 16 * FP, g, t4, qh, ql);

  // chunks over the live keys, two buffers: chunk c + 1 copies while chunk c
  // is in use (pass 1 K only, pass 2 K and V)
  const int nc = (live_k + KC - 1) / KC;
  auto kbuf = [&](int c) { return kv + (c & 1) * 2 * KC * FP; };
  auto fetch = [&](int c, bool with_v) {
    const int jn = min(KC, Nk - c * KC);
    stage_rows(kbuf(c), k, b, h, c * KC, KC, jn, aligned);
    if (with_v) stage_rows(kbuf(c) + KC * FP, v, b, h, c * KC, KC, jn, aligned);
    cp_async_commit();
  };
  auto land = [&](int c) {  // chunk c has landed (chunk c + 1 may be in flight)
    if (c + 1 < nc)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
  };
  // s = quant(Q.K^T * scale) over this warp's KW keys of chunk c
  // (mma.cuh:tf32_scores), masked as the bf16 kernel's: pad columns past Nk
  // -inf, columns at or past the kv length -1e30, only in the chunk that
  // holds the kv length or Nk
  auto scores = [&](float (&s)[NT][4], int c) {
    tf32_scores<NT>(s, qh, ql, kbuf(c) + part * KW * FP, g, t4);
    const int c0 = c * KC;
    const bool ragged = c0 + KC > live_k;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + part * KW + n * 8 + 2 * t4 + (e & 1);
        float x = lg::quant_stat(s[n][e] * scale, quant);
        if (ragged) x = col >= Nk ? -INFINITY : (col >= live_k ? NEG : x);
        s[n][e] = x;
      }
    }
  };

  // pass 1: the row max
  float mx[2] = {-INFINITY, -INFINITY};
  fetch(0, false);
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
  meet_max<C>(mx, red, warp, g, t4);
  const float m[2] = {lg::quant_stat(mx[0], quant), lg::quant_stat(mx[1], quant)};

  // pass 2: the same S again, p, sum p and P.V (mma.cuh:tf32_pv; P is fp32,
  // its cast to the fp32 V type the identity)
  float ps[2] = {0.f, 0.f};
  float pv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
  fetch(0, true);
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) fetch(c + 1, true);
    land(c);
    float s[NT][4];
    scores(s, c);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = lg::quant_stat(expf(s[n][e] - m[e / 2]), quant);
        s[n][e] = p;
        ps[e / 2] += dir1 ? lg::round_to<float>(p) : p;  // direction 1 sums P in the V type
      }
    }
    tf32_pv<NT>(pv, s, kbuf(c) + KC * FP + part * KW * FP, g, t4);
    __syncthreads();  // this buffer is free for the next fetch
  }
  ps[0] = quad_sum(ps[0]);
  ps[1] = quad_sum(ps[1]);
  meet_sums<C>(ps, pv, red, warp, g, t4);

  if (part != 0) return;  // the C warps of a row group hold the same rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gi = i0 + rg * 16 + g + 8 * i;
    if (gi >= Nq) continue;
    const float l = lg::quant_stat(ps[i], quant);
    const float den = l == 0.f ? 1.f : l;
    const bool zero = gi >= lq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = zero ? 0.f : pv[n][2 * i] / den, x1 = zero ? 0.f : pv[n][2 * i + 1] / den;
      store2(ob + (size_t)gi * H * D + n * 8 + 2 * t4, x0, x1);
    }
  }
}

// ---------------------------------------------------------------------------
// The BF16 kernel: both products on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

template <int G, int C, typename TO>
__global__ void __launch_bounds__(G * C * 32)
bidir_mma_kernel(Operand qk0, Operand qk1, Operand v0, Operand v1, const int* __restrict__ lens,
                 TO* __restrict__ o0, TO* __restrict__ o1, int N0, int N1, int H,
                 float scale, int quant, int blocks0, int aligned) {
  constexpr int BR = 16 * G;   // rows per block
  constexpr int KW = KC / C;   // keys of each chunk per warp
  constexpr int NT = KW / 8;   // S n-tiles per warp and chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* qs = reinterpret_cast<bf16_t*>(smem_raw);             // [BR][LD]
  bf16_t* kv = qs + BR * LD;                                    // [2][K, V][KC][LD]
  float* red = reinterpret_cast<float*>(kv + 2 * 2 * KC * LD);  // C > 1: [G * C][16][RS]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rg = warp / C, part = warp % C;  // 16-row group, share of each chunk's keys
  const int g = lane / 4, t4 = lane % 4;     // mma fragment row and column pair
  const int mi = lane / 8, mr = lane % 8;    // ldmatrix matrix and row of this lane
  const bool dir1 = blockIdx.x >= blocks0;   // image 1's rows attend to image 0
  const int b = blockIdx.z, h = blockIdx.y;
  const int i0 = (dir1 ? blockIdx.x - blocks0 : blockIdx.x) * BR;
  const Operand q = dir1 ? qk1 : qk0;
  const Operand k = dir1 ? qk0 : qk1;
  const Operand v = dir1 ? v0 : v1;
  const int Nq = dir1 ? N1 : N0, Nk = dir1 ? N0 : N1;
  const int lq = lens ? lens[2 * b + dir1] : Nq;
  // keys that can be live: the other image's valid prefix
  const int live_k = lens ? max(min(lens[2 * b + !dir1], Nk), 0) : Nk;
  TO* ob = (dir1 ? o1 : o0) + (size_t)b * Nq * H * D + h * D;  // row gi at ob + gi * H * D

  if (i0 >= lq || live_k == 0) {  // padded rows, or an empty kv side: zeros
    for (int i = tid; i < BR * D; i += blockDim.x)
      if (i0 + i / D < Nq) ob[(size_t)(i0 + i / D) * H * D + i % D] = lg::from_f<TO>(0.f);
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

  // chunks over the live keys, two buffers: chunk c + 1 copies while chunk c
  // is in use
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
  // columns past Nk are -inf (no part in max, p or sum p); columns at or
  // past the kv length are -1e30, as the reference sets them. Only the
  // chunk that holds the kv length or Nk has any; one select per element
  // (no branches) there.
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
    const bool ragged = c0 + KC > live_k;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + part * KW + n * 8 + 2 * t4 + (e & 1);
        float x = lg::quant_stat(s[n][e] * scale, quant);
        if (ragged) x = col >= Nk ? -INFINITY : (col >= live_k ? NEG : x);
        s[n][e] = x;
      }
    }
  };

  // pass 1: the row max
  float mx[2] = {-INFINITY, -INFINITY};
  fetch(0, false);
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
  const float m[2] = {lg::quant_stat(mx[0], quant), lg::quant_stat(mx[1], quant)};

  // pass 2: the same S again, p, sum p and P.V with P cast to bf16
  float ps[2] = {0.f, 0.f};
  float pv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
  fetch(0, true);
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) fetch(c + 1, true);
    land(c);
    float s[NT][4];
    scores(s, c);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = lg::quant_stat(expf(s[n][e] - m[e / 2]), quant);
        s[n][e] = p;
        ps[e / 2] += dir1 ? lg::round_to<bf16_t>(p) : p;  // direction 1 sums P in the V type
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
    const bool zero = gi >= lq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = zero ? 0.f : pv[n][2 * i] / den, x1 = zero ? 0.f : pv[n][2 * i + 1] / den;
      store2(ob + (size_t)gi * H * D + n * 8 + 2 * t4, x0, x1);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int G, int C>
int launch_tf32(Operand qk0, Operand qk1, Operand v0, Operand v1, const void* lens, void* o0,
                void* o1, int B, int N0, int N1, int H, float scale, int quant,
                cudaStream_t stream) {
  constexpr size_t smem = tf32_smem(C, TF32_STAGES, G);
  static const cudaError_t opt_in =  // above 48 KB: opt in once
      cudaFuncSetAttribute(bidir_tf32_kernel<G, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  constexpr int BR = 16 * G;
  const int aligned = aligned16(qk0) && aligned16(qk1) && aligned16(v0) && aligned16(v1);
  const int blocks0 = (N0 + BR - 1) / BR, blocks1 = (N1 + BR - 1) / BR;
  dim3 grid(blocks0 + blocks1, H, B);
  bidir_tf32_kernel<G, C><<<grid, G * C * 32, smem, stream>>>(
      qk0, qk1, v0, v1, static_cast<const int*>(lens), static_cast<float*>(o0),
      static_cast<float*>(o1), N0, N1, H, scale, quant, blocks0, aligned);
  return static_cast<int>(cudaGetLastError());
}

template <int G, int C, typename TO>
int launch_mma(Operand qk0, Operand qk1, Operand v0, Operand v1, const void* lens, void* o0,
               void* o1, int B, int N0, int N1, int H, float scale, int quant,
               cudaStream_t stream) {
  constexpr size_t smem = mma_smem(C, 2, G);
  static const cudaError_t opt_in =  // above 48 KB: opt in once
      smem > 48 * 1024
          ? cudaFuncSetAttribute(bidir_mma_kernel<G, C, TO>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem))
          : cudaSuccess;
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  constexpr int BR = 16 * G;
  const int aligned = aligned16(qk0) && aligned16(qk1) && aligned16(v0) && aligned16(v1);
  const int blocks0 = (N0 + BR - 1) / BR, blocks1 = (N1 + BR - 1) / BR;
  dim3 grid(blocks0 + blocks1, H, B);
  bidir_mma_kernel<G, C, TO><<<grid, G * C * 32, smem, stream>>>(
      qk0, qk1, v0, v1, static_cast<const int*>(lens), static_cast<TO*>(o0),
      static_cast<TO*>(o1), N0, N1, H, scale, quant, blocks0, aligned);
  return static_cast<int>(cudaGetLastError());
}

// either kernel's block (mma.cuh:batch_plan): one pair's split, and up to
// sixteen warps while BIDIR_FILL_BLOCKS blocks remain
inline void bidir_plan(int B, int H, int N0, int N1, int& G, int& C) {
  batch_plan(B, H, N0, N1, BIDIR_FILL_BLOCKS, BIDIR_FILL_BLOCKS, G, C);
}

int launch_fp32(Operand qk0, Operand qk1, Operand v0, Operand v1, const void* lens, void* o0,
                void* o1, int B, int N0, int N1, int H, float scale, int quant, cudaStream_t s) {
  int G, C;
  bidir_plan(B, H, N0, N1, G, C);
  auto run = C == 1   ? launch_tf32<4, 1>
             : C == 2 ? (G == 2 ? launch_tf32<2, 2> : launch_tf32<4, 2>)
             : (G == 1   ? launch_tf32<1, 4>
                : G == 2 ? launch_tf32<2, 4>
                         : launch_tf32<4, 4>);
  return run(qk0, qk1, v0, v1, lens, o0, o1, B, N0, N1, H, scale, quant, s);
}

template <typename TO>
int launch_bf16(Operand qk0, Operand qk1, Operand v0, Operand v1, const void* lens, void* o0,
                void* o1, int B, int N0, int N1, int H, float scale, int quant, cudaStream_t s) {
  int G, C;
  bidir_plan(B, H, N0, N1, G, C);
  auto run = C == 1   ? launch_mma<4, 1, TO>
             : C == 2 ? (G == 2 ? launch_mma<2, 2, TO> : launch_mma<4, 2, TO>)
             : (G == 1   ? launch_mma<1, 4, TO>
                : G == 2 ? launch_mma<2, 4, TO>
                         : launch_mma<4, 4, TO>);
  return run(qk0, qk1, v0, v1, lens, o0, o1, B, N0, N1, H, scale, quant, s);
}

// operand modes (kernels/attention.py mirrors them)
enum Mode { FP32 = 0, BF16 = 1, BF16_F32_OUT = 2 };

}  // namespace

// qk0/v0: rows of N0, qk1/v1: rows of N1; head h of a row at columns
// [h*64, h*64 + 64), addressed by (batch, row) strides in elements. lens:
// (B, 2) int32 [n0, n1] or null (unmasked). o0: (B, N0, H*64) and o1:
// (B, N1, H*64), contiguous, in the mode's output type. mode: FP32 (fp32
// operands and out, bidir_tf32_kernel), BF16 (bf16 operands and out) or
// BF16_F32_OUT (bf16 operands, fp32 out; both bidir_mma_kernel), each at
// lg_bidir_plan's block.
extern "C" int lg_bidirectional_cross(
    const void* qk0, long long qk0_bs, long long qk0_rs, const void* qk1,
    long long qk1_bs, long long qk1_rs, const void* v0, long long v0_bs,
    long long v0_rs, const void* v1, long long v1_bs, long long v1_rs,
    const void* lens, void* o0, void* o1, int B, int N0, int N1, int H,
    float scale, int quant, int mode, void* stream) {
  const Operand a{qk0, qk0_bs, D, qk0_rs}, c{qk1, qk1_bs, D, qk1_rs}, w0{v0, v0_bs, D, v0_rs},
      w1{v1, v1_bs, D, v1_rs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case FP32:
      return launch_fp32(a, c, w0, w1, lens, o0, o1, B, N0, N1, H, scale, quant, s);
    case BF16:
      return launch_bf16<bf16_t>(a, c, w0, w1, lens, o0, o1, B, N0, N1, H, scale, quant, s);
    case BF16_F32_OUT:
      return launch_bf16<float>(a, c, w0, w1, lens, o0, o1, B, N0, N1, H, scale, quant, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// lg_bidirectional_cross's block at this shape, in every mode: out = {16-row
// groups, warps of a group splitting each chunk's keys} (the wrapper's
// bidir_plan is held against it). The split is one pair's at every batch.
extern "C" int lg_bidir_plan(int B, int H, int N0, int N1, int* out) {
  bidir_plan(B, H, N0, N1, out[0], out[1]);
  return 0;
}
