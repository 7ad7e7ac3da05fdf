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
// peak, B = 1, H = 4; ~6.5 us in fp32 at three TF32 products a product).
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
// - RoPE runs once, in mma.cuh's rope_kernel, over q and k into a scratch
//   of their type (lg_rope_qk, which the wrapper launches first); the
//   kernel then reads rotated rows. Rotating K in every block that reads it
//   cost more than the attention at N = 2048 (measured in flash_attn.cu).
// - The output type TO is bf16 (the BF16 and INT8 rungs) or fp32 (MIXED:
//   bf16 operands, fp32 stats, o.astype(fp32) with no rounding, :472/:559).
// - dir1 (the cross block's direction 1 at MIXED): the reference takes that
//   direction as the column softmax of the shared S and sums p after its
//   cast to the operand type (p1.astype(attn_dtype), then a ones-vector
//   product, :543-549), where direction 0 and self-attention sum fp32 p
//   (:464, :509). With dir1 the row sum takes round_to<bf16>(p), as
//   bidir_cross.cu's direction 1 does. At bf16 stats p is already bf16 and
//   the two rules agree.
// - A block has G 16-row groups of C warps each. One pair's shape picks C
//   so that one pair's grid of four-warp blocks still fills the card
//   (mma.cuh:fill_row_groups: at H = 4, N = 1024 one 16-row group, its
//   four warps splitting each chunk's keys, 256 blocks a pair); the split
//   warps' row max, sum p and P.V meet in shared memory, which changes only
//   the order of fp32 sums. The batch never changes C, so a pair's rows
//   come out the same in a batch of any size. It may change G: where the
//   batch's launch still gives FILL_BLOCKS blocks, two or four groups share
//   a block of eight or sixteen warps and each staged K and V chunk
//   (mma_plan; at B = 4, N = 1024: (4, 4), 256 blocks), which changes no
//   row's arithmetic.
//
// The FP32 kernel (attention_tf32_kernel: fp32 operands and out, with fp32
// or bf16 stats) runs the same two passes and the same contract on the
// tensor cores in 3xTF32: one TF32 product keeps about three decimal
// digits and misses the fp32 rung's 1e-4 gate, so every product is
// hi*lo + lo*hi + hi*hi of operands split by truncation
// (mma.cuh:split_tf32_rz) on mma.sync m16n8k8. It is flash_attn.cu's
// flash_tf32_kernel at one whole-row tile (block_k = Nk <= 1024), built from
// the same mma.cuh pieces: Q split once into register fragments
// (tf32_q_frags); S per chunk (tf32_scores), recomputed bit for bit in pass
// 2; P from the S accumulator into P.V's A operand unshuffled, V read at
// keys 2 t4 and 2 t4 + 1 (tf32_pv); K and V staged as raw fp32 at pitch FP
// in 64-key chunks through a two-stage cp.async ring and split as their
// fragments load; the split warps meet in shared memory (meet_max,
// meet_sums). Where the stack's contract differs from the flash kernel's,
// it keeps the bf16 kernel's items 1-5 above on the tf32 accumulator
// layout, whose element e of n-tile n is row g + 8 (e / 2), key
// 2 t4 + (e & 1) as in m16n8k16: so the clamp, the dead-column selects and
// the keep multiply are the bf16 kernel's lines. A block holds G 16-row
// groups of C warps each: the bf16 kernel's pair split C, and one pair's
// groups (fill_row_groups, G * C = 4), except where the whole launch still
// gives FILL_BLOCKS / 2 blocks with two or four times the groups: then they
// share a block of eight or sixteen warps (tf32_plan, mma.cuh:batch_plan;
// each group keeps its pair's split, so a row's sums keep their order),
// which halves (or quarters) the K and V reads
// through L2 a query row at the same warps an SM (at B = 1, H = 4,
// N = 1024: 1.96 against 2.45-2.50 ms per pair,
// scripts/tune_torch_fp32_stack_bidir.py on an H100 at 700 W). Its shared
// memory is mma.cuh:tf32_smem (kernels/layer_stack.py:attention_plan
// mirrors both, lg_attention_plan). RoPE runs first, in rope_kernel<float>,
// into an fp32 scratch.

#include <math.h>

#include "mma.cuh"

namespace {

using namespace lg;  // Operand, row_ptr and the tensor-core helpers (mma.cuh)

constexpr int D = HD;  // head dim
constexpr float NEG = -1e30f;
constexpr float DEAD = -5e29f;

// ---------------------------------------------------------------------------
// The FP32 kernel: both products on the tensor cores in 3xTF32 (m16n8k8)
// ---------------------------------------------------------------------------

template <bool KEEP, int G, int C>
__global__ void __launch_bounds__(G * C * 32, G * C > WARPS ? 1 : 2)
attention_tf32_kernel(Operand q, Operand k, Operand v, const int* __restrict__ len_q,
                      const int* __restrict__ len_kv, const float* __restrict__ keep_q,
                      const float* __restrict__ keep_kv, const float* __restrict__ exit_reg,
                      int layer, float* __restrict__ out, int Nq, int Nk, int H, float scale,
                      int quant, int dir1, int aligned) {
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
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * BR;
  if (exit_reg && !(exit_reg[b] > static_cast<float>(layer))) return;
  const bool masked = KEEP || len_q != nullptr;
  const int lq = (!KEEP && len_q) ? len_q[b] : Nq;
  // keys that can be live: every key under KEEP, the valid prefix with lengths
  const int live_k = (!KEEP && len_kv) ? max(min(len_kv[b], Nk), 0) : Nk;
  const float* kq = KEEP ? keep_q + (size_t)b * Nq : nullptr;
  const float* kk = KEEP ? keep_kv + (size_t)b * Nk : nullptr;
  float* ob = out + (size_t)b * Nq * H * D + h * D;  // row gi at ob + gi * H * D

  if (!KEEP && i0 >= lq) {  // a block wholly past q_len: zeros
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

  // chunks over the keys that can be live, two buffers: chunk c + 1 copies
  // while chunk c is in use (pass 1 K only, pass 2 K and V)
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
  // (mma.cuh:tf32_scores), masked as the bf16 kernel's: pad columns past
  // Nk are -inf, dead columns (keep < 0.5, or at or past kv_len) -1e30;
  // without keep masks only the chunk that holds kv_len or Nk has any
  auto scores = [&](float (&s)[NT][4], int c) {
    tf32_scores<NT>(s, qh, ql, kbuf(c) + part * KW * FP, g, t4);
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
  meet_max<C>(mx, red, warp, g, t4);
  float m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = lg::quant_stat(mx[i], quant);
    if (masked) m[i] = fmaxf(m[i], DEAD);
  }

  // pass 2: the same S again, p, sum p and P.V (mma.cuh:tf32_pv; P is fp32,
  // its cast to the fp32 V type the identity)
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
    const bool zero = !KEEP && masked && gi >= lq;
    const float keep = KEEP ? kq[gi] : 1.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float x0 = pv[n][2 * i] / den, x1 = pv[n][2 * i + 1] / den;
      if (KEEP) x0 *= keep, x1 *= keep;
      if (zero) x0 = x1 = 0.f;
      store2(ob + (size_t)gi * H * D + n * 8 + 2 * t4, x0, x1);
    }
  }
}

// ---------------------------------------------------------------------------
// The BF16 kernel: both products on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

template <bool KEEP, int G, int C, typename TO>
__global__ void __launch_bounds__(G * C * 32)
attention_mma_kernel(Operand q, Operand k, Operand v, const int* __restrict__ len_q,
                     const int* __restrict__ len_kv, const float* __restrict__ keep_q,
                     const float* __restrict__ keep_kv, const float* __restrict__ exit_reg,
                     int layer, TO* __restrict__ out, int Nq, int Nk, int H, float scale,
                     int quant, int dir1, int aligned) {
  constexpr int BR = 16 * G;   // rows per block
  constexpr int KW = KC / C;   // keys of each chunk per warp
  constexpr int NT = KW / 8;   // S n-tiles per warp and chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* qs = reinterpret_cast<bf16_t*>(smem_raw);                 // [BR][LD]
  bf16_t* kv = qs + BR * LD;                                        // [2][K, V][KC][LD]
  float* red = reinterpret_cast<float*>(kv + 2 * 2 * KC * LD);      // C > 1: [G * C][16][RS]

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
  TO* ob = out + (size_t)b * Nq * H * D + h * D;  // row gi at ob + gi * H * D

  if (!KEEP && i0 >= lq) {  // a block wholly past q_len: zeros
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
    const bool zero = !KEEP && masked && gi >= lq;
    const float keep = KEEP ? kq[gi] : 1.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float x0 = pv[n][2 * i] / den, x1 = pv[n][2 * i + 1] / den;
      if (KEEP) x0 *= keep, x1 *= keep;
      if (zero) x0 = x1 = 0.f;
      store2(ob + (size_t)gi * H * D + n * 8 + 2 * t4, x0, x1);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <bool KEEP, int G, int C>
int launch_tf32(Operand q, Operand k, Operand v, const void* len_q, const void* len_kv,
                const void* keep_q, const void* keep_kv, const void* exit_reg, int layer,
                void* out, int B, int Nq, int Nk, int H, float scale, int quant, int dir1,
                cudaStream_t stream) {
  constexpr size_t smem = tf32_smem(C, TF32_STAGES, G);
  static const cudaError_t opt_in =  // above 48 KB: opt in once
      cudaFuncSetAttribute(attention_tf32_kernel<KEEP, G, C>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int aligned = aligned16(q) && aligned16(k) && aligned16(v);
  dim3 grid((Nq + 16 * G - 1) / (16 * G), H, B);
  attention_tf32_kernel<KEEP, G, C><<<grid, G * C * 32, smem, stream>>>(
      q, k, v, static_cast<const int*>(len_q), static_cast<const int*>(len_kv),
      static_cast<const float*>(keep_q), static_cast<const float*>(keep_kv),
      static_cast<const float*>(exit_reg), layer, static_cast<float*>(out), Nq, Nk, H, scale,
      quant, dir1, aligned);
  return static_cast<int>(cudaGetLastError());
}

// The stack's block (mma.cuh:batch_plan, one pair's split at FILL_BLOCKS):
// the FP32 kernel grows its blocks while FILL_BLOCKS / 2 blocks
// remain (an fp32 block holds twice the bytes), so one pair of 1024 takes
// 128 eight-warp blocks; the bf16 kernel while FILL_BLOCKS remain, so one
// pair's launch is the four-warp one. At 8 pairs of 1024 the FP32 step took
// 22.5 ms with sixteen-warp blocks against 26.8 at eight, the BF16 step
// 10.9 with sixteen against 11.5 at eight (bench LightGlue 8x1024, an H100
// at 700 W, PERF.md section 6, PR 21).
inline void tf32_plan(int B, int H, int Nq, int& G, int& C) {
  batch_plan(B, H, Nq, 0, FILL_BLOCKS, FILL_BLOCKS / 2, G, C);
}
inline void mma_plan(int B, int H, int Nq, int& G, int& C) {
  batch_plan(B, H, Nq, 0, FILL_BLOCKS, FILL_BLOCKS, G, C);
}

template <bool KEEP>
int launch_fp32(Operand q, Operand k, Operand v, const void* len_q, const void* len_kv,
                const void* keep_q, const void* keep_kv, const void* exit_reg, int layer,
                void* out, int B, int Nq, int Nk, int H, float scale, int quant, int dir1,
                cudaStream_t s) {
  int G, C;
  tf32_plan(B, H, Nq, G, C);
  auto run = C == 1   ? launch_tf32<KEEP, 4, 1>
             : C == 2 ? (G == 2 ? launch_tf32<KEEP, 2, 2> : launch_tf32<KEEP, 4, 2>)
             : (G == 1   ? launch_tf32<KEEP, 1, 4>
                : G == 2 ? launch_tf32<KEEP, 2, 4>
                         : launch_tf32<KEEP, 4, 4>);
  return run(q, k, v, len_q, len_kv, keep_q, keep_kv, exit_reg, layer, out, B, Nq, Nk, H, scale,
             quant, dir1, s);
}

template <bool KEEP, int G, int C, typename TO>
int launch_mma(Operand q, Operand k, Operand v, const void* len_q, const void* len_kv,
               const void* keep_q, const void* keep_kv, const void* exit_reg, int layer,
               void* out, int B, int Nq, int Nk, int H, float scale, int quant, int dir1,
               cudaStream_t stream) {
  constexpr size_t smem = mma_smem(C, 2, G);
  static const cudaError_t opt_in =  // above 48 KB: opt in once
      smem > 48 * 1024
          ? cudaFuncSetAttribute(attention_mma_kernel<KEEP, G, C, TO>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem))
          : cudaSuccess;
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  constexpr int BR = 16 * G;
  const int aligned = aligned16(q) && aligned16(k) && aligned16(v);
  dim3 grid((Nq + BR - 1) / BR, H, B);
  attention_mma_kernel<KEEP, G, C, TO><<<grid, G * C * 32, smem, stream>>>(
      q, k, v, static_cast<const int*>(len_q), static_cast<const int*>(len_kv),
      static_cast<const float*>(keep_q), static_cast<const float*>(keep_kv),
      static_cast<const float*>(exit_reg), layer, static_cast<TO*>(out), Nq, Nk, H, scale,
      quant, dir1, aligned);
  return static_cast<int>(cudaGetLastError());
}

template <bool KEEP, typename TO>
int launch_bf16(Operand q, Operand k, Operand v, const void* len_q, const void* len_kv,
                const void* keep_q, const void* keep_kv, const void* exit_reg, int layer,
                void* out, int B, int Nq, int Nk, int H, float scale, int quant, int dir1,
                cudaStream_t s) {
  int G, C;
  mma_plan(B, H, Nq, G, C);
  auto run = C == 1   ? launch_mma<KEEP, 4, 1, TO>
             : C == 2 ? (G == 2 ? launch_mma<KEEP, 2, 2, TO> : launch_mma<KEEP, 4, 2, TO>)
             : (G == 1   ? launch_mma<KEEP, 1, 4, TO>
                : G == 2 ? launch_mma<KEEP, 2, 4, TO>
                         : launch_mma<KEEP, 4, 4, TO>);
  return run(q, k, v, len_q, len_kv, keep_q, keep_kv, exit_reg, layer, out, B, Nq, Nk, H, scale,
             quant, dir1, s);
}

// operand modes of lg_attention (kernels/layer_stack.py:attention mirrors them)
enum Mode { FP32 = 0, BF16 = 1, BF16_F32_OUT = 2 };

}  // namespace

// q: rows of Nq, k/v: rows of Nk; head h of a row at columns [h*64, h*64+64),
// addressed by (batch, row) strides in elements; with RoPE the caller has
// rotated q and k first (lg_rope_qk) and passes the rotated rows.
// len_q/len_kv: (B,) int32, both null for the unmasked variant.
// keep_q/keep_kv: (B, Nq)/(B, Nk) fp32 0/1 keep masks, both null or both set
// (then the lengths are ignored). exit_reg: (B,) fp32 or null; layer: the
// global layer index. out: (B, Nq, H*64). mode: FP32 (fp32 operands and out,
// attention_tf32_kernel at tf32_plan's blocks), BF16 (bf16 operands and out)
// or BF16_F32_OUT (bf16 operands, fp32 out), the last two
// attention_mma_kernel at mma.cuh:fill_row_groups' 16-row groups per block
// (one pair's shape)
// (kernels/layer_stack.py:attention_plan mirrors both). dir1: the row sum
// takes p rounded to the operand type (the cross block's direction 1).
extern "C" int lg_attention(const void* q, long long q_bs, long long q_rs,
                            const void* k, long long k_bs, long long k_rs,
                            const void* v, long long v_bs, long long v_rs,
                            const void* len_q, const void* len_kv, const void* keep_q,
                            const void* keep_kv, const void* exit_reg,
                            int layer, void* out, int B, int Nq, int Nk,
                            int H, float scale, int quant, int mode, int dir1,
                            void* stream) {
  const Operand oq{q, q_bs, D, q_rs}, ok{k, k_bs, D, k_rs}, ov{v, v_bs, D, v_rs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool keep = keep_q != nullptr;
  if (mode == FP32)
    return (keep ? launch_fp32<true> : launch_fp32<false>)(
        oq, ok, ov, len_q, len_kv, keep_q, keep_kv, exit_reg, layer, out, B, Nq, Nk, H, scale,
        quant, dir1, s);
  if (mode != BF16 && mode != BF16_F32_OUT) return static_cast<int>(cudaErrorInvalidValue);
  auto run = mode == BF16 ? (keep ? launch_bf16<true, bf16_t> : launch_bf16<false, bf16_t>)
                          : (keep ? launch_bf16<true, float> : launch_bf16<false, float>);
  return run(oq, ok, ov, len_q, len_kv, keep_q, keep_kv, exit_reg, layer, out, B, Nq, Nk, H,
             scale, quant, dir1, s);
}

// The self-attention's RoPE pre-pass: q and k ((B, N, H*64) rows of the
// mode's operand type, addressed by (batch, row) strides) rotated with freqs
// (B, 2, N, 64) fp32 into rot (2, B, N, H*64) of that type, which
// lg_attention then reads as q and k.
extern "C" int lg_rope_qk(const void* q, long long q_bs, long long q_rs, const void* k,
                          long long k_bs, long long k_rs, const void* freqs, void* rot, int B,
                          int N, int H, int mode, void* stream) {
  const Operand oq{q, q_bs, D, q_rs}, ok{k, k_bs, D, k_rs};
  const float* f = static_cast<const float*>(freqs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(mode == FP32 ? rope_qk(oq, ok, f, static_cast<float*>(rot), B, N, H, s)
                                       : rope_qk(oq, ok, f, static_cast<bf16_t*>(rot), B, N, H, s));
}

// The 16-row groups per block of lg_attention's bf16 kernel at one pair's
// shape, whatever the batch (the wrapper's plan and flash_plan are held
// against it).
extern "C" int lg_attention_row_groups(int H, int Nq) { return fill_row_groups(H, Nq); }

// lg_attention's block at this shape in this mode: out = {16-row groups,
// warps of a group splitting each chunk's keys, dynamic shared memory in
// bytes} (the wrapper's attention_plan is held against it).
extern "C" int lg_attention_plan(int B, int H, int Nq, int mode, int* out) {
  int G, C;
  (mode == FP32 ? tf32_plan : mma_plan)(B, H, Nq, G, C);
  out[0] = G;
  out[1] = C;
  out[2] = static_cast<int>(mode == FP32 ? tf32_smem(C, TF32_STAGES, G) : mma_smem(C, 2, G));
  return 0;
}
