// Online-softmax multi-head attention over KV tiles: the per-block LightGlue
// path's self-attention (half-split RoPE on q and k) and, above 1024
// keypoints, each cross-attention direction; the generic (B, H, N, D)
// attention entry point; and the local step of ring attention.
//
// Replaces three TPU kernels of lightglue_tpu/kernels/attention.py with one
// kernel template addressed by strides:
//   fused_mha             wrapper :687, pallas_call :766, body :540-673
//                         ((B, N, H*D) activation layout, optional RoPE);
//   flash_attention       wrapper :197, pallas_call :264, body :71-184
//                         ((B, H, N, D) layout, no RoPE);
//   flash_attention_step  wrapper :422, pallas_call :507, body :303-415
//                         (STEP: (B, H, N, D), carries in and out).
//
// Contract (attention.py:123-176, :607-657): KV runs in tiles of block_k;
// per tile s = quant(Q.K^T * scale), columns >= kv_len become -1e30,
// m' = quant(max(m, rowmax s)), p = quant(exp(s - m')),
// c = quant(exp(m - m')), l' = quant(l * c + sum p) and
// acc' = quant(acc * c + P.V) with P cast to the V type and an fp32 sum; at
// the end out = acc / (l == 0 ? 1 : l) and rows >= q_len are 0. quant rounds
// through bf16 on the BF16 rung. Tiles that start at or past kv_len are
// skipped, so in a live tile m is a real maximum (no clamp) and kv_len == 0
// gives l = 0 and a zero output. m starts at -1e30. RoPE casts the freqs to
// the operand type and rounds each product and the sum (common.cuh:rope_pair).
// block_k is a runtime argument and sets the rounding points: m, l and acc
// round once per tile, after the max of the whole tile is known, never once
// per staged chunk (an online softmax per chunk computes another function).
//
// Bound on the H100: per head 4 * Nq * Nk * D FLOP against (Nq + 2 Nk) * D
// operands, so the tensor cores bound the 2048-keypoint calls (~9 us for the
// stacked self call, B = 2, H = 4, in bf16; ~52 us in fp32 at three TF32
// products a product); the ring step at 512-row stripes is bound by its
// fp32 carries' bytes, read and written once per step.
//
// The BF16 kernel (flash_wgmma_kernel) is built in Hopper's shape from
// hopper.cuh's pieces, as attention.cu's attention_wgmma_kernel is:
// - A 64-row tile of one head goes to `split` consumers, which take the
//   64-key chunks of each block_k tile, chunk c to consumer c % split. A
//   consumer is a warpgroup: S = Q.K^T is four wgmma m64n64k16 with Q and K
//   both K-major from shared memory in 128 B swizzle; P.V takes P from
//   registers, the S accumulator rounded to bf16 pairs (wgmma's register-A
//   form, as FlashAttention-3), and V as the MN-major B operand: bf16 in,
//   fp32 sums. A block has four consumer warpgroups and a producer
//   warpgroup, whose warp r's lane 0 feeds warpgroup r's ring of two slots
//   by TMA behind full / empty mbarriers (Q once; per tile K in pass 1, then
//   V, or K and V, in pass 2); setmaxnreg moves the producer's registers to
//   the consumers.
// - Chunks are tile-relative: chunk c of the tile at key base is the TMA
//   box at base + 64 c, so where block_k is not a multiple of 64 (1000, 120)
//   the box reaches into the next tile; those keys, and keys past Nk (zeros
//   from TMA), are -inf (no part in max, p or sum p). Rows past Nq arrive as
//   zeros and are not stored. With lengths, chunks wholly past kv_len are
//   neither loaded nor computed (their p is exactly 0 and the tile's max a
//   live key's, so that is exact).
// - Two passes per block_k tile: pass 1 the tile's row max, after which the
//   consumers meet (in shared memory, across a cluster through distributed
//   shared memory) and each forms m' and c; pass 2 p, sum p and P.V. At
//   bf16 stats pass 1 keeps each chunk's rounded s in shared memory (STORE,
//   block_k <= MAX_STORED_K) and pass 2 reads it back and streams V alone:
//   s is rounded by the contract, so that is exact and saves pass 2's
//   Q.K^T and K; at fp32 stats (MIXED) or a longer tile pass 2 recomputes S
//   with the same instructions (bit for bit the same). Because acc rounds
//   once per tile, the consumers then meet once per tile: each block's
//   consumer threads own eight outputs of its rows, add the consumers'
//   partial sums p and P.V in a fixed order (Split, below) and update l and
//   acc (kept in shared memory) with __fmul_rn / __fadd_rn, rounded once.
// - The split reads one batch entry's shape (heads, Nq) and never the
//   batch: 8 where one entry's tiles, two blocks each, fit the card's SMs
//   (the ring's 512-row stripes, 960 keypoints, the TP shards), else 4
//   (2048 keypoints at four heads already give 128 tiles). A split of 8 runs
//   as a cluster of two blocks a tile, one consumer a warpgroup, while the
//   launch's blocks fit the SMs, else as one block a tile whose warpgroups
//   run two consumers each, one after the other: both add the same values in
//   one order (a consumer's chunks in order; q_c = p_c + p_{c + 4}, then
//   q_0 .. q_3 in order), so the batch only picks the form and adds blocks,
//   and a pair's rows are the same at any batch. A split of 4 is one block a
//   tile at every batch.
// - At bf16 stats s and p round in pairs, one packed conversion
//   (cvt.rn.bf16x2) for two values, and p's packed word is P.V's operand.
// - Q, K and V are read through rank-4 tensor maps (head_map): fused_mha's
//   (B, N, H*64) column slices at row strides 3E, 2E or E, flash_attention's
//   and the step's (B, H, N, 64) by strides. TMA needs 16 B bases and
//   strides: the wrappers raise on an operand it cannot address. The maps
//   are __grid_constant__ parameters, so a CUDA graph captures them by value.
// - RoPE (fused_mha self-attention) runs once, in rope_kernel, over q and k
//   into a bf16 scratch the wrapper allocates; the attention kernel then
//   reads rotated rows. Rotating K in every block that reads it cost more
//   than the attention itself at N = 2048.
// - The output type TO is bf16 (the BF16 rung) or fp32 (MIXED: bf16
//   operands, fp32 stats, an fp32 out, attention.py's out_dtype): the same
//   instructions up to the final store, which rounds to TO or does not.
//
// The FP32 kernel (flash_tf32_kernel, the fp32 rung and fp32 operands with
// bf16 stats) runs the same two-pass design on the tensor cores in 3xTF32:
// one TF32 product keeps about three decimal digits and misses the fp32
// gate of 1e-4, so each operand x is split into hi and lo = x - hi and
// every product is hi*lo + lo*hi + hi*hi on mma.sync m16n8k8, fp32 sums
// (the small terms first, lo*lo dropped), as conv3x3.cu's fp32 model conv
// does, but split by truncation (mma.cuh:split_tf32_rz: hi = x with its low
// 13 bits cleared, lo passed as it is, two instructions where rounding with
// cvt.rna takes several; 1.1-1.4x faster by shape,
// scripts/tune_torch_fp32_flash.py).
// - Q is split once into (hi, lo) A fragments kept in registers for the
//   whole KV loop (64 registers); S stays in registers, and the same two
//   passes per block_k tile keep the rounding points.
// - K and V stage as raw fp32 in 64-key chunks through a two-buffer
//   cp.async ring (pass 1 K only), rows at a 68-float pitch (mma.cuh:FP)
//   so that a warp's 32-bit fragment loads fall in 32 banks (there is no
//   ldmatrix for 32-bit elements); each element is split as its B fragment
//   loads. ~85-106 KB a block, two blocks an SM.
// - P goes from the S accumulator into the A operand of P.V without a
//   shuffle: for tf32 m16n8k8 the accumulator holds columns 2 t4, 2 t4 + 1
//   where A wants k = t4, t4 + 4, but the order of keys within a k step
//   does not change the sum, so slot t4 takes key 2 t4 and slot t4 + 4 key
//   2 t4 + 1, and V's B fragment is read at those two keys. P is split in
//   registers (its cast to the fp32 V type is the identity).
// - Its block pieces are mma.cuh's tf32_q_frags, tf32_scores, tf32_pv,
//   meet_max and meet_sums, shared with attention.cu's and bidir_cross.cu's
//   fp32 kernels.
// - A block holds G 16-row groups of C warps: one pair's split
//   (fill_row_groups, G * C = 4), or two or four times its groups where the
//   batch's launch still gives 256 blocks (mma.cuh:batch_plan), so the
//   512-row ring stripes still fill the card; tf32_smem (mma.cuh) is its
//   shared memory; kernels/attention.py:flash_plan mirrors both.
// - RoPE (fused_mha self-attention) runs once, in rope_kernel<float>, into
//   an fp32 scratch, every product and sum rounded in fp32.
//
// STEP (the ring step, attention.py:303-415) starts m, l and acc from the
// fp32 carries instead of -1e30, 0, 0, masks the columns at their global
// ids col0 + j against the GLOBAL kv_len (tiles past kv_len - col0 are
// skipped), and writes the three carries back in fp32 instead of
// finalising. Its row rule is the reference's, at the reference's stripe
// of block_q rows (not at this kernel's block, whose 64-row tile may span
// stripes): with lengths, a stripe runs only if row0 + its first row <
// q_len and one tile of the block is live, and the rows of a stripe that
// does not run pass their carries through unchanged. A block (a tile, in
// the bf16 kernel) with no running row only copies its carries.

#include <math.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace lg;  // Operand, row_ptr and the tensor-core helpers (mma.cuh)

constexpr int D = HD;  // head dim
constexpr float NEG = -1e30f;

struct Out {
  void* ptr;
  long long bs, hs, rs;
};

// The ring step's carries (STEP only): m/l (B, H, Nq, 1) and acc
// (B, H, Nq, D), fp32 and contiguous; row0/col0 are the global ids of q's
// first row and k's first column, block_q the reference's q stripe.
struct Carries {
  const float* m_in;
  const float* l_in;
  const float* acc_in;
  float* m_out;
  float* l_out;
  float* acc_out;
  int row0, col0, block_q;
};

// ---------------------------------------------------------------------------
// The FP32 kernel: both products on the tensor cores in 3xTF32 (m16n8k8)
// ---------------------------------------------------------------------------

template <bool STEP, int G, int C>
__global__ void __launch_bounds__(G * C * 32, G * C > WARPS ? 1 : 2)
flash_tf32_kernel(Operand q, Operand k, Operand v, Out o, Carries cy,
                  const int* __restrict__ lens, int Nq, int Nk, float scale, int block_k,
                  int quant, int aligned) {
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
  const int lq = lens ? lens[2 * b] : Nq;
  const int lk = lens ? lens[2 * b + 1] : Nk;
  const int col0 = STEP ? cy.col0 : 0;
  int num_kv = Nk / block_k;
  if (lens) num_kv = min(num_kv, ((STEP ? max(lk - col0, 0) : lk) + block_k - 1) / block_k);
  const size_t cbase = ((size_t)b * gridDim.y + h) * Nq + i0;  // STEP: carry row of i0

  auto runs = [&](int r) {  // STEP: does row r's stripe of block_q rows run?
    return lens == nullptr ||
           (cy.row0 + (i0 + r) / cy.block_q * cy.block_q < lq && num_kv > 0);
  };
  if (STEP) {
    bool any = false;
    for (int r = 0; r < BR && i0 + r < Nq; ++r) any = any || runs(r);
    if (!any) {  // no row of this block runs: the carries pass through
      for (int i = tid; i < BR * D; i += blockDim.x)
        if (i0 + i / D < Nq) cy.acc_out[cbase * D + i] = cy.acc_in[cbase * D + i];
      if (tid < BR && i0 + tid < Nq) {
        cy.m_out[cbase + tid] = cy.m_in[cbase + tid];
        cy.l_out[cbase + tid] = cy.l_in[cbase + tid];
      }
      return;
    }
  }
  float* out = STEP ? nullptr : static_cast<float*>(o.ptr) + b * o.bs + h * o.hs;
  if (!STEP && i0 >= lq) {  // a stripe wholly past q_len: zeros
    for (int i = tid; i < BR * D; i += blockDim.x)
      if (i0 + i / D < Nq) out[(long long)(i0 + i / D) * o.rs + i % D] = 0.f;
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

  // this thread's rows: rg * 16 + g (fragment elements 0, 1) and + 8 (2, 3)
  const int row[2] = {rg * 16 + g, rg * 16 + g + 8};
  float m[2], l[2], acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool carried = STEP && i0 + row[i] < Nq;
    m[i] = carried ? cy.m_in[cbase + row[i]] : NEG;
    l[i] = carried ? cy.l_in[cbase + row[i]] : 0.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float2 a = make_float2(0.f, 0.f);
      if (carried)
        a = *reinterpret_cast<const float2*>(cy.acc_in + (cbase + row[i]) * D + n * 8 + 2 * t4);
      acc[n][2 * i] = a.x;
      acc[n][2 * i + 1] = a.y;
    }
  }

  // Two chunk buffers: each pass copies chunk c + 1 while chunk c is in use
  // (pass 1 K only, pass 2 K and V).
  const int nc = (block_k + KC - 1) / KC;  // chunks per tile
  auto kbuf = [&](int c) { return kv + (c & 1) * 2 * KC * FP; };
  auto fetch = [&](int base, int c, bool with_v) {
    const int jn = min(KC, block_k - c * KC);
    stage_rows(kbuf(c), k, b, h, base + c * KC, KC, jn, aligned);
    if (with_v) stage_rows(kbuf(c) + KC * FP, v, b, h, base + c * KC, KC, jn, aligned);
    cp_async_commit();
  };
  auto land = [&](int c) {  // chunk c has landed (chunk c + 1 may still be in flight)
    if (c + 1 < nc)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
  };
  // s = quant(Q.K^T * scale) over this warp's KW keys of chunk c
  // (mma.cuh:tf32_scores); masking as the bf16 kernel's
  auto scores = [&](float (&s)[NT][4], int base, int c) {
    tf32_scores<NT>(s, qh, ql, kbuf(c) + part * KW * FP, g, t4);
    const int jn = block_k - c * KC;      // keys of this chunk in the tile (may exceed KC)
    const int gc = col0 + base + c * KC;  // global column of the chunk's first key
    const bool ragged = jn < KC || (lens != nullptr && gc + KC > lk);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = part * KW + n * 8 + 2 * t4 + (e & 1);
        s[n][e] = ragged && (j >= jn || (lens != nullptr && gc + j >= lk))
                      ? (j >= jn ? -INFINITY : NEG)
                      : lg::quant_stat(s[n][e] * scale, quant);
      }
    }
  };

  for (int t = 0; t < num_kv; ++t) {
    const int base = t * block_k;

    // pass 1: the row max of the whole tile
    float mx[2] = {-INFINITY, -INFINITY};
    fetch(base, 0, false);
    for (int c = 0; c < nc; ++c) {
      if (c + 1 < nc) fetch(base, c + 1, false);  // the buffer of chunk c - 1
      land(c);
      float s[NT][4];
      scores(s, base, c);
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
    float mn[2], cf[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mn[i] = lg::quant_stat(fmaxf(m[i], mx[i]), quant);
      cf[i] = lg::quant_stat(expf(m[i] - mn[i]), quant);
    }

    // pass 2: the same S again, p, sum p and P.V (mma.cuh:tf32_pv)
    float ps[2] = {0.f, 0.f};
    float pv[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
    fetch(base, 0, true);
    for (int c = 0; c < nc; ++c) {
      if (c + 1 < nc) fetch(base, c + 1, true);
      land(c);
      float s[NT][4];
      scores(s, base, c);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = lg::quant_stat(expf(s[n][e] - mn[e / 2]), quant);
          ps[e / 2] += s[n][e];
        }
      }
      tf32_pv<NT>(pv, s, kbuf(c) + KC * FP + part * KW * FP, g, t4);
      __syncthreads();  // this buffer is free for the next fetch
    }
    ps[0] = quad_sum(ps[0]);
    ps[1] = quad_sum(ps[1]);
    meet_sums<C>(ps, pv, red, warp, g, t4);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = lg::quant_stat(__fadd_rn(__fmul_rn(l[i], cf[i]), ps[i]), quant);
      m[i] = mn[i];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = lg::quant_stat(__fadd_rn(__fmul_rn(acc[n][e], cf[e / 2]), pv[n][e]), quant);
  }

  if (part != 0) return;  // the C warps of a row group hold the same rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gi = i0 + row[i];
    if (gi >= Nq) continue;
    if (STEP) {  // the carries out; a row whose stripe does not run passes through
      const size_t at = cbase + row[i];
      const bool live = runs(row[i]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const size_t ai = at * D + n * 8 + 2 * t4;
        *reinterpret_cast<float2*>(cy.acc_out + ai) =
            live ? make_float2(acc[n][2 * i], acc[n][2 * i + 1])
                 : *reinterpret_cast<const float2*>(cy.acc_in + ai);
      }
      if (t4 == 0) {
        cy.m_out[at] = live ? m[i] : cy.m_in[at];
        cy.l_out[at] = live ? l[i] : cy.l_in[at];
      }
      continue;
    }
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float x0 = acc[n][2 * i] / den, x1 = acc[n][2 * i + 1] / den;
      if (gi >= lq) x0 = x1 = 0.f;
      store2(out + (long long)gi * o.rs + n * 8 + 2 * t4, x0, x1);
    }
  }
}
// ---------------------------------------------------------------------------
// The BF16 kernel: warpgroups on wgmma, fed by TMA rings
// ---------------------------------------------------------------------------

constexpr int WGS = 4;             // consumer warpgroups of a block
constexpr int STAGES = 2;          // chunk slots of each warpgroup's ring
constexpr int TILE = 64 * D;       // elements of a 64 x 64 box (8 KB in bf16)
constexpr int TILE_BYTES = 2 * TILE;
constexpr int PART_BYTES = 4 * 64 * D;  // a consumer's fp32 P.V partial, 64 x 64
constexpr int CLUSTER_SMS = 132;   // clusters of two blocks a tile while their blocks fit the SMs
constexpr int MAX_STORED_K = 1024;  // the largest block_k whose s pass 1 keeps (bf16 stats)
// registers: a block of WGS + 1 warpgroups, one an SM, launches at 96 a
// thread; setmaxnreg gives the producer's to the consumers
constexpr int LAUNCH_REGS = 65536 / ((WGS + 1) * 128) / 8 * 8;
constexpr int PRODUCER_REGS = 32;
constexpr int CONSUMER_REGS = (LAUNCH_REGS * (WGS + 1) - PRODUCER_REGS) / WGS / 8 * 8;
static_assert(PRODUCER_REGS + WGS * CONSUMER_REGS <= (WGS + 1) * LAUNCH_REGS, "register budget");

// The launch of one shape (kernels/attention.py:flash_plan mirrors it):
// `split` consumers take a 64-row tile's chunks, 8 where one batch entry's
// tiles, two blocks each, fit the card's SMs, else 4 (never the batch: it
// orders a row's sums); a split of 8 runs as clusters of two blocks while
// the whole launch's blocks fit the SMs, else as one block a tile; bf16
// stats keep pass 1's s where the tile fits (block_k <= MAX_STORED_K).
struct WgPlan {
  int split, cluster, store;
};
inline int flash_split(int H, int Nq) {
  return 2ll * H * ((Nq + 63) / 64) <= CLUSTER_SMS ? 8 : 4;
}
inline WgPlan wgmma_plan(int B, int H, int Nq, int block_k, int quant) {
  const int split = flash_split(H, Nq);
  return {split, split == 8 && 2ll * B * H * ((Nq + 63) / 64) <= CLUSTER_SMS,
          quant && block_k <= MAX_STORED_K};
}

// Shared memory of a block, bytes: Q; each warpgroup's region, its ring of
// STAGES slots (K, or K and V where pass 2 recomputes S, V alone where it
// reads stored S), then its chunks' rounded s (STORE, bf16 pairs: a
// warpgroup's chunks of a tile at block_k <= MAX_STORED_K), where the
// first consumer's P.V partial goes once pass 2 has read them, or room for
// that partial; the block's rows of acc and l (fp32); the warpgroups'
// partial row max and sum p; the block's row max; each row's correction and
// max; the barriers (Q, then each ring's full and empty slots); 1 KB to
// align the tiles to 1024 B (the swizzle atom).
template <bool STORE, int CLUSTER>
struct Smem {
  static constexpr int KEPT = MAX_STORED_K / 64 / (WGS * CLUSTER);  // stored chunks of a warpgroup
  static constexpr size_t SLOT = STORE ? TILE_BYTES : 2 * TILE_BYTES;
  // in a region: the kept s ([KEPT][16][128] u32) or the partial
  static constexpr size_t PART_AT = SLOT * STAGES;
  static constexpr size_t REGION = PART_AT + (STORE ? (size_t)KEPT * TILE_BYTES : PART_BYTES);
  static constexpr size_t Q = 0;
  static constexpr size_t REGIONS = Q + TILE_BYTES;
  static constexpr size_t ACC = REGIONS + REGION * WGS;  // [64 / CLUSTER][64] fp32
  static constexpr size_t LS = ACC + sizeof(float) * 64 / CLUSTER * D;  // [64 / CLUSTER]
  static constexpr size_t MAX = LS + sizeof(float) * 64 / CLUSTER;
  static constexpr size_t SUM = MAX + sizeof(float) * WGS * 64;
  static constexpr size_t CMAX = SUM + sizeof(float) * WGS * 64;
  static constexpr size_t CF = CMAX + sizeof(float) * 64;
  static constexpr size_t MS = CF + sizeof(float) * 64;
  static constexpr size_t BARS = MS + sizeof(float) * 64;
  static constexpr size_t BYTES = BARS + sizeof(uint64_t) * (1 + 2 * WGS * STAGES) + 1024;
  static_assert(PART_BYTES <= REGION - PART_AT, "a P.V partial fits its region");
  static_assert(BYTES <= 232448, "a block fits the SM's shared memory");
};
constexpr size_t wgmma_smem(bool store, bool cluster) {
  return store ? (cluster ? Smem<true, 2>::BYTES : Smem<true, 1>::BYTES)
               : (cluster ? Smem<false, 2>::BYTES : Smem<false, 1>::BYTES);
}

// A 64 x 64 fp32 partial in the accumulator's own order: thread tid's
// float2 pair e / 2 (accumulator elements e, e + 1) at [e / 2][tid], so a
// warpgroup stores it at fixed offsets without bank conflicts, and columns
// c8 .. c8 + 7 of a row (n-tile c8 / 8, the quad of its row's lanes) lie
// together: their float index is part_at(row, c8)
__device__ __forceinline__ int part_at(int row, int c8) {
  return 2 * ((2 * (c8 / 8) + row % 16 / 8) * 128 + row / 16 * 32 + row % 8 * 4);
}

// A 64-row tile of one head: SPLIT = WGS * CLUSTER * VIRT consumers in one
// block or (CLUSTER = 2) a cluster of two, which take chunk c of each
// block_k tile if c % SPLIT is theirs. Consumer gc of a block of rank k runs
// on warpgroup gc % WGS: gc = v * WGS * CLUSTER + k * WGS + wg for its v-th
// consumer (VIRT a warpgroup, one after the other). Each block has a
// producer warpgroup (lane 0 of warp r feeds warpgroup r's ring by TMA) and
// WGS consumer warpgroups. Per tile the consumers meet three times: the row
// max after pass 1; the partial sums p and P.V after pass 2, which each
// block's consumer threads add for its share of the rows (q_c = p_c +
// p_{c + WGS} for a split of 8, then q_0 .. q_3 in order; the same bits in
// either form) into l and acc, rounded once; and once those are read, before
// the regions they were read from are written again. In a cluster the
// meetings are cluster barriers, at which the producer's lanes take their
// turn as they go (before each fill, every barrier the consumers pass before
// they read it).
template <bool STEP, typename TO, bool STORE, int CLUSTER, int VIRT>
__global__ void __launch_bounds__((WGS + 1) * 128, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, int hrows, Out o, Carries cy,
                   const int* __restrict__ lens, int Nq, int Nk, float scale, int block_k,
                   int quant) {
  using L = Smem<STORE, CLUSTER>;
  constexpr int SPLIT = WGS * CLUSTER * VIRT;  // consumers of a tile
  constexpr int OWN = L::KEPT / VIRT;          // stored chunks of one consumer
  extern __shared__ __align__(1024) unsigned char wg_raw[];
  unsigned char* const smem_raw = align1024(wg_raw);
  bf16_t* const qs = reinterpret_cast<bf16_t*>(smem_raw + L::Q);
  float* const acc_s = reinterpret_cast<float*>(smem_raw + L::ACC);    // [64 / CLUSTER][64]
  float* const l_s = reinterpret_cast<float*>(smem_raw + L::LS);       // [64 / CLUSTER]
  float* const red_max = reinterpret_cast<float*>(smem_raw + L::MAX);  // [WGS][64]
  float* const red_sum = reinterpret_cast<float*>(smem_raw + L::SUM);  // [WGS][64]
  float* const cmax = reinterpret_cast<float*>(smem_raw + L::CMAX);    // [64]
  float* const cf_s = reinterpret_cast<float*>(smem_raw + L::CF);      // [64]
  float* const m_s = reinterpret_cast<float*>(smem_raw + L::MS);       // [64]
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem_raw + L::BARS);
  uint64_t* const qbar = bars;
  auto region = [&](int r) { return smem_raw + L::REGIONS + L::REGION * r; };
  auto slot = [&](int r, int s) {  // warpgroup r's slot s
    return reinterpret_cast<bf16_t*>(region(r) + L::SLOT * s);
  };
  auto part = [&](int r) { return reinterpret_cast<float*>(region(r) + L::PART_AT); };
  auto full = [&](int r, int s) { return bars + 1 + r * STAGES + s; };
  auto empty = [&](int r, int s) { return bars + 1 + WGS * STAGES + r * STAGES + s; };

  const int rank = CLUSTER > 1 ? cluster_rank() : 0;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x / CLUSTER * 64;
  const int lq = lens ? lens[2 * b] : Nq;
  // the keys of this KV block before the global kv_len (every key without
  // lengths): tiles that start past them are skipped, their columns -1e30
  const int live = lens ? max(lens[2 * b + 1] - (STEP ? cy.col0 : 0), 0) : Nk;
  const int num_kv = min(Nk / block_k, (live + block_k - 1) / block_k);
  const int nc = (block_k + 63) / 64;  // chunks of a tile
  // the chunks of tile t that hold a live key (chunks past them are neither
  // loaded nor computed: their p is 0 and the tile's max a live key's)
  auto chunks = [&](int t) { return min(nc, (max(live - t * block_k, 0) + 63) / 64); };
  const size_t cbase = ((size_t)b * gridDim.y + h) * Nq + i0;  // STEP: carry row of i0
  constexpr int half = 64 / CLUSTER;  // the rows a block writes: rows0 ..
  const int rows0 = rank * half;

  auto runs = [&](int r) {  // STEP: does tile row r's stripe of block_q rows run?
    return lens == nullptr ||
           (cy.row0 + (i0 + r) / cy.block_q * cy.block_q < lq && num_kv > 0);
  };
  if (STEP) {
    bool any = false;
    for (int r = 0; r < 64 && i0 + r < Nq; ++r) any = any || runs(r);
    if (!any) {  // no row of this tile runs (the whole cluster): the carries pass through
      for (int i = threadIdx.x; i < half * D; i += blockDim.x) {
        const size_t at = cbase + rows0 + i / D;
        if (i0 + rows0 + i / D < Nq) cy.acc_out[at * D + i % D] = cy.acc_in[at * D + i % D];
      }
      if (threadIdx.x < half && i0 + rows0 + threadIdx.x < Nq) {
        const size_t at = cbase + rows0 + threadIdx.x;
        cy.m_out[at] = cy.m_in[at];
        cy.l_out[at] = cy.l_in[at];
      }
      return;
    }
  }
  TO* const out = STEP ? nullptr : static_cast<TO*>(o.ptr) + b * o.bs + h * o.hs;
  if (!STEP && i0 >= lq) {  // a tile wholly past q_len (the whole cluster): zeros
    for (int i = threadIdx.x; i < half * D; i += blockDim.x) {
      const int gi = i0 + rows0 + i / D;
      if (gi < Nq) out[(long long)gi * o.rs + i % D] = lg::from_f<TO>(0.f);
    }
    return;
  }
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int r = 0; r < WGS; ++r)
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full(r, s), 1);
        mbar_init(empty(r, s), 4);  // one arrival per consumer warp
      }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  // warpgroup w's v-th consumer: its first chunk of a tile
  auto first = [&](int v, int w) { return v * WGS * CLUSTER + rank * WGS + w; };
  if (wg == WGS) {  // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    // lane 0 of producer warp r feeds warpgroup r's ring, so no ring waits
    // behind another; warp 0's also loads Q. The other lanes exit.
    const int r = threadIdx.x % 128 / 32;
    if (threadIdx.x % 32 == 0) {
      // a box of rows [row, row + 64) of head h of map m (bit m of hrows:
      // its rank-4 map runs (64, H, N, B), else (64, N, H, B))
      auto load = [&](void* dst, const CUtensorMap* map, int m, uint64_t* bar, int row) {
        if ((hrows >> m) & 1)
          tma_load(dst, map, bar, 0, h, row, b);
        else
          tma_load(dst, map, bar, 0, row, h, b);
      };
      int arrived = 0;  // cluster barriers this lane has arrived at
      auto reach = [&](int n) {  // arrive at every cluster barrier before the n-th
        if constexpr (CLUSTER > 1) {
          for (; arrived < n; ++arrived) {
            if (arrived) cluster_wait();
            cluster_arrive();
          }
        }
      };
      if (r == 0) {
        tma_prefetch(&qmap);
        tma_prefetch(&kmap);
        tma_prefetch(&vmap);
        mbar_expect_tx(qbar, TILE_BYTES);
        load(qs, &qmap, 0, qbar, i0);
      }
      // per tile, pass 1 streams K, pass 2 K and V (V alone with stored S):
      // the chunks of warpgroup r's consumers, one consumer's after the
      // other, as its ring's fills i = 0, 1, ...; the consumers read pass p
      // of tile t past 3 t + p meetings (three a tile)
      int i = 0;
      for (int t = 0; t < num_kv; ++t) {
        const int base = t * block_k, nct = chunks(t);
        for (int pass = 0; pass < 2; ++pass) {
          reach(3 * t + pass);
          for (int v = 0; v < VIRT; ++v) {
            for (int j = first(v, r); j < nct; j += SPLIT, ++i) {
              const int s = i % STAGES;
              mbar_wait(empty(r, s), ((i / STAGES) & 1) ^ 1);
              mbar_expect_tx(full(r, s), TILE_BYTES * (pass && !STORE ? 2 : 1));
              if (!pass || !STORE) load(slot(r, s), &kmap, 1, full(r, s), base + j * 64);
              if (pass) load(slot(r, s) + (STORE ? 0 : TILE), &vmap, 2, full(r, s), base + j * 64);
            }
          }
        }
      }
      reach(3 * num_kv);
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int tid = threadIdx.x % 128, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;  // accumulator row and column pair
  const int row0 = 16 * warp + g;         // this thread's rows: row0 and row0 + 8
  // this thread's outputs (a block's consumer threads, one each): row
  // rows0 + own_row() of the tile, columns own_col() .. + 7, in acc_s; the
  // row's l in l_s, kept by its column-0 owner
  const bool owner = threadIdx.x < half * (D / 8);
  auto own_row = [&]() { return static_cast<int>(threadIdx.x) / (D / 8); };
  auto own_col = [&]() { return static_cast<int>(threadIdx.x) % (D / 8) * 8; };

  // the carries: m per accumulator row, l and acc per output (STEP: from
  // the carries in)
  float m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    m[r] = STEP && i0 + row0 + 8 * r < Nq ? cy.m_in[cbase + row0 + 8 * r] : NEG;
  if (owner) {
    const int row = own_row(), c8 = own_col();
    const bool carried = STEP && i0 + rows0 + row < Nq;
    float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (carried) load8(cy.acc_in + (cbase + rows0 + row) * D + c8, a, true);
    store8(acc_s + row * D + c8, a);
    if (c8 == 0) l_s[row] = carried ? cy.l_in[cbase + rows0 + row] : 0.f;
  }

  // s = quant(Q.K^T * scale) over keys k0 .. k0 + 2 E - 1 of the chunk in
  // slot s of this ring, chunk j of the tile at key base: with E = 32
  // accumulators the whole chunk (four wgmma m64n64k16), with E = 16 the
  // half at k0 = 0 or 32 (four m64n32k16; pass 2 recomputes S in halves, so
  // S and P.V's accumulators fit the registers together, and pass 1 takes
  // the same instructions, so both see the same bits). Keys past the tile
  // (the next tile's, where block_k is not a multiple of 64, and past Nk)
  // are -inf, keys at or past kv_len -1e30; only a chunk that holds the
  // tile's end or kv_len has any. This thread's E / 2 columns (bit 2 n + h:
  // column k0 + 8 n + 2 t4 + h) are classified while the product runs.
  auto scores = [&](auto& sc, int s, int base, int j, int k0) {
    constexpr int E = std::extent_v<std::remove_reference_t<decltype(sc)>>;
    const bf16_t* ks = slot(wg, s) + k0 * D;
    fence_operand(sc);
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < D / 16; ++k16) {
      if constexpr (E == 32)
        wgmma_m64n64<0>(sc, kmajor_desc(qs, k16), kmajor_desc(ks, k16), k16);
      else
        wgmma_m64n32<0>(sc, kmajor_desc(qs, k16), kmajor_desc(ks, k16), k16);
    }
    wgmma_commit();
    const int c0 = j * 64 + k0;  // base + key: the key in this KV block
    const bool ragged = c0 + 2 * E > block_k || base + c0 + 2 * E > live;
    unsigned pad = 0u, dead = 0u;
    if (ragged) {
#pragma unroll
      for (int bit = 0; bit < E / 2; ++bit) {
        const int key = c0 + 8 * (bit / 2) + 2 * t4 + (bit & 1);
        if (key >= block_k)
          pad |= 1u << bit;
        else if (base + key >= live)
          dead |= 1u << bit;
      }
    }
    wgmma_wait<0>();
    fence_operand(sc);
#pragma unroll
    for (int k = 0; k < E / 2; ++k) {  // a pair of a row's columns at a time
      float x[2] = {sc[2 * k] * scale, sc[2 * k + 1] * scale};
      if (STORE || quant) {  // bf16 stats: both rounded in one packed conversion
        const unsigned w = pack_bf16(x[0], x[1]);
        x[0] = __uint_as_float(w << 16), x[1] = __uint_as_float(w & 0xffff0000u);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int bit = 2 * (k / 2) + e;  // column k0 + 8 (k / 2) + 2 t4 + e
        sc[2 * k + e] = (pad >> bit) & 1u ? -INFINITY : ((dead >> bit) & 1u ? NEG : x[e]);
      }
    }
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(wg, s));
  };
  auto meet = [&]() {  // every consumer thread of the block, or of the cluster
    if constexpr (CLUSTER > 1) {
      cluster_arrive();
      cluster_wait();
    } else {
      bar_sync(1, WGS * 128);
    }
  };

  mbar_wait(qbar, 0);

  unsigned* const store = reinterpret_cast<unsigned*>(region(wg) + L::PART_AT);
  float* const mine = part(wg);  // [16][128] float2, part_at
  int i = 0;                     // fills of this ring consumed
  for (int t = 0; t < num_kv; ++t) {
    const int base = t * block_k, nct = chunks(t);

    // pass 1: the tile's row max over this warpgroup's chunks (and with
    // STORE each chunk's s, packed in bf16 pairs: word k of this thread
    // holds s[2 k], s[2 k + 1], at [chunk][k][tid]; consumer v's chunks from
    // chunk v * OWN); a warpgroup's consumers one after the other
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll 1
    for (int v = 0; v < VIRT; ++v) {
      int c = v * OWN;  // this chunk's place in the store
      for (int j = first(v, wg); j < nct; j += SPLIT, ++i, ++c) {
        const int s = i % STAGES;
        mbar_wait(full(wg, s), (i / STAGES) & 1);
        if constexpr (STORE) {
          float sc[32];
          scores(sc, s, base, j, 0);
          release(s);
#pragma unroll
          for (int e = 0; e < 32; ++e) mx[(e / 2) & 1] = fmaxf(mx[(e / 2) & 1], sc[e]);
#pragma unroll
          for (int k = 0; k < 16; ++k)
            store[(c * 16 + k) * 128 + tid] = pack_bf16(sc[2 * k], sc[2 * k + 1]);
        } else {  // in halves, as pass 2 recomputes them
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float sc[16];
            scores(sc, s, base, j, 32 * hf);
#pragma unroll
            for (int e = 0; e < 16; ++e) mx[(e / 2) & 1] = fmaxf(mx[(e / 2) & 1], sc[e]);
          }
          release(s);
        }
      }
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    if (t4 == 0) {
      red_max[wg * 64 + row0] = mx[0];
      red_max[wg * 64 + row0 + 8] = mx[1];
    }
    bar_sync(1, WGS * 128);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int w = 0; w < WGS; ++w) mx[r] = fmaxf(mx[r], red_max[w * 64 + row0 + 8 * r]);
      if (CLUSTER > 1 && wg == 0 && t4 == 0) cmax[row0 + 8 * r] = mx[r];  // this block's row max
    }
    if (CLUSTER > 1) {
      cluster_arrive();
      cluster_wait();
    }
    float cf[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int k = 0; k < CLUSTER; ++k)
        if (k != rank) mx[r] = fmaxf(mx[r], ld_dsmem(dsmem(cmax + row0 + 8 * r, k)));
      const float mn = lg::quant_stat(fmaxf(m[r], mx[r]), quant);
      cf[r] = lg::quant_stat(expf(m[r] - mn), quant);
      m[r] = mn;
      if (wg == 0 && t4 == 0) {  // the owners of the block's rows read them after pass 2
        cf_s[row0 + 8 * r] = cf[r];
        m_s[row0 + 8 * r] = mn;
      }
    }

    // pass 2, consumer by consumer: p against m', sum p and P.V with P cast
    // to bf16 from the S accumulator (wgmma's register-A form); with two
    // consumers a warpgroup the first one's partial waits in shared memory
    // and the second's is added to it (q_c = p_c + p_{c + WGS})
#pragma unroll 1
    for (int v = 0; v < VIRT; ++v) {
      float ps[2] = {0.f, 0.f};
      float pv[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) pv[e] = 0.f;
      int c = v * OWN;
      for (int j = first(v, wg); j < nct; j += SPLIT, ++i, ++c) {
        const int s = i % STAGES;
        mbar_wait(full(wg, s), (i / STAGES) & 1);
        if constexpr (STORE) {
          float sc[32];  // the rounded s of pass 1
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            const unsigned w = store[(c * 16 + k) * 128 + tid];
            sc[2 * k] = __uint_as_float(w << 16);
            sc[2 * k + 1] = __uint_as_float(w & 0xffff0000u);
          }
          // bf16 stats: p in pairs (one row, columns 2 t4, 2 t4 + 1) rounded
          // in one packed conversion, which is also P.V's A operand (keys
          // 16 kk.. of the chunk: n-tiles 2 kk and 2 kk + 1)
          unsigned pa[D / 16][4];
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            const int r = k & 1;  // row0 or row0 + 8
            const unsigned w = pack_bf16(expf(sc[2 * k] - m[r]), expf(sc[2 * k + 1] - m[r]));
            ps[r] += __uint_as_float(w << 16);
            ps[r] += __uint_as_float(w & 0xffff0000u);
            pa[k / 4][k % 4] = w;
          }
          const bf16_t* vs = slot(wg, s);
          fence_operand(pv);
          wgmma_fence();
#pragma unroll
          for (int k16 = 0; k16 < 4; ++k16)
            wgmma_m64n64_rs(pv, pa[k16], mnmajor_desc(vs, 128, k16), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_operand(pv);
#pragma unroll
          for (int k16 = 0; k16 < 4; ++k16) fence_operand(pa[k16]);
        } else {  // S again, in halves of 32 keys, and their P.V
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float sc[16];
            scores(sc, s, base, j, 32 * hf);
            unsigned pa[2][4];  // keys 32 hf + 16 kk..: this half's two k16 steps
            if (quant) {  // bf16 stats: p rounded in pairs, as above
#pragma unroll
              for (int k = 0; k < 8; ++k) {
                const int r = k & 1;
                const unsigned w =
                    pack_bf16(expf(sc[2 * k] - m[r]), expf(sc[2 * k + 1] - m[r]));
                ps[r] += __uint_as_float(w << 16);
                ps[r] += __uint_as_float(w & 0xffff0000u);
                pa[k / 4][k % 4] = w;
              }
            } else {  // fp32 stats: p as it is, cast to bf16 for P.V
#pragma unroll
              for (int e = 0; e < 16; ++e) {
                sc[e] = expf(sc[e] - m[(e / 2) & 1]);
                ps[(e / 2) & 1] += sc[e];
              }
#pragma unroll
              for (int k = 0; k < 8; ++k) pa[k / 4][k % 4] = pack_bf16(sc[2 * k], sc[2 * k + 1]);
            }
            const bf16_t* vs = slot(wg, s) + TILE;
            fence_operand(pv);
            wgmma_fence();
#pragma unroll
            for (int k16 = 0; k16 < 2; ++k16)
              wgmma_m64n64_rs(pv, pa[k16], mnmajor_desc(vs, 128, 2 * hf + k16), 1);
            wgmma_commit();
            wgmma_wait<0>();
            fence_operand(pv);
#pragma unroll
            for (int k16 = 0; k16 < 2; ++k16) fence_operand(pa[k16]);
          }
        }
        release(s);
      }
      ps[0] = quad_sum(ps[0]);
      ps[1] = quad_sum(ps[1]);
      // this consumer's partial into shared memory (the second one's added
      // to the first's, which this thread wrote there itself); with STORE
      // it overwrites the first consumer's s
      if (v == 0) bar_sync(2 + wg, 128);  // every warp of this group has read the s there
      float2* const pairs = reinterpret_cast<float2*>(mine) + tid;
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        float2 x = make_float2(pv[e], pv[e + 1]);
        if (v > 0) x = make_float2(pairs[e / 2 * 128].x + x.x, pairs[e / 2 * 128].y + x.y);
        pairs[e / 2 * 128] = x;
      }
      if (t4 == 0) {
        float* at = red_sum + wg * 64 + row0;
        at[0] = v > 0 ? at[0] + ps[0] : ps[0];
        at[8] = v > 0 ? at[8] + ps[1] : ps[1];
      }
    }

    // each owner adds the partials of its eight outputs in Split's order and
    // updates them: l' = quant(l c + sum p), acc' = quant(acc c + P.V)
    meet();
    if (owner) {
      const int row = own_row(), c8 = own_col(), irow = rows0 + row;
      float ls[WGS * CLUSTER];  // every block's partial sums p and P.V of these outputs
      float4 lo[WGS * CLUSTER], hi[WGS * CLUSTER];
#pragma unroll
      for (int k = 0; k < CLUSTER; ++k) {
#pragma unroll
        for (int w = 0; w < WGS; ++w) {
          const float* src = part(w) + part_at(irow, c8);
          if constexpr (CLUSTER > 1) {  // all loads first
            ls[k * WGS + w] = ld_dsmem(dsmem(red_sum + w * 64 + irow, k));
            lo[k * WGS + w] = ld_dsmem4(dsmem(src, k));
            hi[k * WGS + w] = ld_dsmem4(dsmem(src + 4, k));
          } else {
            ls[w] = red_sum[w * 64 + irow];
            lo[w] = *reinterpret_cast<const float4*>(src);
            hi[w] = *reinterpret_cast<const float4*>(src + 4);
          }
        }
      }
      float sum = 0.f, x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < WGS; ++c) {  // q_c = p_c + p_{c + WGS} (in a cluster: block 1's c)
        float q = ls[c], y[8] = {lo[c].x, lo[c].y, lo[c].z, lo[c].w,
                                 hi[c].x, hi[c].y, hi[c].z, hi[c].w};
        if constexpr (CLUSTER > 1) {
          const int d = WGS + c;
          q += ls[d];
          y[0] += lo[d].x, y[1] += lo[d].y, y[2] += lo[d].z, y[3] += lo[d].w;
          y[4] += hi[d].x, y[5] += hi[d].y, y[6] += hi[d].z, y[7] += hi[d].w;
        }
        sum += q;
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] += y[e];
      }
      const float c = cf_s[irow];
      if (c8 == 0) l_s[row] = lg::quant_stat(__fadd_rn(__fmul_rn(l_s[row], c), sum), quant);
      float a[8];
      load8(acc_s + row * D + c8, a, true);
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] = lg::quant_stat(__fadd_rn(__fmul_rn(a[e], c), x[e]), quant);
      store8(acc_s + row * D + c8, a);
    }
    meet();  // the partials, sums and stored s are read: the next tile may write them
  }

  if (num_kv == 0) bar_sync(1, WGS * 128);  // no meeting: the rows' l written by their owners
  if (!owner) return;
  const int row = own_row(), c8 = own_col(), irow = rows0 + row, gi = i0 + irow;
  if (gi >= Nq) return;
  float a[8];
  load8(acc_s + row * D + c8, a, true);
  const float l = l_s[row];
  if (STEP) {  // the carries out; a row whose stripe does not run passes through
    const size_t at = cbase + irow;
    const bool live = runs(irow);
    if (!live) load8(cy.acc_in + at * D + c8, a, true);
    store8(cy.acc_out + at * D + c8, a);
    if (c8 == 0) {
      cy.m_out[at] = live ? m_s[irow] : cy.m_in[at];
      cy.l_out[at] = live ? l : cy.l_in[at];
    }
    return;
  }
  const float den = l == 0.f ? 1.f : l;
#pragma unroll
  for (int e = 0; e < 8; ++e) a[e] = gi < lq ? a[e] / den : 0.f;
  store8(out + (long long)gi * o.rs + c8, a);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <bool STEP, int G, int C>
int launch_tf32(Operand q, Operand k, Operand v, Out o, Carries cy, const void* lens, int B,
                int H, int Nq, int Nk, float scale, int block_k, int quant, cudaStream_t stream) {
  constexpr size_t smem = tf32_smem(C, TF32_STAGES, G);
  static const cudaError_t opt_in =  // above 48 KB: opt in once
      cudaFuncSetAttribute(flash_tf32_kernel<STEP, G, C>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  constexpr int BR = 16 * G;
  const int aligned = aligned16(q) && aligned16(k) && aligned16(v);
  dim3 grid((Nq + BR - 1) / BR, H, B);
  flash_tf32_kernel<STEP, G, C><<<grid, G * C * 32, smem, stream>>>(
      q, k, v, o, cy, static_cast<const int*>(lens), Nq, Nk, scale, block_k, quant, aligned);
  return static_cast<int>(cudaGetLastError());
}

// the fp32 kernel's blocks: one pair's four-warp block (G * C = 4), or two
// or four of its row groups in one block of eight or sixteen warps
template <bool STEP>
int launch_fp32(Operand q, Operand k, Operand v, Out o, Carries cy, const void* lens, int B,
                int H, int Nq, int Nk, float scale, int block_k, int quant, int row_groups,
                int col_split, cudaStream_t s) {
  decltype(&launch_tf32<STEP, 4, 1>) run = nullptr;
  switch (row_groups * 8 + col_split) {
    case 4 * 8 + 1: run = launch_tf32<STEP, 4, 1>; break;
    case 2 * 8 + 2: run = launch_tf32<STEP, 2, 2>; break;
    case 4 * 8 + 2: run = launch_tf32<STEP, 4, 2>; break;
    case 1 * 8 + 4: run = launch_tf32<STEP, 1, 4>; break;
    case 2 * 8 + 4: run = launch_tf32<STEP, 2, 4>; break;
    case 4 * 8 + 4: run = launch_tf32<STEP, 4, 4>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return run(q, k, v, o, cy, lens, B, H, Nq, Nk, scale, block_k, quant, s);
}

// One head's rows of a bf16 operand, (B, H, N, 64) by (batch, head, row)
// strides in elements (an activation (B, N, H*64) has head stride 64), as a
// rank-4 tensor map read in 64 x 64 boxes in 128 B swizzle: (64, H, N, B)
// where heads lie inside a row (hrows = 1), else (64, N, H, B), so the
// strides grow outward. A dimension of one takes a stride past the others.
int head_map(CUtensorMap* map, const Operand& o, int B, int H, int rows, int& hrows) {
  hrows = H > 1 && o.hs < o.rs;
  const long long hs = H > 1 ? o.hs : (long long)rows * o.rs;
  const long long bs = B > 1 ? o.bs : (hrows ? (long long)rows * o.rs : (long long)H * hs);
  if (!tma_aligned(o.ptr, 2 * o.rs, 2 * hs) || (2 * bs) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[4] = {D, (cuuint64_t)(hrows ? H : rows), (cuuint64_t)(hrows ? rows : H),
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(2 * (hrows ? hs : o.rs)),
                                 (cuuint64_t)(2 * (hrows ? o.rs : hs)), (cuuint64_t)(2 * bs)};
  const cuuint32_t box[4] = {D, hrows ? 1u : 64u, hrows ? 64u : 1u, 1};
  return tma_map(map, o.ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, dims, strides, box, 128);
}

template <bool STEP, typename TO, bool STORE, int CLUSTER, int VIRT>
int launch_wgmma(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, int hrows,
                 Out o, Carries cy, const void* lens, int B, int H, int Nq, int Nk, float scale,
                 int block_k, int quant, cudaStream_t stream) {
  constexpr size_t smem = Smem<STORE, CLUSTER>::BYTES;
  auto kernel = flash_wgmma_kernel<STEP, TO, STORE, CLUSTER, VIRT>;
  static const cudaError_t opt_in =  // above 48 KB: opt in once
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = CLUSTER;
  cluster[0].val.clusterDim.y = cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER * ((Nq + 63) / 64), H, B);
  cfg.blockDim = dim3((WGS + 1) * 128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = CLUSTER > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, qm, km, vm, hrows, o, cy,
                                             static_cast<const int*>(lens), Nq, Nk, scale,
                                             block_k, quant));
}

// The bf16 kernel at wgmma_plan's launch, which the caller's plan
// (row_groups, col_split, stages: kernels/attention.py:flash_plan) must be:
// four 16-row groups (a 64-row tile), the split, the ring's slots
template <bool STEP, typename TO>
int launch_bf16(Operand q, Operand k, Operand v, Out o, Carries cy, const void* lens, int B,
                int H, int Nq, int Nk, float scale, int block_k, int quant, int row_groups,
                int col_split, int stages, cudaStream_t s) {
  const WgPlan p = wgmma_plan(B, H, Nq, block_k, quant);
  if (row_groups != 4 || col_split != p.split || stages != STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  int hq, hk, hv;
  const int errs[3] = {head_map(&qm, q, B, H, Nq, hq), head_map(&km, k, B, H, Nk, hk),
                       head_map(&vm, v, B, H, Nk, hv)};
  for (const int err : errs)
    if (err) return err;
  // the forms: a cluster of two blocks, one consumer a warpgroup (split 8);
  // one block, two consumers a warpgroup (split 8) or one (split 4)
  auto run = p.store ? (p.cluster          ? launch_wgmma<STEP, TO, true, 2, 1>
                        : p.split == 8     ? launch_wgmma<STEP, TO, true, 1, 2>
                                           : launch_wgmma<STEP, TO, true, 1, 1>)
                     : (p.cluster          ? launch_wgmma<STEP, TO, false, 2, 1>
                        : p.split == 8     ? launch_wgmma<STEP, TO, false, 1, 2>
                                           : launch_wgmma<STEP, TO, false, 1, 1>);
  return run(qm, km, vm, hq | hk << 1 | hv << 2, o, cy, lens, B, H, Nq, Nk, scale, block_k, quant,
             s);
}

// operand modes (kernels/attention.py mirrors them): FP32 (fp32 operands and
// out), BF16 (bf16 operands and out), BF16_F32_OUT (bf16 operands, fp32 out;
// not the ring step, which writes fp32 carries in every mode)
enum Mode { FP32 = 0, BF16 = 1, BF16_F32_OUT = 2 };

// Both kernels at the plan of kernels/attention.py:flash_plan: bf16
// operands on wgmma (flash_wgmma_kernel; the plan is (4, split, STAGES)),
// fp32 operands in 3xTF32 (row_groups 4, 2 or 1 16-row groups per block of
// col_split warps each, TF32_STAGES buffers). A caller with RoPE has rotated
// q and k first.
template <bool STEP>
int launch(Operand q, Operand k, Operand v, Out o, Carries cy, const void* lens, int B, int H,
           int Nq, int Nk, float scale, int block_k, int quant, int row_groups, int col_split,
           int stages, int mode, cudaStream_t s) {
  if (mode == FP32) {
    if (stages != TF32_STAGES) return static_cast<int>(cudaErrorInvalidValue);
    return launch_fp32<STEP>(q, k, v, o, cy, lens, B, H, Nq, Nk, scale, block_k, quant,
                             row_groups, col_split, s);
  }
  if (mode == BF16)  // the ring step writes fp32 carries: its TO is never stored
    return launch_bf16<STEP, std::conditional_t<STEP, float, bf16_t>>(
        q, k, v, o, cy, lens, B, H, Nq, Nk, scale, block_k, quant, row_groups, col_split, stages,
        s);
  if constexpr (!STEP) {
    if (mode == BF16_F32_OUT)
      return launch_bf16<false, float>(q, k, v, o, cy, lens, B, H, Nq, Nk, scale, block_k,
                                       quant, row_groups, col_split, stages, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// fused_mha: q (B, Nq, H*64), k/v (B, Nk, H*64) rows addressed by (batch,
// row) strides in elements, head h at columns [h*64, h*64 + 64). freqs:
// (B, 2, Nk, 64) fp32 [cos; sin] (Nq == Nk) or null for no RoPE. lens:
// (B, 2) int32 [q_len, kv_len] or null (unmasked). out: (B, Nq, H*64) in
// the mode's output type. row_groups, col_split, stages: the plan
// (kernels/attention.py:flash_plan). rot: with RoPE, (2, B, Nq, H*64)
// scratch of the operands' type for the rotated q and k.
extern "C" int lg_fused_mha(const void* q, long long q_bs, long long q_rs,
                            const void* k, long long k_bs, long long k_rs,
                            const void* v, long long v_bs, long long v_rs,
                            const void* freqs, const void* lens, void* out, void* rot,
                            int B, int Nq, int Nk, int H, float scale,
                            int block_k, int quant, int row_groups, int col_split, int stages,
                            int mode, void* stream) {
  Operand oq{q, q_bs, D, q_rs}, ok{k, k_bs, D, k_rs};
  const Operand ov{v, v_bs, D, v_rs};
  const Out oo{out, (long long)Nq * H * D, D, (long long)H * D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (freqs) {
    const float* f = static_cast<const float*>(freqs);
    const long long bs = (long long)Nq * H * D;
    cudaError_t err;
    if (mode == FP32) {
      err = rope_qk(oq, ok, f, static_cast<float*>(rot), B, Nq, H, s);
      ok = Operand{static_cast<float*>(rot) + B * bs, bs, D, (long long)H * D};
    } else {
      err = rope_qk(oq, ok, f, static_cast<bf16_t*>(rot), B, Nq, H, s);
      ok = Operand{static_cast<bf16_t*>(rot) + B * bs, bs, D, (long long)H * D};
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    oq = Operand{rot, bs, D, (long long)H * D};
  }
  return launch<false>(oq, ok, ov, oo, Carries{}, lens, B, H, Nq, Nk, scale, block_k, quant,
                       row_groups, col_split, stages, mode, s);
}

// flash_attention: q (B, H, Nq, 64), k/v (B, H, Nk, 64) addressed by (batch,
// head, row) strides in elements. lens as above. out: (B, H, Nq, 64) in the
// mode's output type.
extern "C" int lg_flash_attention(
    const void* q, long long q_bs, long long q_hs, long long q_rs,
    const void* k, long long k_bs, long long k_hs, long long k_rs,
    const void* v, long long v_bs, long long v_hs, long long v_rs,
    const void* lens, void* out, int B, int H, int Nq, int Nk, float scale,
    int block_k, int quant, int row_groups, int col_split, int stages, int mode,
    void* stream) {
  const Operand oq{q, q_bs, q_hs, q_rs}, ok{k, k_bs, k_hs, k_rs},
      ov{v, v_bs, v_hs, v_rs};
  const Out oo{out, (long long)H * Nq * D, (long long)Nq * D, D};
  return launch<false>(oq, ok, ov, oo, Carries{}, lens, B, H, Nq, Nk, scale, block_k, quant,
                       row_groups, col_split, stages, mode, static_cast<cudaStream_t>(stream));
}

// flash_attention_step: q (B, H, Nq, 64), k/v (B, H, Nk, 64) addressed by
// (batch, head, row) strides in elements; m/l (B, H, Nq, 1) and acc
// (B, H, Nq, 64) fp32 contiguous carries in and out (distinct buffers). lens:
// (B, 2) int32 GLOBAL [q_len, kv_len] or null (unmasked: every stripe runs).
// mode: FP32 or BF16 (the operands' type).
extern "C" int lg_flash_attention_step(
    const void* q, long long q_bs, long long q_hs, long long q_rs,
    const void* k, long long k_bs, long long k_hs, long long k_rs,
    const void* v, long long v_bs, long long v_hs, long long v_rs,
    const void* m_in, const void* l_in, const void* acc_in, void* m_out,
    void* l_out, void* acc_out, const void* lens, int B, int H, int Nq, int Nk,
    int row0, int col0, float scale, int block_q, int block_k, int quant,
    int row_groups, int col_split, int stages, int mode, void* stream) {
  const Operand oq{q, q_bs, q_hs, q_rs}, ok{k, k_bs, k_hs, k_rs},
      ov{v, v_bs, v_hs, v_rs};
  const Out none{nullptr, 0, 0, 0};
  const Carries cy{static_cast<const float*>(m_in), static_cast<const float*>(l_in),
                   static_cast<const float*>(acc_in), static_cast<float*>(m_out),
                   static_cast<float*>(l_out), static_cast<float*>(acc_out),
                   row0, col0, block_q};
  return launch<true>(oq, ok, ov, none, cy, lens, B, H, Nq, Nk, scale, block_k, quant,
                      row_groups, col_split, stages, mode, static_cast<cudaStream_t>(stream));
}
// flash_attn.cu's launch at this shape in this mode (the wrapper's
// kernels/attention.py:flash_plan is held against it): out = {16-row groups
// a block (a tile), warps (FP32) or consumers (the bf16 modes) splitting each
// chunk's keys, K and V chunk buffers (FP32) or ring slots (bf16), blocks of
// the launch, dynamic shared memory in bytes, clusters of two blocks a tile,
// pass 1's s kept}. FP32: flash_tf32_kernel at mma.cuh:batch_plan's blocks;
// bf16: flash_wgmma_kernel at wgmma_plan's.
extern "C" int lg_flash_plan(int B, int H, int Nq, int block_k, int mode, int quant, int* out) {
  if (mode == FP32) {
    int G, C;
    batch_plan(B, H, Nq, 0, FILL_BLOCKS, FILL_BLOCKS, G, C);
    const int plan[7] = {G, C, TF32_STAGES, (Nq + 16 * G - 1) / (16 * G) * H * B,
                         static_cast<int>(tf32_smem(C, TF32_STAGES, G)), 0, 0};
    for (int i = 0; i < 7; ++i) out[i] = plan[i];
    return 0;
  }
  const WgPlan p = wgmma_plan(B, H, Nq, block_k, quant);
  const int plan[7] = {4, p.split, STAGES, (p.cluster ? 2 : 1) * ((Nq + 63) / 64) * H * B,
                       static_cast<int>(wgmma_smem(p.store, p.cluster)), p.cluster, p.store};
  for (int i = 0; i < 7; ++i) out[i] = plan[i];
  return 0;
}
