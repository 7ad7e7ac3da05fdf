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
// the operand type and rounds each product and the sum (common.cuh:rope_rows).
// block_k is a runtime argument and sets the rounding points: m, l and acc
// round once per tile, after the max of the whole tile is known, never once
// per staged chunk (an online softmax per chunk computes another function).
//
// Bound on the H100: per head 4 * Nq * Nk * D FLOP against (Nq + 2 Nk) * D
// operands, so the tensor cores bound the 2048-keypoint calls (~9 us for the
// stacked self call, B = 2, H = 4); the ring step at 512-row stripes is
// bound by its fp32 carries' bytes, read and written once per step.
//
// The BF16 kernel (flash_mma_kernel) puts both products on the tensor cores:
// - mma.sync m16n8k16, bf16 in, fp32 sums, operands from shared memory by
//   ldmatrix (.trans for V). Each warp owns 16 query rows and keeps its Q
//   fragment (after RoPE) in registers for the whole KV loop; S stays in
//   registers, and P goes from the S accumulator layout into the A operand
//   of the P.V mma in registers, cast to bf16 there (p.astype(v.dtype)).
// - Two passes per block_k tile keep the per-tile rounding points without
//   a block_k-wide slab of S. Pass 1 computes S chunk by chunk and reduces
//   the tile's row max (over the 4 lanes of a quad, and over warps where
//   warps split the columns); pass 2 recomputes S with the same
//   instructions, so bit for bit the same, forms p, sums it and accumulates
//   P.V into a per-tile fp32 pv. Then l and acc update once, with
//   __fmul_rn/__fadd_rn so that no FMA the reference does not take is
//   contracted. Pass 2 costs 1.5x the product FLOPs, which the tensor cores
//   have to spare.
// - K and V stage in 64-key chunks with cp.async (16 B a thread,
//   neighbouring threads on neighbouring addresses): double-buffered, so the
//   next chunk's copy overlaps this chunk's mma, or, where the launch is one
//   wave and the tile fits (the ring step's 512 keys), the whole tile stays
//   resident and pass 2 reads it again. Rows are padded to 72 elements so
//   the eight row addresses of an ldmatrix fall in different banks. The
//   last chunk of a tile that is not a multiple of 64 (block_k 1000, 120,
//   ...) is zero-padded, and its pad columns take no part in max, p or sum p.
// - The copy, ldmatrix and mma helpers, the block layout and rope_kernel
//   are mma.cuh's, shared with the layer stack's attention.cu.
// - RoPE (fused_mha self-attention) runs once, in rope_kernel, over q and k
//   into a bf16 scratch the wrapper allocates; the attention kernel then
//   reads rotated rows. Rotating K in every block that reads it cost more
//   than the attention itself at N = 2048.
// - A block has 4 warps and 16 * 4 / C rows: with C = 1 each warp takes 16
//   rows and every key; with C = 2 or 4 (short stripes: the ring step at
//   512 rows would otherwise give 32 blocks for 132 SMs) the warps of a
//   16-row group split each chunk's columns, and the row max, sum p and pv
//   meet in shared memory. That changes only the order of fp32 sums. The
//   wrapper picks C and the buffers per shape (kernels/attention.py:
//   flash_plan).
//
// The FP32 kernel (flash_kernel, the fp32 rung) stays on the FMA units:
// TF32 mma keeps about three decimal digits and would miss the 1e-4 gate
// of the fp32 rung (3xTF32 is later work). One block per 16 query rows
// keeps a 16 x block_k slab of S in shared memory and stages K and V in
// 64-key chunks.
//
// STEP (the ring step, attention.py:303-415) starts m, l and acc from the
// fp32 carries instead of -1e30, 0, 0, masks the columns at their global
// ids col0 + j against the GLOBAL kv_len (tiles past kv_len - col0 are
// skipped), and writes the three carries back in fp32 instead of
// finalising. Its row rule is the reference's, at the reference's stripe
// of block_q rows (not at this kernel's block): with lengths, a stripe runs
// only if row0 + its first row < q_len and one tile of the block is live,
// and the rows of a stripe that does not run pass their carries through
// unchanged. A block with no running row only copies its carries.

#include <math.h>

#include "mma.cuh"

namespace {

using namespace lg;  // Operand, row_ptr and the tensor-core helpers (mma.cuh)

constexpr int D = HD;        // head dim
constexpr int BQ = 16;       // query rows per block
constexpr int THREADS = 256;
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
// The FP32 kernel: products on the FMA units
// ---------------------------------------------------------------------------

template <bool ROPE, bool STEP>
__global__ void __launch_bounds__(THREADS, 2)
flash_kernel(Operand q, Operand k, Operand v, Out o, Carries cy,
             const float* __restrict__ freqs, const int* __restrict__ lens,
             int Nq, int Nk, float scale, int block_k, int quant) {
  using T = float;
  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][D]
  float* kv = qs + BQ * D;          // [KC][D + 1]
  float* ss = kv + KC * (D + 1);    // [BQ][block_k]
  float* mrow = ss + BQ * block_k;  // [BQ] running max
  float* lrow = mrow + BQ;          // [BQ] running sum
  float* crow = lrow + BQ;          // [BQ] this tile's correction

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * BQ;
  const int lq = lens ? lens[2 * b] : Nq;
  const int lk = lens ? lens[2 * b + 1] : Nk;
  const int cj = tid % KC;  // this thread's key within a chunk / output column
  const int r0 = tid / KC;  // rows r0, r0 + 4, r0 + 8, r0 + 12
  T* out = static_cast<T*>(o.ptr) + b * o.bs + h * o.hs;
  const int col0 = STEP ? cy.col0 : 0;  // global id of k's first column
  int num_kv = Nk / block_k;
  if (lens) num_kv = min(num_kv, ((STEP ? max(lk - col0, 0) : lk) + block_k - 1) / block_k);
  const size_t cbase = ((size_t)b * gridDim.y + h) * Nq + i0;  // STEP: carry row of i0

  // STEP: does row r's stripe of block_q rows run (attention.py:359-361)?
  auto runs = [&](int r) {
    return lens == nullptr ||
           (cy.row0 + (i0 + r) / cy.block_q * cy.block_q < lq && num_kv > 0);
  };
  if (STEP) {
    bool any = false;
    for (int r = 0; r < BQ && i0 + r < Nq; ++r) any = any || runs(r);
    if (!any) {  // no row of this block runs: the carries pass through
#pragma unroll
      for (int rr = 0; rr < BQ / 4; ++rr) {
        const int r = r0 + 4 * rr;
        if (i0 + r < Nq) cy.acc_out[(cbase + r) * D + cj] = cy.acc_in[(cbase + r) * D + cj];
      }
      if (tid < BQ && i0 + tid < Nq) {
        cy.m_out[cbase + tid] = cy.m_in[cbase + tid];
        cy.l_out[cbase + tid] = cy.l_in[cbase + tid];
      }
      return;
    }
  }

  if (!STEP && i0 >= lq) {  // a stripe wholly past q_len: zeros
#pragma unroll
    for (int rr = 0; rr < BQ / 4; ++rr) {
      const int gi = i0 + r0 + 4 * rr;
      if (gi < Nq) out[(long long)gi * o.rs + cj] = lg::from_f<T>(0.f);
    }
    return;
  }

  const float* fb = ROPE ? freqs + (size_t)b * 2 * Nk * D : nullptr;
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    qs[i] = i0 + r < Nq ? lg::to_f(row_ptr<T>(q, b, h, i0 + r)[d]) : 0.f;
  }
  if (tid < BQ) {
    const bool carried = STEP && i0 + tid < Nq;
    mrow[tid] = carried ? cy.m_in[cbase + tid] : NEG;
    lrow[tid] = carried ? cy.l_in[cbase + tid] : 0.f;
  }
  __syncthreads();
  if (ROPE) {
    lg::rope_rows<T, D>(qs, D, min(BQ, Nq - i0), i0, fb, Nk);
    __syncthreads();
  }

  const int warp = tid / 32, lane = tid % 32;
  float acc[BQ / 4] = {};
  if (STEP) {
#pragma unroll
    for (int rr = 0; rr < BQ / 4; ++rr) {
      const int r = r0 + 4 * rr;
      if (i0 + r < Nq) acc[rr] = cy.acc_in[(cbase + r) * D + cj];
    }
  }
  for (int t = 0; t < num_kv; ++t) {
    const int base = t * block_k;

    // S = quant(Q.K^T * scale) over the tile, columns >= kv_len at -1e30
    for (int c0 = 0; c0 < block_k; c0 += KC) {
      const int jn = min(KC, block_k - c0);
      __syncthreads();  // the previous chunk, or the previous tile's P.V, is done
      for (int i = tid; i < KC * D; i += THREADS) {
        const int j = i / D, d = i % D;
        kv[j * (D + 1) + d] =
            j < jn ? lg::to_f(row_ptr<T>(k, b, h, base + c0 + j)[d]) : 0.f;
      }
      __syncthreads();
      if (ROPE) {
        lg::rope_rows<T, D>(kv, D + 1, jn, base + c0, fb, Nk);
        __syncthreads();
      }
      if (cj < jn) {
        const bool dead = lens != nullptr && col0 + base + c0 + cj >= lk;
#pragma unroll
        for (int rr = 0; rr < BQ / 4; ++rr) {
          const int r = r0 + 4 * rr;
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d)
            dot = fmaf(qs[r * D + d], kv[cj * (D + 1) + d], dot);
          ss[r * block_k + c0 + cj] = dead ? NEG : lg::quant_stat(dot * scale, quant);
        }
      }
    }
    __syncthreads();

    // per row: m', p, c and l' (one warp per 2 rows)
    for (int rr = 0; rr < 2; ++rr) {
      const int r = 2 * warp + rr;
      float* srow = ss + r * block_k;
      float mx = -INFINITY;
      for (int j = lane; j < block_k; j += 32) mx = fmaxf(mx, srow[j]);
      const float m_prev = mrow[r];
      const float m_new = lg::quant_stat(fmaxf(m_prev, lg::warp_max(mx)), quant);
      float sum = 0.f;
      for (int j = lane; j < block_k; j += 32) {
        const float p = lg::quant_stat(expf(srow[j] - m_new), quant);
        srow[j] = p;
        sum += p;
      }
      sum = lg::warp_sum(sum);
      if (lane == 0) {
        const float c = lg::quant_stat(expf(m_prev - m_new), quant);
        crow[r] = c;
        lrow[r] = lg::quant_stat(__fadd_rn(__fmul_rn(lrow[r], c), sum), quant);
        mrow[r] = m_new;
      }
    }

    // P.V over the tile with P cast to the operand type, then acc' = quant(acc c + P.V)
    float pv[BQ / 4] = {};
    for (int c0 = 0; c0 < block_k; c0 += KC) {
      const int jn = min(KC, block_k - c0);
      __syncthreads();  // the stats pass, or the previous chunk, is done
      for (int i = tid; i < KC * D; i += THREADS) {
        const int j = i / D, d = i % D;
        kv[j * (D + 1) + d] =
            j < jn ? lg::to_f(row_ptr<T>(v, b, h, base + c0 + j)[d]) : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < jn; ++j) {
        const float vv = kv[j * (D + 1) + cj];
#pragma unroll
        for (int rr = 0; rr < BQ / 4; ++rr)
          pv[rr] = fmaf(lg::round_to<T>(ss[(r0 + 4 * rr) * block_k + c0 + j]), vv, pv[rr]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < BQ / 4; ++rr)
      acc[rr] = lg::quant_stat(__fadd_rn(__fmul_rn(acc[rr], crow[r0 + 4 * rr]), pv[rr]), quant);
  }
  __syncthreads();  // lrow of the last tile (or of none)

  if (STEP) {  // the carries out; a row whose stripe does not run passes through
#pragma unroll
    for (int rr = 0; rr < BQ / 4; ++rr) {
      const int r = r0 + 4 * rr;
      if (i0 + r >= Nq) continue;
      const size_t at = (cbase + r) * D + cj;
      cy.acc_out[at] = runs(r) ? acc[rr] : cy.acc_in[at];
    }
    if (tid < BQ && i0 + tid < Nq) {
      const bool live = runs(tid);
      cy.m_out[cbase + tid] = live ? mrow[tid] : cy.m_in[cbase + tid];
      cy.l_out[cbase + tid] = live ? lrow[tid] : cy.l_in[cbase + tid];
    }
    return;
  }

#pragma unroll
  for (int rr = 0; rr < BQ / 4; ++rr) {
    const int r = r0 + 4 * rr;
    const int gi = i0 + r;
    if (gi >= Nq) continue;
    const float l = lrow[r];
    float val = acc[rr] / (l == 0.f ? 1.f : l);
    if (gi >= lq) val = 0.f;
    out[(long long)gi * o.rs + cj] = lg::from_f<T>(val);
  }
}

// ---------------------------------------------------------------------------
// The BF16 kernel: both products on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

template <bool STEP, int C>
__global__ void __launch_bounds__(WARPS * 32)
flash_mma_kernel(Operand q, Operand k, Operand v, Out o, Carries cy, const int* __restrict__ lens,
                 int Nq, int Nk, float scale, int block_k, int quant, int stages,
                 int aligned) {
  constexpr int BR = 16 * (WARPS / C);  // rows per block
  constexpr int KW = KC / C;            // keys of each chunk per warp
  constexpr int NT = KW / 8;            // S n-tiles per warp and chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* qs = reinterpret_cast<bf16_t*>(smem_raw);              // [BR][LD]
  bf16_t* kv = qs + BR * LD;  // [stages][K, V][KC][LD]
  float* red = reinterpret_cast<float*>(kv + stages * 2 * KC * LD);  // C > 1: [WARPS][16][RS]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rg = warp / C, part = warp % C;  // 16-row group, share of each chunk's keys
  const int g = lane / 4, t4 = lane % 4;     // mma fragment row and column pair
  const int mi = lane / 8, mr = lane % 8;    // ldmatrix matrix and row of this lane
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
  bf16_t* out = STEP ? nullptr : static_cast<bf16_t*>(o.ptr) + b * o.bs + h * o.hs;
  if (!STEP && i0 >= lq) {  // a stripe wholly past q_len: zeros
    for (int i = tid; i < BR * D; i += blockDim.x)
      if (i0 + i / D < Nq) out[(long long)(i0 + i / D) * o.rs + i % D] = __float2bfloat16(0.f);
    return;
  }

  // Q into registers: this warp's 16 rows as 4 A fragments
  stage_rows(qs, q, b, h, i0, BR, min(BR, Nq - i0), aligned);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  unsigned qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(qf[kk], qs + (rg * 16 + mr + (mi & 1) * 8) * LD + kk * 16 + (mi >> 1) * 8);

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

  // Resident (nc <= stages): chunk c of a tile lives in buffer c (K, then
  // V); pass 1 copies the whole tile's K and V once and pass 2 reads them
  // again. Streaming: two buffers, each pass copies chunk c + 1 while chunk
  // c is in use, pass 1 K only.
  const int nc = (block_k + KC - 1) / KC;  // chunks per tile
  const bool resident = nc <= stages;
  auto kbuf = [&](int c) { return kv + (resident ? c : c & 1) * 2 * KC * LD; };
  auto fetch = [&](int base, int c, bool with_v) {
    const int jn = min(KC, block_k - c * KC);
    stage_rows(kbuf(c), k, b, h, base + c * KC, KC, jn, aligned);
    if (with_v) stage_rows(kbuf(c) + KC * LD, v, b, h, base + c * KC, KC, jn, aligned);
    cp_async_commit();
  };
  // chunk c has landed (later chunks may still be in flight)
  auto land = [&](int c) {
    if (resident)
      cp_async_wait_n(nc - 1 - c);
    else if (c + 1 < nc)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
  };
  // s = quant(Q.K^T * scale) over this warp's KW keys of chunk c. Columns
  // that take no part in the tile are the pad of a short last chunk (-inf:
  // no part in max, p or sum p) and those at or past kv_len (-1e30, as the
  // reference sets them); only a ragged chunk has any. One select per
  // element (no branches) keeps the loop as fast as the plain transform.
  auto scores = [&](float (&s)[NT][4], int base, int c) {
    const bf16_t* kb = kbuf(c) + part * KW * LD;
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned r[4];
        ldsm_x4(r, kb + (np * 16 + mr + (mi >> 1) * 8) * LD + kk * 16 + (mi & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
        mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
      }
    }
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
    for (int c = 0; c < (resident ? nc : 1); ++c) fetch(base, c, resident);
    for (int c = 0; c < nc; ++c) {
      if (!resident && c + 1 < nc) fetch(base, c + 1, false);  // the buffer of chunk c - 1
      land(c);
      float s[NT][4];
      scores(s, base, c);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
      if (!resident) __syncthreads();  // this buffer is free for the next fetch
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
    float mn[2], cf[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mn[i] = lg::quant_stat(fmaxf(m[i], mx[i]), quant);
      cf[i] = lg::quant_stat(expf(m[i] - mn[i]), quant);
    }

    // pass 2: the same S again, p, sum p and P.V with P cast to bf16
    float ps[2] = {0.f, 0.f};
    float pv[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
    if (!resident) fetch(base, 0, true);
    for (int c = 0; c < nc; ++c) {
      if (!resident) {
        if (c + 1 < nc) fetch(base, c + 1, true);
        land(c);
      }
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
      const bf16_t* vb = kbuf(c) + KC * LD + part * KW * LD;
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {  // 16 keys per k step
        const unsigned a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          unsigned r[4];
          ldsm_x4_trans(r, vb + (kk * 16 + mr + (mi & 1) * 8) * LD + dp * 16 + (mi >> 1) * 8);
          mma_bf16(pv[2 * dp], a, r[0], r[1]);
          mma_bf16(pv[2 * dp + 1], a, r[2], r[3]);
        }
      }
      if (!resident) __syncthreads();  // this buffer is free for the next fetch
    }
    if (resident) __syncthreads();  // the next tile's copies overwrite the buffers
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
      __syncthreads();
    }
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
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)gi * o.rs + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <bool ROPE, bool STEP>
int launch_fma(Operand q, Operand k, Operand v, Out o, Carries cy, const void* freqs,
               const void* lens, int B, int H, int Nq, int Nk, float scale, int block_k,
               int quant, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * D + KC * (D + 1) + BQ * block_k + 3 * BQ);
  static size_t opted_in = 48 * 1024;  // raised once per size, not per launch
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<ROPE, STEP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  dim3 grid((Nq + BQ - 1) / BQ, H, B);
  flash_kernel<ROPE, STEP><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, cy, static_cast<const float*>(freqs),
      static_cast<const int*>(lens), Nq, Nk, scale, block_k, quant);
  return static_cast<int>(cudaGetLastError());
}

template <bool STEP, int C>
int launch_mma(Operand q, Operand k, Operand v, Out o, Carries cy, const void* lens, int B,
               int H, int Nq, int Nk, float scale, int block_k, int quant, int stages,
               cudaStream_t stream) {
  const size_t smem = mma_smem(C, stages);
  static size_t opted_in = 48 * 1024;  // raised once per size, not per launch
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(flash_mma_kernel<STEP, C>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  constexpr int BR = 16 * (WARPS / C);
  const int aligned = aligned16(q) && aligned16(k) && aligned16(v);
  dim3 grid((Nq + BR - 1) / BR, H, B);
  flash_mma_kernel<STEP, C><<<grid, WARPS * 32, smem, stream>>>(
      q, k, v, o, cy, static_cast<const int*>(lens), Nq, Nk, scale, block_k, quant, stages,
      aligned);
  return static_cast<int>(cudaGetLastError());
}

// bf16 operands on the tensor cores at the plan of kernels/attention.py:
// flash_plan (row_groups 4, 2 or 1 16-row groups per block, `stages` chunk
// buffers); fp32 operands on the FMA units (with RoPE inside when freqs is
// set; the bf16 caller has rotated q and k)
template <bool STEP>
int launch(Operand q, Operand k, Operand v, Out o, Carries cy, const void* freqs,
           const void* lens, int B, int H, int Nq, int Nk, float scale, int block_k, int quant,
           int row_groups, int stages, int bf16_ops, cudaStream_t s) {
  if (!bf16_ops) {
    if constexpr (STEP)  // the ring step has no RoPE
      return launch_fma<false, true>(q, k, v, o, cy, freqs, lens, B, H, Nq, Nk, scale, block_k,
                                     quant, s);
    return (freqs ? launch_fma<true, false> : launch_fma<false, false>)(
        q, k, v, o, cy, freqs, lens, B, H, Nq, Nk, scale, block_k, quant, s);
  }
  if (stages < min(2, (block_k + KC - 1) / KC)) return static_cast<int>(cudaErrorInvalidValue);
  switch (row_groups) {
    case 4:
      return launch_mma<STEP, 1>(q, k, v, o, cy, lens, B, H, Nq, Nk, scale, block_k, quant,
                                 stages, s);
    case 2:
      return launch_mma<STEP, 2>(q, k, v, o, cy, lens, B, H, Nq, Nk, scale, block_k, quant,
                                 stages, s);
    case 1:
      return launch_mma<STEP, 4>(q, k, v, o, cy, lens, B, H, Nq, Nk, scale, block_k, quant,
                                 stages, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// fused_mha: q (B, Nq, H*64), k/v (B, Nk, H*64) rows addressed by (batch,
// row) strides in elements, head h at columns [h*64, h*64 + 64). freqs:
// (B, 2, Nk, 64) fp32 [cos; sin] (Nq == Nk) or null for no RoPE. lens:
// (B, 2) int32 [q_len, kv_len] or null (unmasked). out: (B, Nq, H*64) T.
// row_groups, stages: the bf16 kernel's plan (kernels/attention.py:flash_plan).
// rot: bf16 with RoPE, (2, B, Nq, H*64) scratch for the rotated q and k.
extern "C" int lg_fused_mha(const void* q, long long q_bs, long long q_rs,
                            const void* k, long long k_bs, long long k_rs,
                            const void* v, long long v_bs, long long v_rs,
                            const void* freqs, const void* lens, void* out, void* rot,
                            int B, int Nq, int Nk, int H, float scale,
                            int block_k, int quant, int row_groups, int stages, int bf16,
                            void* stream) {
  Operand oq{q, q_bs, D, q_rs}, ok{k, k_bs, D, k_rs};
  const Operand ov{v, v_bs, D, v_rs};
  const Out oo{out, (long long)Nq * H * D, D, (long long)H * D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && freqs) {
    const cudaError_t err =
        rope_qk(oq, ok, static_cast<const float*>(freqs), static_cast<bf16_t*>(rot), B, Nq, H, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long bs = (long long)Nq * H * D;
    oq = Operand{rot, bs, D, (long long)H * D};
    ok = Operand{static_cast<bf16_t*>(rot) + B * bs, bs, D, (long long)H * D};
    freqs = nullptr;
  }
  return launch<false>(oq, ok, ov, oo, Carries{}, freqs, lens, B, H, Nq, Nk, scale, block_k,
                       quant, row_groups, stages, bf16, s);
}

// flash_attention: q (B, H, Nq, 64), k/v (B, H, Nk, 64) addressed by (batch,
// head, row) strides in elements. lens as above. out: (B, H, Nq, 64) T.
extern "C" int lg_flash_attention(
    const void* q, long long q_bs, long long q_hs, long long q_rs,
    const void* k, long long k_bs, long long k_hs, long long k_rs,
    const void* v, long long v_bs, long long v_hs, long long v_rs,
    const void* lens, void* out, int B, int H, int Nq, int Nk, float scale,
    int block_k, int quant, int row_groups, int stages, int bf16, void* stream) {
  const Operand oq{q, q_bs, q_hs, q_rs}, ok{k, k_bs, k_hs, k_rs},
      ov{v, v_bs, v_hs, v_rs};
  const Out oo{out, (long long)H * Nq * D, (long long)Nq * D, D};
  return launch<false>(oq, ok, ov, oo, Carries{}, nullptr, lens, B, H, Nq, Nk, scale, block_k,
                       quant, row_groups, stages, bf16, static_cast<cudaStream_t>(stream));
}

// flash_attention_step: q (B, H, Nq, 64), k/v (B, H, Nk, 64) addressed by
// (batch, head, row) strides in elements; m/l (B, H, Nq, 1) and acc
// (B, H, Nq, 64) fp32 contiguous carries in and out (distinct buffers). lens:
// (B, 2) int32 GLOBAL [q_len, kv_len] or null (unmasked: every stripe runs).
extern "C" int lg_flash_attention_step(
    const void* q, long long q_bs, long long q_hs, long long q_rs,
    const void* k, long long k_bs, long long k_hs, long long k_rs,
    const void* v, long long v_bs, long long v_hs, long long v_rs,
    const void* m_in, const void* l_in, const void* acc_in, void* m_out,
    void* l_out, void* acc_out, const void* lens, int B, int H, int Nq, int Nk,
    int row0, int col0, float scale, int block_q, int block_k, int quant,
    int row_groups, int stages, int bf16, void* stream) {
  const Operand oq{q, q_bs, q_hs, q_rs}, ok{k, k_bs, k_hs, k_rs},
      ov{v, v_bs, v_hs, v_rs};
  const Out none{nullptr, 0, 0, 0};
  const Carries cy{static_cast<const float*>(m_in), static_cast<const float*>(l_in),
                   static_cast<const float*>(acc_in), static_cast<float*>(m_out),
                   static_cast<float*>(l_out), static_cast<float*>(acc_out),
                   row0, col0, block_q};
  return launch<true>(oq, ok, ov, none, cy, nullptr, lens, B, H, Nq, Nk, scale, block_k, quant,
                      row_groups, stages, bf16, static_cast<cudaStream_t>(stream));
}
