// Online-softmax multi-head attention over KV tiles: the per-block LightGlue
// path's self-attention (half-split RoPE on q and k) and, above 1024
// keypoints, each cross-attention direction; the generic (B, H, N, D)
// attention entry point; and the local step of ring attention.
//
// Replaces three TPU kernels of lightglue_tpu/kernels/attention.py with one
// templated kernel addressed by strides:
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
// acc' = quant(acc * c + P.V) with P cast to the V type; at the end
// out = acc / (l == 0 ? 1 : l) and rows >= q_len are 0. quant rounds through
// bf16 on the BF16 rung. Tiles that start at or past kv_len are skipped, so
// in a live tile m is a real maximum (no clamp) and kv_len == 0 gives l = 0
// and a zero output. m starts at -1e30. RoPE casts the freqs to the operand
// type and rounds each product and the sum (common.cuh:rope_rows).
//
// Bound on the H100: per head 4 * Nq * Nk * D FLOP against (Nq + 2 Nk) * D
// operands, so the tensor cores bound it (~9 us for the stacked self call
// at N = 2048, B = 2, H = 4). Design: one block per 16 query rows of one
// head loops over the block_k tiles. Each tile's 16 x block_k slab of S sits
// in shared memory (64 KB at block_k = 1024); K and V are staged in 64-key
// chunks. m, l and acc are rounded once per tile, after the whole tile, so
// the rounding points are set by block_k (a runtime argument), not by the
// chunking. acc stays in registers: thread t owns output column t % 64 of
// rows t / 64 + 4 i. The products run on the fp32 FMA units in this first
// version; the updates of l and acc are written with __fmul_rn/__fadd_rn
// so that the compiler does not fuse them into an FMA the reference does
// not take.
//
// STEP (the ring step, attention.py:303-415) starts m, l and acc from the
// fp32 carries instead of -1e30, 0, 0, masks the columns at their global
// ids col0 + j against the GLOBAL kv_len (tiles past kv_len - col0 are
// skipped), and writes the three carries back in fp32 instead of
// finalising. Its row rule is the reference's, at the reference's stripe
// of block_q rows (not at this kernel's 16): with lengths, a stripe runs
// only if row0 + its first row < q_len and one tile of the block is live,
// and the rows of a stripe that does not run pass their carries through
// unchanged. A 16-row block with no running row only copies its carries.
// Its bound is the fp32 carries' bytes (read and written each step) at the
// ring's 512-row stripes; the compute design is the same as above.

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
  long long bs, hs, rs;  // batch, head and row strides in elements
};

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

template <typename T>
__device__ __forceinline__ const T* row_ptr(const Operand& o, int b, int h,
                                            int row) {
  return static_cast<const T*>(o.ptr) + b * o.bs + h * o.hs +
         (long long)row * o.rs;
}

template <typename T, bool ROPE, bool STEP>
__global__ void __launch_bounds__(THREADS, 2)
flash_kernel(Operand q, Operand k, Operand v, Out o, Carries cy,
             const float* __restrict__ freqs, const int* __restrict__ lens,
             int Nq, int Nk, float scale, int block_k, int quant) {
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

template <typename T, bool ROPE, bool STEP>
int launch(Operand q, Operand k, Operand v, Out o, Carries cy, const void* freqs,
           const void* lens, int B, int H, int Nq, int Nk, float scale,
           int block_k, int quant, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * D + KC * (D + 1) + BQ * block_k + 3 * BQ);
  static size_t opted_in = 48 * 1024;  // raised once per size, not per launch
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, ROPE, STEP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  dim3 grid((Nq + BQ - 1) / BQ, H, B);
  flash_kernel<T, ROPE, STEP><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, cy, static_cast<const float*>(freqs),
      static_cast<const int*>(lens), Nq, Nk, scale, block_k, quant);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(Operand q, Operand k, Operand v, Out o, const void* freqs,
             const void* lens, int B, int H, int Nq, int Nk, float scale,
             int block_k, int quant, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Carries none{};
  if (bf16)
    return (freqs ? launch<__nv_bfloat16, true, false> : launch<__nv_bfloat16, false, false>)(
        q, k, v, o, none, freqs, lens, B, H, Nq, Nk, scale, block_k, quant, s);
  return (freqs ? launch<float, true, false> : launch<float, false, false>)(
      q, k, v, o, none, freqs, lens, B, H, Nq, Nk, scale, block_k, quant, s);
}

}  // namespace

// fused_mha: q (B, Nq, H*64), k/v (B, Nk, H*64) rows addressed by (batch,
// row) strides in elements, head h at columns [h*64, h*64 + 64). freqs:
// (B, 2, Nk, 64) fp32 [cos; sin] (Nq == Nk) or null for no RoPE. lens:
// (B, 2) int32 [q_len, kv_len] or null (unmasked). out: (B, Nq, H*64) T.
extern "C" int lg_fused_mha(const void* q, long long q_bs, long long q_rs,
                            const void* k, long long k_bs, long long k_rs,
                            const void* v, long long v_bs, long long v_rs,
                            const void* freqs, const void* lens, void* out,
                            int B, int Nq, int Nk, int H, float scale,
                            int block_k, int quant, int bf16, void* stream) {
  const Operand oq{q, q_bs, D, q_rs}, ok{k, k_bs, D, k_rs}, ov{v, v_bs, D, v_rs};
  const Out oo{out, (long long)Nq * H * D, D, (long long)H * D};
  return dispatch(oq, ok, ov, oo, freqs, lens, B, H, Nq, Nk, scale, block_k,
                  quant, bf16, stream);
}

// flash_attention: q (B, H, Nq, 64), k/v (B, H, Nk, 64) addressed by (batch,
// head, row) strides in elements. lens as above. out: (B, H, Nq, 64) T.
extern "C" int lg_flash_attention(
    const void* q, long long q_bs, long long q_hs, long long q_rs,
    const void* k, long long k_bs, long long k_hs, long long k_rs,
    const void* v, long long v_bs, long long v_hs, long long v_rs,
    const void* lens, void* out, int B, int H, int Nq, int Nk, float scale,
    int block_k, int quant, int bf16, void* stream) {
  const Operand oq{q, q_bs, q_hs, q_rs}, ok{k, k_bs, k_hs, k_rs},
      ov{v, v_bs, v_hs, v_rs};
  const Out oo{out, (long long)H * Nq * D, (long long)Nq * D, D};
  return dispatch(oq, ok, ov, oo, nullptr, lens, B, H, Nq, Nk, scale, block_k,
                  quant, bf16, stream);
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
    int bf16, void* stream) {
  const Operand oq{q, q_bs, q_hs, q_rs}, ok{k, k_bs, k_hs, k_rs},
      ov{v, v_bs, v_hs, v_rs};
  const Out none{nullptr, 0, 0, 0};
  const Carries cy{static_cast<const float*>(m_in), static_cast<const float*>(l_in),
                   static_cast<const float*>(acc_in), static_cast<float*>(m_out),
                   static_cast<float*>(l_out), static_cast<float*>(acc_out),
                   row0, col0, block_q};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, false, true>(oq, ok, ov, none, cy, nullptr, lens, B, H, Nq,
                                              Nk, scale, block_k, quant, s);
  return launch<float, false, true>(oq, ok, ov, none, cy, nullptr, lens, B, H, Nq, Nk, scale,
                                    block_k, quant, s);
}
