// Y = [A | A2] . W + b (+ R): the projections of the LightGlue layer stack.
//
// Replaces the matrix products inside the TPU kernel
// lightglue_tpu/kernels/layer_stack.py:transformer_stack (wrapper :801,
// pallas_call :894): _linear (:357-375) for the fused qkv, the out
// projections, ffn1 over cat(x, message) (:386-388, taken here as two A
// operands so the concat is never materialised) and ffn2 with its residual
// add (:399). Rounding follows the reference exactly: the fp32 accumulator
// is cast to the activation type T, the bias is added in T, and the
// residual is added in T (JAX _linear's .astype(dt) + b.astype(dt), and
// xin + _linear(...)).
//
// Bound on the H100: at M = 1024 rows, K <= 512 and N <= 768 a product is
// 0.13-0.54 GFLOP on 1.2-2.6 MB, so it sits near the ridge; per call the
// bytes bound it (0.35-0.78 us at 3.35 TB/s) and the bf16 tensor-core peak
// nearly so (0.14-0.54 us).
//
// The bf16-operand kernel (linear_mma_kernel) is a pipelined mma.sync GEMM:
// - mma.sync m16n8k16, bf16 in, fp32 accumulators in registers; 4 warps
//   in a 2 x 2 layout over a BM x BN tile, each warp (BM / 2) x (BN / 2).
// - K runs in chunks of 64 staged with 16 B cp.async into a ring of 3
//   buffers, so two chunks' copies are in flight while one is multiplied.
//   A is read with ldmatrix, W (stored K x N, row-major) with
//   ldmatrix.trans, the way flash_attn.cu reads V (mma.cuh). Rows are
//   padded by 8 elements so an ldmatrix's eight rows fall in different banks.
// - ffn1's second operand: a 16 B segment at column c reads A at c < k1
//   and A2 at c - k1 past it (k1 % 8 == 0), so the concat is never
//   materialised; with K1 = 256 every chunk comes from one source.
// - The tile per shape (linear_tile below; kernels/layer_stack.py:
//   linear_plan mirrors it): 64 x 64 where that gives 256 blocks (two per
//   SM, so one block's loads overlap another's products), else 64 x 32,
//   else 32 x 32. At M = 1024 qkv, ffn1 and qk_v take 64 x 32 and the out
//   and ffn2 projections (N = 256) 32 x 32, 256-384 blocks where one 64 x
//   64 tile per block gave 64-192. BM divides 64, so a tile never straddles
//   two pairs. The chunk depth, ring and block target are the fastest of
//   eight variants timed at the main path's shapes (PERF.md, PR 6).
// - The epilogue is the reference's: round acc to T, add the bias (rounded
//   to T) in T and round, add the residual in T and round.
// - Operands whose rows do not start on 16 B (any pointer or width off a
//   multiple of 8 elements) are staged by element loads.
// No split-K: every output's sum runs in one order, the same in every run.
//
// The same kernel takes the operand modes of the other rungs (template
// arguments: A/activation type, weight type, bias type, output type):
// - BF16: bf16 A, W, bias, residual and Y.
// - MIXED (fp32 activations, bf16 products; JAX _linear :373-375 with
//   dt = fp32, attn_dtype = bf16): fp32 A, A2 and residual, rounded to bf16
//   as they are staged (cp.async cannot convert, so 8 values at a time go
//   through registers); bf16 W; fp32 bias; the epilogue in fp32 with no
//   rounding. Y is fp32, or bf16 for the qkv and qk_v projections, whose
//   only reader is the attention (the reference's .astype(attn_dtype) of
//   the fp32 result, one rounding).
// - INT8 weight-only (JAX _take_linear :245-249): int8 W with an fp32
//   scale per output channel, dequantized while it is staged,
//   bf16(float(w_q) * scale) into the same shared-memory tile the bf16 W
//   takes; bf16 activations; the fp32 bias rounded to bf16 in the
//   epilogue. The product is linear(a, dequantize(w)) bit for bit: the same
//   B values in the same k order.
//
// The W8A8 kernel (linear_s8_kernel; LGTPU_W8A8=1 on the INT8 rung, JAX
// _aquant :339-346, _doti8 :348-355, _linear's q8 branch :368-372, the qkv
// path :418-428) multiplies int8 activations by int8 weights on the tensor
// cores: mma.sync m16n8k32, s8 in, s32 sums. row_quant_kernel first
// quantizes each row of [A | A2] once (its own launch): amax over the whole
// row (ffn1: over x and the message together), sa = max(amax, 1e-6) / 127
// as the reference writes it (* (1/127)), q = clip(rint(v / sa), -127, 127)
// with a true division and round-half-even. The GEMM stages A chunks as
// they are and W chunks transposed to [n][k] bytes, so every fragment is one
// 32-bit shared load. K <= 512, so |acc| <= 512 * 127^2 < 2^24: the s32 sum
// and its conversion to fp32 are exact, whatever the order. The epilogue is
// the reference's: y = (float(acc) * sa) * scale, rounded to bf16, + the
// bias rounded to bf16, + the residual in bf16.
//
// The FP32 kernel (linear_tf32_kernel, the fp32 rung) is the same pipelined
// GEMM on the tensor cores in 3xTF32: one TF32 product keeps about three
// decimal digits and misses the fp32 gate of 1e-4, so each operand x is
// split into hi and lo = x - hi and every product is hi*lo + lo*hi + hi*hi
// on mma.sync m16n8k8 with fp32 sums (the small terms first, lo*lo
// dropped), the fp32 model conv's design (conv3x3.cu) with flash_attn.cu's
// split by truncation (mma.cuh:split_tf32_rz; 1.15x faster whole than the
// rounding split, scripts/tune_torch_fp32_flash.py).
// - linear_tile's tile, 4 warps 2 x 2, a 3-buffer cp.async ring; the chunks
//   are raw fp32, 64 deep in K (eight k8 steps), A rows at a 68-float pitch
//   and W rows at TN + 8 so that a warp's 32-bit fragment loads (there is
//   no ldmatrix for 32-bit elements) fall in 32 banks: 56-105 KB a block.
//   64-deep chunks ran 7 % faster per stack pair than 32-deep ones, and a
//   tile rule aiming for 128 blocks (larger tiles) no faster
//   (scripts/tune_torch_fp32_flash.py, PERF.md PR 12).
// - Each element is split as its fragment loads: per k8 step a warp splits
//   4 MT A and 2 NT B values against 3 MT NT products.
// - Bound at 3xTF32: 3 x 0.13-0.54 GFLOP a call at 495 TFLOP/s, 0.8-3.3 us,
//   above the 0.7-1.6 us of its fp32 bytes.
// - The epilogue in fp32 (the reference's rounding to T is the identity):
//   + bias, + residual; ffn1's concat, the residual and liveness as above.
//
// Liveness (transformer_stack_adaptive, wrapper :974, pallas_call :1229):
// with an exit register (B,) fp32 and the global layer g, a tile whose pair
// has exit <= g (rows_per_pair % 64 == 0 and BM divides 64, so a tile holds
// one pair) skips the product, the pl.when(live) gate of :734-745. With a
// residual (ffn2) it writes y = R, so a retired pair's activations pass
// through the layer bit for bit; without one its rows are left unwritten
// and never read.

#include <type_traits>

#include "mma.cuh"

namespace {

using namespace lg;  // the tensor-core helpers (mma.cuh)

// a retired pair's tile: Y = R where there is a residual, else untouched
template <typename TA, typename TO>
__device__ __forceinline__ bool retired(const float* exit_reg, int layer, int rows_per_pair,
                                        int m0, int n0, int TM, int TN, int M, int N,
                                        const TA* res, TO* y, int tid, int threads) {
  if (!exit_reg || exit_reg[m0 / rows_per_pair] > static_cast<float>(layer)) return false;
  if (res) {
    for (int i = tid; i < TM * TN; i += threads) {
      const int gm = m0 + i / TN, gn = n0 + i % TN;
      if (gm < M) y[(size_t)gm * N + gn] = from_f<TO>(to_f(res[(size_t)gm * N + gn]));
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// The bf16-operand kernel: a pipelined mma.sync GEMM
// ---------------------------------------------------------------------------

constexpr int MMA_BK = 64;       // K depth of a staged chunk
constexpr int MMA_STAGES = 3;    // chunk buffers in the ring
constexpr int MMA_THREADS = 128; // 4 warps, 2 x 2 over the tile
constexpr int MIN_BLOCKS = 256;  // blocks a tile plan aims for: about two per SM

// eight fp32 values rounded to bf16 into one 16 B shared-memory segment
__device__ __forceinline__ void put8(bf16_t* d, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(d) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// TA: the activation type of A, A2 and the residual, and the epilogue's
// rounding (bf16, or fp32 for MIXED, staged as bf16); TW: bf16, or int8
// with wscale (one fp32 per output channel); TB: the bias type; TO: Y's type
template <int TM, int TN, typename TA, typename TW, typename TB, typename TO>
__global__ void __launch_bounds__(MMA_THREADS)
linear_mma_kernel(const TA* __restrict__ a, const TA* __restrict__ a2, int k1,
                  const TW* __restrict__ w, const float* __restrict__ wscale,
                  const TB* __restrict__ bias, const TA* __restrict__ res, TO* __restrict__ y,
                  int M, int N, int K, const float* __restrict__ exit_reg, int layer,
                  int rows_per_pair, int aligned) {
  constexpr bool A_BF16 = std::is_same<TA, bf16_t>::value;
  constexpr bool W_BF16 = std::is_same<TW, bf16_t>::value;
  constexpr int AP = MMA_BK + 8;  // A row pitch in shared memory (144 B)
  constexpr int WP = TN + 8;      // W row pitch
  constexpr int MT = TM / 32;     // m16 tiles per warp
  constexpr int NT = TN / 16;     // n8 tiles per warp
  constexpr int SA = MMA_BK / 8;  // 16 B segments of an A chunk row
  constexpr int SW = TN / 8;      // 16 B segments of a W chunk row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* const as = reinterpret_cast<bf16_t*>(smem_raw);  // slot s: as + s * TM * AP
  bf16_t* const ws = as + MMA_STAGES * TM * AP;             // slot s: ws + s * MMA_BK * WP

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;   // this warp's quarter of the tile
  const int g = lane / 4, t4 = lane % 4;    // mma fragment row and column pair
  const int mi = lane / 8, mr = lane % 8;   // ldmatrix matrix and row of this lane
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int k2 = K - k1;  // width of the second A operand (0 without one)
  if (retired(exit_reg, layer, rows_per_pair, m0, n0, TM, TN, M, N, res, y, tid, MMA_THREADS))
    return;

  // chunk kt of A (TM x 64, from a or a2) and W (64 x TN) into slot kt % 3;
  // rows past M and columns past K are zero. bf16 sources copy by cp.async;
  // fp32 A and int8 W go through registers, rounded to bf16 on the way.
  auto fetch = [&](int kt) {
    const int kc = kt * MMA_BK, slot = kt % MMA_STAGES;
    for (int s = tid; s < TM * SA; s += MMA_THREADS) {
      const int r = s / SA, c = kc + s % SA * 8, gm = m0 + r;
      bf16_t* d = as + slot * TM * AP + r * AP + s % SA * 8;
      if (gm >= M || c >= K) {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      } else if (A_BF16 && aligned) {
        cp_async16(d, c < k1 ? a + (size_t)gm * k1 + c : a2 + (size_t)gm * k2 + c - k1);
      } else if (!A_BF16 && aligned) {
        const TA* src = c < k1 ? a + (size_t)gm * k1 + c : a2 + (size_t)gm * k2 + c - k1;
        const float4 lo = *reinterpret_cast<const float4*>(src);
        const float4 hi = *reinterpret_cast<const float4*>(src + 4);
        put8(d, {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w});
      } else {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int col = c + e;
          v[e] = col < k1 ? to_f(a[(size_t)gm * k1 + col])
                          : col < K ? to_f(a2[(size_t)gm * k2 + col - k1]) : 0.f;
        }
        put8(d, v);
      }
    }
    for (int s = tid; s < MMA_BK * SW; s += MMA_THREADS) {
      const int r = s / SW, c = s % SW * 8, gk = kc + r;
      bf16_t* d = ws + slot * MMA_BK * WP + r * WP + c;
      if (gk >= K) {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      } else if constexpr (W_BF16) {
        if (aligned) {
          cp_async16(d, w + (size_t)gk * N + n0 + c);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) d[e] = w[(size_t)gk * N + n0 + c + e];
        }
      } else {  // int8 weight: (float(w_q) * scale) rounded to bf16
        const TW* src = w + (size_t)gk * N + n0 + c;
        const float* sc = wscale + n0 + c;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __fmul_rn(static_cast<float>(src[e]), sc[e]);
        put8(d, v);
      }
    }
    cp_async_commit();
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int nk = (K + MMA_BK - 1) / MMA_BK;
#pragma unroll
  for (int kt = 0; kt < MMA_STAGES - 1; ++kt) {
    if (kt < nk)
      fetch(kt);
    else
      cp_async_commit();  // an empty group keeps the wait count uniform
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<MMA_STAGES - 2>();  // chunk kt has landed
    __syncthreads();                  // ... for every thread, and chunk kt - 1 is done
    if (kt + MMA_STAGES - 1 < nk)
      fetch(kt + MMA_STAGES - 1);  // into the slot of chunk kt - 1
    else
      cp_async_commit();
    const bf16_t* at = as + (kt % MMA_STAGES) * TM * AP + wm * (TM / 2) * AP;
    const bf16_t* wt = ws + (kt % MMA_STAGES) * MMA_BK * WP + wn * (TN / 2);
#pragma unroll
    for (int ks = 0; ks < MMA_BK / 16; ++ks) {
      unsigned af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(af[mt], at + (mt * 16 + mr + (mi & 1) * 8) * AP + ks * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned r[4];
        ldsm_x4_trans(r, wt + (ks * 16 + mr + (mi & 1) * 8) * WP + np * 16 + (mi >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], r[0], r[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], r[2], r[3]);
        }
      }
    }
  }

  // epilogue: round acc to TA, + bias rounded to TA, + residual in TA
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gm = m0 + wm * (TM / 2) + mt * 16 + g + 8 * i;
      if (gm >= M) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int gn = n0 + wn * (TN / 2) + nt * 8 + 2 * t4;
        float v0 = round_to<TA>(acc[mt][nt][2 * i]);
        float v1 = round_to<TA>(acc[mt][nt][2 * i + 1]);
        v0 = round_to<TA>(v0 + round_to<TA>(to_f(bias[gn])));
        v1 = round_to<TA>(v1 + round_to<TA>(to_f(bias[gn + 1])));
        if (res) {
          v0 = round_to<TA>(v0 + to_f(res[(size_t)gm * N + gn]));
          v1 = round_to<TA>(v1 + to_f(res[(size_t)gm * N + gn + 1]));
        }
        store2(y + (size_t)gm * N + gn, v0, v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The FP32 kernel: a pipelined mma.sync GEMM in 3xTF32
// ---------------------------------------------------------------------------

constexpr int TF32_BK = 64;           // K depth of a staged fp32 chunk: eight k8 steps
constexpr int TF32_AP = TF32_BK + 4;  // A row pitch (68 floats): a warp's A fragment
                                      // loads (row g, k t4) fall in 32 banks

// Y = [A | A2] . W + b (+ R), all fp32: linear_mma_kernel's tile, warps and
// ring, with raw fp32 chunks and each product in 3xTF32 on m16n8k8
template <int TM, int TN>
__global__ void __launch_bounds__(MMA_THREADS)
linear_tf32_kernel(const float* __restrict__ a, const float* __restrict__ a2, int k1,
                   const float* __restrict__ w, const float* __restrict__ bias,
                   const float* __restrict__ res, float* __restrict__ y, int M, int N, int K,
                   const float* __restrict__ exit_reg, int layer, int rows_per_pair,
                   int aligned) {
  constexpr int WP = TN + 8;         // W row pitch: a warp's B loads (k t4, column g) in 32 banks
  constexpr int MT = TM / 32;        // m16 tiles per warp
  constexpr int NT = TN / 16;        // n8 tiles per warp
  constexpr int SA = TF32_BK / 4;    // 16 B segments of an A chunk row
  constexpr int SW = TN / 4;         // 16 B segments of a W chunk row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const as = reinterpret_cast<float*>(smem_raw);  // slot s: as + s * TM * TF32_AP
  float* const ws = as + MMA_STAGES * TM * TF32_AP;      // slot s: ws + s * TF32_BK * WP

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // this warp's quarter of the tile
  const int g = lane / 4, t4 = lane % 4;   // mma fragment row and column
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int k2 = K - k1;  // width of the second A operand (0 without one)
  if (retired(exit_reg, layer, rows_per_pair, m0, n0, TM, TN, M, N, res, y, tid, MMA_THREADS))
    return;

  // chunk kt of A (TM x 64, from a or a2) and W (64 x TN) into slot kt % 3;
  // rows past M and columns past K are zero
  auto fetch = [&](int kt) {
    const int kc = kt * TF32_BK, slot = kt % MMA_STAGES;
    for (int s = tid; s < TM * SA; s += MMA_THREADS) {
      const int r = s / SA, c = kc + s % SA * 4, gm = m0 + r;
      float* d = as + slot * TM * TF32_AP + r * TF32_AP + s % SA * 4;
      if (gm >= M || c >= K) {
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (aligned) {
        cp_async16(d, c < k1 ? a + (size_t)gm * k1 + c : a2 + (size_t)gm * k2 + c - k1);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c + e;
          d[e] = col < k1 ? a[(size_t)gm * k1 + col]
                          : col < K ? a2[(size_t)gm * k2 + col - k1] : 0.f;
        }
      }
    }
    for (int s = tid; s < TF32_BK * SW; s += MMA_THREADS) {
      const int r = s / SW, c = s % SW * 4, gk = kc + r;
      float* d = ws + slot * TF32_BK * WP + r * WP + c;
      if (gk >= K) {
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (aligned) {
        cp_async16(d, w + (size_t)gk * N + n0 + c);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] = w[(size_t)gk * N + n0 + c + e];
      }
    }
    cp_async_commit();
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int nk = (K + TF32_BK - 1) / TF32_BK;
#pragma unroll
  for (int kt = 0; kt < MMA_STAGES - 1; ++kt) {
    if (kt < nk)
      fetch(kt);
    else
      cp_async_commit();  // an empty group keeps the wait count uniform
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<MMA_STAGES - 2>();  // chunk kt has landed
    __syncthreads();                  // ... for every thread, and chunk kt - 1 is done
    if (kt + MMA_STAGES - 1 < nk)
      fetch(kt + MMA_STAGES - 1);  // into the slot of chunk kt - 1
    else
      cp_async_commit();
    const float* at = as + (kt % MMA_STAGES) * TM * TF32_AP + (wm * (TM / 2) + g) * TF32_AP + t4;
    const float* wt = ws + (kt % MMA_STAGES) * TF32_BK * WP + t4 * WP + wn * (TN / 2) + g;
#pragma unroll
    for (int ks = 0; ks < TF32_BK / 8; ++ks) {
      // A: a0 (row g, k t4), a1 (g + 8, t4), a2 (g, t4 + 4), a3 (g + 8, t4 + 4),
      // each split into (hi, lo) as it loads
      unsigned ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* ar = at + mt * 16 * TF32_AP + ks * 8;
        split_tf32_rz(ar[0], ah[mt][0], al[mt][0]);
        split_tf32_rz(ar[8 * TF32_AP], ah[mt][1], al[mt][1]);
        split_tf32_rz(ar[4], ah[mt][2], al[mt][2]);
        split_tf32_rz(ar[8 * TF32_AP + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {  // B: b0 (k t4, column g), b1 (k t4 + 4, g)
        const float* br = wt + ks * 8 * WP + nt * 8;
        unsigned bh0, bl0, bh1, bl1;
        split_tf32_rz(br[0], bh0, bl0);
        split_tf32_rz(br[4 * WP], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_3xtf32(acc[mt][nt], ah[mt], al[mt], bh0, bl0, bh1, bl1);
      }
    }
  }

  // epilogue in fp32: + bias, + residual
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gm = m0 + wm * (TM / 2) + mt * 16 + g + 8 * i;
      if (gm >= M) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int gn = n0 + wn * (TN / 2) + nt * 8 + 2 * t4;
        float v0 = acc[mt][nt][2 * i] + bias[gn];
        float v1 = acc[mt][nt][2 * i + 1] + bias[gn + 1];
        if (res) {
          v0 += res[(size_t)gm * N + gn];
          v1 += res[(size_t)gm * N + gn + 1];
        }
        store2(y + (size_t)gm * N + gn, v0, v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// W8A8: row quantization and the s8 GEMM
// ---------------------------------------------------------------------------

constexpr int QUANT_WARPS = 8;     // rows per row_quant block, a warp each
constexpr int QUANT_PER_LANE = 16; // rows up to 512 wide
constexpr int S8_BK = 64;          // K bytes per staged chunk: two k32 steps
constexpr int S8_P = S8_BK + 16;   // shared row pitch in bytes (80: conflict-free fragments)

// q = clip(rint(v / sa), -127, 127) over each row of [a | a2], sa =
// max(amax, 1e-6) * (1/127), both in fp32 as the reference computes them
__global__ void __launch_bounds__(QUANT_WARPS * 32)
row_quant_kernel(const bf16_t* __restrict__ a, const bf16_t* __restrict__ a2, int k1, int K,
                 int M, int8_t* __restrict__ q, float* __restrict__ sa) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * QUANT_WARPS + warp;
  if (row >= M) return;
  const int k2 = K - k1;
  float v[QUANT_PER_LANE], amax = 0.f;
#pragma unroll
  for (int i = 0; i < QUANT_PER_LANE; ++i) {
    const int c = lane + 32 * i;
    v[i] = c >= K ? 0.f : to_f(c < k1 ? a[(size_t)row * k1 + c] : a2[(size_t)row * k2 + c - k1]);
    amax = fmaxf(amax, fabsf(v[i]));
  }
  const float s = __fmul_rn(fmaxf(warp_max(amax), 1e-6f), static_cast<float>(1.0 / 127.0));
#pragma unroll
  for (int i = 0; i < QUANT_PER_LANE; ++i) {
    const int c = lane + 32 * i;
    if (c < K)
      q[(size_t)row * K + c] =
          static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(v[i], s)), -127.f), 127.f));
  }
  if (lane == 0) sa[row] = s;
}

// Y = round((float(Aq . Wq) * sa) * scale) + round(b) (+ R), bf16. Aq (M, K)
// and Wq (K, N) int8 row-major, 16 B aligned rows (K % 16 == 0, N % 64 == 0).
template <int TM, int TN>
__global__ void __launch_bounds__(MMA_THREADS)
linear_s8_kernel(const int8_t* __restrict__ aq, const float* __restrict__ asc,
                 const int8_t* __restrict__ w, const float* __restrict__ wscale,
                 const float* __restrict__ bias, const bf16_t* __restrict__ res,
                 bf16_t* __restrict__ y, int M, int N, int K, const float* __restrict__ exit_reg,
                 int layer, int rows_per_pair) {
  constexpr int MT = TM / 32;  // m16 tiles per warp
  constexpr int NT = TN / 16;  // n8 tiles per warp
  __shared__ __align__(16) int8_t as[TM * S8_P];  // [m][k]
  __shared__ __align__(16) int8_t ws[TN * S8_P];  // [n][k]: W transposed
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int g = lane / 4, t4 = lane % 4;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  if (retired(exit_reg, layer, rows_per_pair, m0, n0, TM, TN, M, N, res, y, tid, MMA_THREADS))
    return;

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

  for (int kc = 0; kc < K; kc += S8_BK) {
    for (int s = tid; s < TM * (S8_BK / 16); s += MMA_THREADS) {
      const int r = s / (S8_BK / 16), c = s % (S8_BK / 16) * 16, gm = m0 + r;
      int4 val = make_int4(0, 0, 0, 0);
      if (gm < M && kc + c < K) val = *reinterpret_cast<const int4*>(aq + (size_t)gm * K + kc + c);
      *reinterpret_cast<int4*>(as + r * S8_P + c) = val;
    }
    for (int s = tid; s < S8_BK * (TN / 16); s += MMA_THREADS) {
      const int r = s / (TN / 16), c = s % (TN / 16) * 16, gk = kc + r;
      int4 val = make_int4(0, 0, 0, 0);
      if (gk < K) val = *reinterpret_cast<const int4*>(w + (size_t)gk * N + n0 + c);
      const int8_t* e = reinterpret_cast<const int8_t*>(&val);
#pragma unroll
      for (int j = 0; j < 16; ++j) ws[(c + j) * S8_P + r] = e[j];
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < S8_BK / 32; ++ks) {
      const int kb = ks * 32 + 4 * t4;
      unsigned af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int8_t* ar = as + (wm * (TM / 2) + mt * 16 + g) * S8_P + kb;
        af[mt][0] = *reinterpret_cast<const unsigned*>(ar);
        af[mt][1] = *reinterpret_cast<const unsigned*>(ar + 8 * S8_P);
        af[mt][2] = *reinterpret_cast<const unsigned*>(ar + 16);
        af[mt][3] = *reinterpret_cast<const unsigned*>(ar + 8 * S8_P + 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int8_t* br = ws + (wn * (TN / 2) + nt * 8 + g) * S8_P + kb;
        const unsigned b0 = *reinterpret_cast<const unsigned*>(br);
        const unsigned b1 = *reinterpret_cast<const unsigned*>(br + 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][nt], af[mt], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gm = m0 + wm * (TM / 2) + mt * 16 + g + 8 * i;
      if (gm >= M) continue;
      const float s = asc[gm];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int gn = n0 + wn * (TN / 2) + nt * 8 + 2 * t4;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          v[j] = round_to<bf16_t>(
              __fmul_rn(__fmul_rn(static_cast<float>(acc[mt][nt][2 * i + j]), s), wscale[gn + j]));
          v[j] = round_to<bf16_t>(v[j] + round_to<bf16_t>(bias[gn + j]));
          if (res) v[j] = round_to<bf16_t>(v[j] + to_f(res[(size_t)gm * N + gn + j]));
        }
        store2(y + (size_t)gm * N + gn, v[0], v[1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The tensor-core kernels' tile (rows, columns) for an M x N product: 64 x
// 64 where that gives MIN_BLOCKS blocks, else 64 x 32, else 32 x 32
// (kernels/layer_stack.py:linear_plan mirrors it)
void linear_tile(int M, int N, int* tm, int* tn) {
  const int tiles[3][2] = {{64, 64}, {64, 32}, {32, 32}};
  for (const auto& t : tiles) {
    *tm = t[0], *tn = t[1];
    if ((long long)((M + t[0] - 1) / t[0]) * (N / t[1]) >= MIN_BLOCKS) return;
  }
}

// the ring of one block: MMA_STAGES chunks of A and W
constexpr size_t ring_smem(int TM, int TN) {
  return sizeof(bf16_t) * MMA_STAGES * (TM * (MMA_BK + 8) + MMA_BK * (TN + 8));
}

template <int TM, int TN, typename TA, typename TW, typename TB, typename TO>
int launch_mma(const void* a, const void* a2, int k1, const void* w, const void* wscale,
               const void* bias, const void* res, void* y, int M, int N, int K,
               const void* exit_reg, int layer, int rows_per_pair, int aligned,
               cudaStream_t stream) {
  constexpr size_t smem = ring_smem(TM, TN);
  auto kernel = linear_mma_kernel<TM, TN, TA, TW, TB, TO>;
  static bool opted_in = smem <= 48 * 1024;  // raised once, not per launch
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  dim3 grid(N / TN, (M + TM - 1) / TM);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const TA*>(a), static_cast<const TA*>(a2), k1, static_cast<const TW*>(w),
      static_cast<const float*>(wscale), static_cast<const TB*>(bias),
      static_cast<const TA*>(res), static_cast<TO*>(y), M, N, K,
      static_cast<const float*>(exit_reg), layer, rows_per_pair, aligned);
  return static_cast<int>(cudaGetLastError());
}

// the ring of one fp32 block: MMA_STAGES raw chunks of A and W
constexpr size_t tf32_ring_smem(int TM, int TN) {
  return sizeof(float) * MMA_STAGES * (TM * TF32_AP + TF32_BK * (TN + 8));
}

template <int TM, int TN>
int launch_tf32(const void* a, const void* a2, int k1, const void* w, const void* bias,
                const void* res, void* y, int M, int N, int K, const void* exit_reg, int layer,
                int rows_per_pair, int aligned, cudaStream_t stream) {
  constexpr size_t smem = tf32_ring_smem(TM, TN);
  auto kernel = linear_tf32_kernel<TM, TN>;
  static bool opted_in = smem <= 48 * 1024;  // raised once, not per launch
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  dim3 grid(N / TN, (M + TM - 1) / TM);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(a2), k1,
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(res), static_cast<float*>(y), M, N, K,
      static_cast<const float*>(exit_reg), layer, rows_per_pair, aligned);
  return static_cast<int>(cudaGetLastError());
}

int run_tf32(const void* a, const void* a2, int k1, const void* w, const void* wscale,
             const void* bias, const void* res, void* y, int M, int N, int K,
             const void* exit_reg, int layer, int rows_per_pair, int aligned, cudaStream_t s) {
  int tm, tn;
  linear_tile(M, N, &tm, &tn);
  auto run = tm == 64 ? (tn == 64 ? launch_tf32<64, 64> : launch_tf32<64, 32>)
                      : launch_tf32<32, 32>;
  return run(a, a2, k1, w, bias, res, y, M, N, K, exit_reg, layer, rows_per_pair, aligned, s);
}

template <typename TA, typename TW, typename TB, typename TO>
int run_mma(const void* a, const void* a2, int k1, const void* w, const void* wscale,
            const void* bias, const void* res, void* y, int M, int N, int K,
            const void* exit_reg, int layer, int rows_per_pair, int aligned, cudaStream_t s) {
  int tm, tn;
  linear_tile(M, N, &tm, &tn);
  auto run = tm == 64 ? (tn == 64 ? launch_mma<64, 64, TA, TW, TB, TO>
                                  : launch_mma<64, 32, TA, TW, TB, TO>)
                      : launch_mma<32, 32, TA, TW, TB, TO>;
  return run(a, a2, k1, w, wscale, bias, res, y, M, N, K, exit_reg, layer, rows_per_pair,
             aligned, s);
}

template <int TM, int TN>
int launch_s8(const void* aq, const void* asc, const void* w, const void* wscale,
              const void* bias, const void* res, void* y, int M, int N, int K,
              const void* exit_reg, int layer, int rows_per_pair, cudaStream_t stream) {
  dim3 grid(N / TN, (M + TM - 1) / TM);
  linear_s8_kernel<TM, TN><<<grid, MMA_THREADS, 0, stream>>>(
      static_cast<const int8_t*>(aq), static_cast<const float*>(asc),
      static_cast<const int8_t*>(w), static_cast<const float*>(wscale),
      static_cast<const float*>(bias), static_cast<const bf16_t*>(res), static_cast<bf16_t*>(y),
      M, N, K, static_cast<const float*>(exit_reg), layer, rows_per_pair);
  return static_cast<int>(cudaGetLastError());
}

bool on16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// operand modes of lg_linear (kernels/layer_stack.py:_LINEAR_MODES mirrors them)
enum Mode { FP32 = 0, BF16 = 1, MIXED = 2, MIXED_BF16_OUT = 3, INT8_WEIGHTS = 4 };

}  // namespace

// a: (M, k1); a2: (M, K - k1) or null with k1 == K; w: (K, N); wscale:
// (N,) fp32 for int8 weights, else null; bias: (N,); res: (M, N) or null;
// y: (M, N). N % 64 == 0, K % 16 == 0. mode: FP32 (all fp32, the FMA
// kernel), BF16 (all bf16), MIXED (fp32 a, a2, bias, res and y, bf16 w),
// MIXED_BF16_OUT (as MIXED with a bf16 y, no residual), INT8_WEIGHTS (bf16
// a, a2, res and y, int8 w with wscale, fp32 bias). exit_reg: (B,) fp32 or
// null; layer: the global layer index; the rows of pair b are
// [b * rows_per_pair, (b + 1) * rows_per_pair). The tensor-core modes run
// linear_mma_kernel at linear_tile's tile.
extern "C" int lg_linear(const void* a, const void* a2, int k1, const void* w,
                         const void* wscale, const void* bias, const void* res, void* y, int M,
                         int N, int K, const void* exit_reg, int layer, int rows_per_pair,
                         int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = mode == FP32 && !wscale ? run_tf32
             : mode == BF16 ? run_mma<bf16_t, bf16_t, bf16_t, bf16_t>
             : mode == MIXED ? run_mma<float, bf16_t, float, float>
             : mode == MIXED_BF16_OUT && !res ? run_mma<float, bf16_t, float, bf16_t>
             : mode == INT8_WEIGHTS && wscale ? run_mma<bf16_t, int8_t, float, bf16_t>
                                              : nullptr;
  if (!run) return static_cast<int>(cudaErrorInvalidValue);
  const int aligned = on16(a) && on16(a2) && on16(w) && k1 % 8 == 0 && (K - k1) % 8 == 0;
  return run(a, a2, k1, w, wscale, bias, res, y, M, N, K, exit_reg, layer, rows_per_pair,
             aligned, s);
}

// W8A8, step 1: a (M, k1) and a2 (M, K - k1) bf16 (a2 null with k1 == K),
// K <= 512, quantized per row of [a | a2] into q (M, K) int8 and sa (M,) fp32.
extern "C" int lg_row_quant(const void* a, const void* a2, int k1, int K, int M, void* q,
                            void* sa, void* stream) {
  if (K > 32 * QUANT_PER_LANE) return static_cast<int>(cudaErrorInvalidValue);
  row_quant_kernel<<<(M + QUANT_WARPS - 1) / QUANT_WARPS, QUANT_WARPS * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16_t*>(a), static_cast<const bf16_t*>(a2), k1, K, M,
      static_cast<int8_t*>(q), static_cast<float*>(sa));
  return static_cast<int>(cudaGetLastError());
}

// W8A8, step 2: y (M, N) bf16 = the s8 product of q (M, K) and w (K, N)
// int8, dequantized by sa (M,) and wscale (N,) fp32, + bias (N,) fp32 (+ res
// (M, N) bf16). K % 16 == 0, K <= 512, N % 64 == 0, q and w 16 B aligned.
// Liveness as lg_linear; the tile is linear_tile's.
extern "C" int lg_linear_s8(const void* q, const void* sa, const void* w, const void* wscale,
                            const void* bias, const void* res, void* y, int M, int N, int K,
                            const void* exit_reg, int layer, int rows_per_pair, void* stream) {
  if (K % 16 || K > 512 || !on16(q) || !on16(w)) return static_cast<int>(cudaErrorInvalidValue);
  int tm, tn;
  linear_tile(M, N, &tm, &tn);
  auto run = tm == 64 ? (tn == 64 ? launch_s8<64, 64> : launch_s8<64, 32>) : launch_s8<32, 32>;
  return run(q, sa, w, wscale, bias, res, y, M, N, K, exit_reg, layer, rows_per_pair,
             static_cast<cudaStream_t>(stream));
}

// The tensor-core kernels' tile at this shape, (rows, columns) into
// tile[0..1] (the wrapper's plan is held against it).
extern "C" int lg_linear_tile(int M, int N, int* tile) {
  linear_tile(M, N, &tile[0], &tile[1]);
  return 0;
}

// The dynamic shared memory of a block of lg_linear's GEMM at this shape,
// bytes: the fp32 ring in FP32 mode, the bf16 ring in the others
extern "C" int lg_linear_smem(int M, int N, int mode) {
  int tm, tn;
  linear_tile(M, N, &tm, &tn);
  return static_cast<int>(mode == FP32 ? tf32_ring_smem(tm, tn) : ring_smem(tm, tn));
}
