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
// The bf16-product kernel (linear_wgmma_kernel) is built in Hopper's shape
// from hopper.cuh's pieces:
// - A 64 x BN tile a block: one consumer warpgroup runs wgmma m64nBNk16
//   (bf16 in, fp32 sums in registers) with A K-major and W (stored K x N,
//   row-major) MN-major from shared memory; a producer warpgroup's one
//   thread streams K in 64-deep chunks by TMA (a bf16 A's 64 x 64 box in
//   128 B swizzle, a bf16 W's 64 x BN box in 128 B swizzle at BN = 64, 64 B
//   at 32) through a ring of WG_STAGES = 4 slots guarded by full / empty
//   mbarriers, so a K of 256 is in flight at once; setmaxnreg moves the
//   producer's registers to the consumer.
// - ffn1's second operand is its own tensor map: the chunks of A come
//   first, then those of A2 with W's rows from k1 on, so the concat is
//   never materialised. A chunk's columns past its operand's width arrive
//   from TMA as zeros and meet real W rows: their products are exact zeros.
// - The tile (wg_tile_n; kernels/layer_stack.py:linear_plan mirrors it):
//   BM = 64, so a tile never straddles two pairs; BN = 64 where one pair's
//   rows still give WG_FILL = 128 blocks, else 32: at 1024 rows qkv, ffn1
//   and qk_v take 64 (192, 128, 128 blocks), out and ffn2 (N = 256) 32
//   (128). The rule reads one pair's rows and never the batch, and there is
//   no split-K: an output's sum runs in one order in every run and batch.
// - Launched as a programmatic dependent of the stream's previous kernel
//   (WG_PDL): the barriers are initialised and the tensor maps prefetched
//   while that kernel drains, then every thread waits for it
//   (griddepcontrol.wait) before a load, the liveness test or a store.
// - The epilogue is the reference's: round acc to T, add the bias (rounded
//   to T) in T and round, add the residual in T and round; a pair rounds in
//   one packed conversion and the last rounding is the store's own.
// - TMA needs a, a2 and w on 16 B with rows of a multiple of 16 B (k1, K -
//   k1 and N multiples of 8): the wrapper raises on an operand it cannot
//   address.
// The same kernel takes the operand modes of the other rungs (template
// arguments: A/activation type, weight type, bias type, output type); what
// TMA cannot hand to wgmma as it lies, the consumer converts into a bf16
// copy in the slot, in the layout TMA's swizzle would have given, and
// fences the async proxy before wgmma reads it:
// - BF16: bf16 A, W, bias, residual and Y.
// - MIXED (fp32 activations, bf16 products; JAX _linear :373-375 with
//   dt = fp32, attn_dtype = bf16): fp32 A, A2 and residual; A arrives raw
//   and is rounded to bf16; bf16 W; fp32 bias; the epilogue in fp32 with no
//   rounding. Y is fp32, or bf16 for the qkv and qk_v projections, whose
//   only reader is the attention (the reference's .astype(attn_dtype) of
//   the fp32 result, one rounding).
// - INT8 weight-only (JAX _take_linear :245-249): int8 W with an fp32
//   scale per output channel; W arrives raw and is dequantized,
//   bf16(float(w_q) * scale); bf16 activations; the fp32 bias rounded to
//   bf16 in the epilogue. The product is linear(a, dequantize(w)) bit for
//   bit: the same B values in the same k order.
//
// The W8A8 kernels (LGTPU_W8A8=1 on the INT8 rung, JAX _aquant :339-346,
// _doti8 :348-355, _linear's q8 branch :368-372, the qkv path :418-428)
// multiply int8 activations by int8 weights on the tensor cores: mma.sync
// m16n8k32, s8 in, s32 sums. At M = 1024, K <= 512, N <= 768 a product is
// at most 0.54 GOP (0.27 us at 1,979 TOP/s) on at most 2.3 MB (0.69 us at
// 3.35 TB/s): the bytes bound it, and a launch is short enough that its
// latency (every load's trip from L2) sets the pace.
// - row_quant_kernel quantizes each row of [A | A2] once (its own launch):
//   amax over the whole row (ffn1: over x and the message together), sa =
//   max(amax, 1e-6) / 127 as the reference writes it (* (1/127)), q =
//   clip(rint(v / sa), -127, 127) with a true division and round-half-even.
//   16 B loads of 8 bf16 values, 16 values a lane, 16 lanes a row where K
//   <= 256 (two rows a warp), one 16 B store of q a lane; two-warp blocks,
//   256 of them at M = 1024, K = 256.
// - linear_s8_kernel takes the weight K-major, W^T (N, K): the INT8 tree's
//   w_t, laid out once where the tree is placed (runtime/weights.py), so
//   both operands' fragments load by ldmatrix from rows of K bytes, with no
//   byte transposes (the s8 fragment is four consecutive k bytes of one row
//   or column). A block stages its A and W^T rows whole, K <= 512 (64 x 512
//   + 64 x 512 bytes at most), issuing every 128-byte cp.async group up
//   front and multiplying each as it lands; rows at a pitch of K + 16 bytes
//   (an odd count of 16 B units: an ldmatrix's eight rows in different
//   banks). A block is 8 warps over a tile of 2 x 2, 1 x 2 or 1 x 1 warp
//   tiles of 32 x 32 outputs (2 m16 x 4 n8: 4 ldmatrix for 8 mma per k32
//   step), the warps left over splitting the k32 steps 2, 4 or 8 ways: so
//   a 1-block-per-SM grid still has 8 warps to issue its copies and its
//   products. s8_plan takes the first tile that gives 128 blocks
//   (kernels/layer_stack.py:s8_plan mirrors it): at M = 1024 qkv, ffn1 and
//   qk_v take 64 x 64, out and ffn2 (N = 256) 32 x 64. The warps' sums
//   meet in an int32 tile in shared memory (atomic adds: integers, exact in
//   any order), and the epilogue reads it eight outputs a thread, so the
//   residual loads and the stores of y are 16 B and coalesced.
// - Both launch as programmatic dependents of the stream's previous kernel
//   (Hopper's PDL, S8_PDL): each is set up while its predecessor runs and
//   waits for it in the kernel (griddepcontrol.wait), row_quant before its
//   loads, the GEMM after staging its weights, scale, bias and residual
//   (written before row_quant ran). row_quant sets no early trigger: the
//   GEMM starting while row_quant ran made the pair slower.
//   scripts/tune_torch_w8a8.py times each choice (PERF.md).
// - K <= 512, so |acc| <= 512 * 127^2 < 2^24: the s32 sum and its
//   conversion to fp32 are exact, whatever the order. The epilogue is the
//   reference's: y = (float(acc) * sa) * scale, rounded to bf16, + the bias
//   rounded to bf16, + the residual in bf16.
//
// The FP32 kernel (linear_tf32_wgmma_kernel, the fp32 rung) runs the
// products on wgmma in 3xTF32: one TF32 product keeps about three decimal
// digits and misses the fp32 gate of 1e-4, so each operand x is split into
// hi (x with its low 13 bits cleared, mma.cuh:split_tf32_rz) and lo = x -
// hi, and every product is hi.lo + lo.hi + hi.hi on m64nNk8 with fp32 sums
// (the small terms first, lo.lo dropped; hopper.cuh).
// - wgmma reads a tf32 operand in shared memory K-major only, and W is
//   stored (K, N), its output dimension contiguous. Of the two ways out (a
//   K-major fp32 copy of every fp32 weight laid out at placement, which
//   then has to reach the converter, the .pth path, the TP shards and the
//   exported programs; or the product taken as its transpose), the kernel
//   takes the second, which leaves every weight as it is: Y^T = W^T . X^T,
//   W^T as the register-A operand, read from W's TMA tile (two [64 k][32 n]
//   halves in 128 B swizzle, so a warp's fragment loads meet at most two to
//   a bank) and split in registers; X, K-major as it lies, is the B operand
//   as TMA writes it (two [BR][32] halves in 128 B swizzle), with its lo
//   copy written beside it by the consumer (hopper.cuh:tf32_lo_copy), then
//   fence.proxy.async.
// - A tile is 64 output columns (wgmma's M) x BR rows, BR = 64 where one
//   pair's rows still give WG_FILL blocks, else 32 (tf_tile_rows, the bf16
//   rule with the roles swapped); one consumer warpgroup (setmaxnreg) and a
//   producer warpgroup whose one thread streams the 64-deep chunks of A,
//   then A2, with W's rows by TMA through a ring of slots (48 KB each at
//   BR = 64, 32 KB at 32): four, a K of 256 in flight at once and one block
//   an SM, while the launch's blocks fit the SMs, else two at two blocks an
//   SM (tf_stages: one pair's qkv, 192 blocks, ran 11.4 us a call at two
//   slots against 17.1 at four, in two waves; the other projections 4-15 %
//   faster at four, scripts/tune_torch_fp32_wgmma.py); no split-K, so every
//   output sums in one order at any batch. One chunk's products stay in flight while the
//   next chunk's W fragments load into a second register set.
// - The epilogue stores the transpose: accumulator row r is output column
//   n0 + r, column c output row m0 + c; + bias, + residual in fp32 (the
//   reference's rounding to T is the identity). A warp's stores cover four
//   rows of 32 B each.
// - Bound at 3xTF32: 3 x 0.13-0.54 GFLOP a call at 495 TFLOP/s, 0.8-3.3 us,
//   above the 0.7-1.6 us of its fp32 bytes.
// - TMA needs a, a2 and w on 16 B with rows of a multiple of 16 B (k1, K -
//   k1 and N multiples of 4): the wrapper raises on an operand it cannot
//   address. Liveness, ffn1's two operands and the launch as a
//   programmatic dependent are linear_wgmma_kernel's.
//
// Liveness (transformer_stack_adaptive, wrapper :974, pallas_call :1229):
// with an exit register (B,) fp32 and the global layer g, a tile whose pair
// has exit <= g (rows_per_pair % 64 == 0 and BM divides 64, so a tile holds
// one pair) skips the product, the pl.when(live) gate of :734-745. With a
// residual (ffn2) it writes y = R, so a retired pair's activations pass
// through the layer bit for bit; without one its rows are left unwritten
// and never read.

#include <type_traits>

#include "hopper.cuh"

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
// The bf16-product kernel: a warpgroup on wgmma, fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int WG_BK = 64;       // K depth of a chunk (one 128 B row of bf16 A)
constexpr int WG_STAGES = 4;    // chunk slots of the ring: K = 256 is in flight at once
constexpr int WG_FILL = 128;    // blocks one pair's tile rule aims for: about one per SM
constexpr int WG_PDL = 1;       // launched as a programmatic dependent
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 216;  // setmaxnreg: (40 + 216) * 128 = 256 * 128

// A ring slot, bytes: A's chunk as TMA writes it (64 x 64 of TA: bf16 in
// 128 B swizzle, or raw fp32), its bf16 copy (fp32 A only), W's chunk as TMA
// writes it (64 x BN of TW: bf16 one swizzle atom wide, or raw int8) and its
// dequantized bf16 copy (int8 W only); each part on 1024 B
template <typename TA, typename TW>
struct WgSlot {
  static constexpr bool A_BF16 = std::is_same<TA, bf16_t>::value;
  static constexpr bool W_BF16 = std::is_same<TW, bf16_t>::value;
  static constexpr int A_RAW = 64 * WG_BK * (int)sizeof(TA);
  static constexpr int A_BF = A_BF16 ? 0 : 64 * WG_BK * 2;
  __host__ __device__ static constexpr int w_raw(int BN) { return WG_BK * BN * (int)sizeof(TW); }
  __host__ __device__ static constexpr int w_bf(int BN) { return W_BF16 ? 0 : WG_BK * BN * 2; }
  __host__ __device__ static constexpr int bytes(int BN) {
    return A_RAW + A_BF + w_raw(BN) + w_bf(BN);
  }
  __host__ __device__ static constexpr int tx(int BN) { return A_RAW + w_raw(BN); }  // TMA bytes
};
// the ring, its barriers, and 1 KB to align the ring to 1024 B (the swizzle atom)
template <typename TA, typename TW>
constexpr size_t wg_smem(int BN) {
  return WG_STAGES * (WgSlot<TA, TW>::bytes(BN) + 2 * sizeof(uint64_t)) + 1024;
}

// a pair rounded through T: bf16 in one packed conversion (to nearest
// even, as round_to), fp32 as it is
template <typename T>
__device__ __forceinline__ void round_pair(float& a, float& b) {
  if constexpr (std::is_same<T, bf16_t>::value) {
    const unsigned p = pack_bf16(a, b);
    a = __uint_as_float(p << 16);
    b = __uint_as_float(p & 0xffff0000u);
  }
}

// Y = [A | A2] . W + b (+ R) for a 64 x BN tile: a consumer warpgroup runs
// the product (wgmma m64nBNk16, A K-major and W MN-major from the ring), a
// producer warpgroup's one thread streams the chunks of A (na of them), then
// of A2 (na2), each with W's rows at its K offset (A2's from k1), so the
// concat is never materialised. A chunk's columns past its operand's width
// arrive as zeros, which meet W's next rows: their products are exact zeros.
// MIXED's fp32 A and INT8's int8 W arrive raw; the consumer rounds A to bf16
// (or dequantizes W, bf16(float(w_q) * scale)) into the slot's bf16 copy in
// the layout TMA's swizzle would give, then fences the async proxy before
// wgmma reads it.
template <int BN, typename TA, typename TW, typename TB, typename TO>
__global__ void __launch_bounds__(256, 2)
linear_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap a2map,
                    const __grid_constant__ CUtensorMap wmap, int na, int na2, int k1,
                    const float* __restrict__ wscale, const TB* __restrict__ bias,
                    const TA* __restrict__ res, TO* __restrict__ y, int M, int N,
                    const float* __restrict__ exit_reg, int layer, int rows_per_pair) {
  using S = WgSlot<TA, TW>;
  constexpr int ROW = BN >= 64 ? 128 : 2 * BN;  // bytes of a bf16 W row in the slot
  extern __shared__ __align__(1024) unsigned char wg_raw[];
  unsigned char* const ring = align1024(wg_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + WG_STAGES * S::bytes(BN));
  uint64_t* const empty = full + WG_STAGES;
  auto slot = [&](int s) { return ring + s * S::bytes(BN); };
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * BN;
  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  } else if (tid == 128) {
    tma_prefetch(&amap);
    if (na2) tma_prefetch(&a2map);
    tma_prefetch(&wmap);
  }
  __syncthreads();
  wait_prerequisites();  // every operand, the exit register, and y's readers
  if (retired(exit_reg, layer, rows_per_pair, m0, n0, 64, BN, M, N, res, y, tid, 256)) return;

  const int nk = na + na2;
  if (tid >= 128) {  // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 128) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % WG_STAGES;
        mbar_wait(empty + s, ((t / WG_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, S::tx(BN));
        const bool first = t < na;
        const int kc = first ? t * WG_BK : (t - na) * WG_BK;  // column in its operand
        tma_load(slot(s), first ? &amap : &a2map, full + s, kc, m0);
        unsigned char* wt = slot(s) + S::A_RAW + S::A_BF;
        constexpr int BOX = S::W_BF16 ? ROW / 2 : BN;  // columns of a W box
#pragma unroll
        for (int x = 0; x < BN / BOX; ++x)  // bf16: one box per swizzle atom of columns
          tma_load(wt + x * WG_BK * BOX * (int)sizeof(TW), &wmap, full + s, n0 + x * BOX,
                   first ? kc : k1 + kc);
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;  // accumulator row and column pair
  // int8 W: this thread dequantizes columns 8 c .. 8 c + 7 of the tile
  // (the same in every chunk), their scales read once
  constexpr int WG8 = BN / 8;  // 8-column groups of a W row
  float sc[8];
  if constexpr (!S::W_BF16) {
#pragma unroll
    for (int e = 0; e < 8; ++e) sc[e] = wscale[n0 + (tid % WG8) * 8 + e];
  }
  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  // one chunk's products in flight while the next chunk's start: the
  // slot of chunk t - 1 is released once chunk t's are committed and chunk
  // t - 1's have completed
  for (int t = 0; t < nk; ++t) {
    const int s = t % WG_STAGES;
    mbar_wait(full + s, (t / WG_STAGES) & 1);
    unsigned char* const at = slot(s);
    unsigned char* const abf = at + S::A_RAW;          // fp32 A's bf16 copy
    unsigned char* const wt = abf + S::A_BF;           // W as TMA wrote it
    unsigned char* const wbf = wt + S::w_raw(BN);      // int8 W's bf16 copy
    if constexpr (!S::A_BF16) {  // fp32 A rows -> bf16, 128 B swizzle (16 B unit c of row r at c ^ r % 8)
      const float* src = reinterpret_cast<const float*>(at);
#pragma unroll
      for (int q = 0; q < 64 * 8 / 128; ++q) {
        const int it = tid + 128 * q, r = it / 8, c = it % 8;
        const float4 lo = *reinterpret_cast<const float4*>(src + r * WG_BK + 8 * c);
        const float4 hi = *reinterpret_cast<const float4*>(src + r * WG_BK + 8 * c + 4);
        *reinterpret_cast<uint4*>(abf + r * 128 + ((c ^ (r & 7)) * 16)) =
            make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                       pack_bf16(hi.z, hi.w));
      }
    }
    if constexpr (!S::W_BF16) {  // int8 W rows -> bf16(float(w_q) * scale), ROW-byte swizzle
      const int c = tid % WG8;
#pragma unroll
      for (int q = 0; q < WG_BK * WG8 / 128; ++q) {
        const int k = (tid + 128 * q) / WG8;
        const int2 raw = *reinterpret_cast<const int2*>(wt + k * BN + 8 * c);
        const int8_t* w8 = reinterpret_cast<const int8_t*>(&raw);
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __fmul_rn(static_cast<float>(w8[e]), sc[e]);
        const int unit = BN >= 64 ? c ^ (k & 7) : c ^ ((k >> 1) & 3);
        *reinterpret_cast<uint4*>(wbf + k * ROW + unit * 16) =
            make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                       pack_bf16(v[6], v[7]));
      }
    }
    if constexpr (!S::A_BF16 || !S::W_BF16) {
      fence_proxy_async();  // the copies, written by threads, visible to wgmma
      bar_sync(1, 128);
    }
    const unsigned char* ma = S::A_BF16 ? at : abf;
    const unsigned char* mw = S::W_BF16 ? wt : wbf;
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < WG_BK / 16; ++k16) {
      if constexpr (BN == 64)
        wgmma_m64n64<1>(acc, kmajor_desc(ma, k16), mnmajor_desc(mw, ROW, k16), 1);
      else
        wgmma_m64n32<1>(acc, kmajor_desc(ma, k16), mnmajor_desc(mw, ROW, k16), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_operand(acc);
    __syncwarp();
    if (t > 0 && lane == 0) mbar_arrive(empty + (t - 1) % WG_STAGES);
  }
  wgmma_wait<0>();
  fence_operand(acc);

  // epilogue: round acc to TA, + bias rounded to TA, + residual in TA (TA =
  // fp32: no rounding), one cast to TO. A pair rounds in one packed
  // conversion, and the last rounding to TA is the store's own (TA is TO,
  // or fp32)
#pragma unroll
  for (int e = 0; e < BN / 2; e += 2) {
    const int gm = m0 + 16 * warp + g + 8 * ((e / 2) & 1);
    const int gn = n0 + 8 * (e / 4) + 2 * t4;
    if (gm >= M) continue;
    float v0 = acc[e], v1 = acc[e + 1];
    round_pair<TA>(v0, v1);
    float b0 = to_f(bias[gn]), b1 = to_f(bias[gn + 1]);
    if constexpr (!std::is_same<TB, TA>::value) round_pair<TA>(b0, b1);
    v0 += b0, v1 += b1;
    if (res) {
      round_pair<TA>(v0, v1);
      v0 += to_f(res[(size_t)gm * N + gn]), v1 += to_f(res[(size_t)gm * N + gn + 1]);
    }
    store2(y + (size_t)gm * N + gn, v0, v1);
  }
}

// ---------------------------------------------------------------------------
// The FP32 kernel: 3xTF32 on wgmma, Y^T = W^T . X^T
// ---------------------------------------------------------------------------

constexpr int TF_BK = 64;      // K depth of a chunk: eight k8 steps, two 128 B atoms of fp32
// chunk slots of the ring: 4 (a K of 256 in flight at once, one block an
// SM) while the launch's blocks fit the SMs, else 2 (two blocks an SM)
constexpr int TF_DEEP = 4, TF_SHALLOW = 2, TF_SMS = 132;

// A ring slot, bytes: X's chunk as TMA writes it (BR rows of 64 fp32 as two
// [BR][32] halves in 128 B swizzle), its lo copy in the same layout, and W's
// chunk (64 k rows of the tile's 64 columns as two [64][32] halves in 128 B
// swizzle); each part on 1024 B
template <int BR>
struct TfSlot {
  static constexpr int X = BR * TF_BK * 4;
  static constexpr int W = TF_BK * 64 * 4;
  static constexpr int BYTES = 2 * X + W;
  static constexpr int TX = X + W;  // TMA bytes
};
// the ring, its barriers, and 1 KB to align the ring to 1024 B
template <int BR, int STAGES>
constexpr size_t tf_smem() {
  return STAGES * (TfSlot<BR>::BYTES + 2 * sizeof(uint64_t)) + 1024;
}

// W^T's A fragments of one 64-deep chunk, split: this thread's rows (output
// columns) 16 w + g and + 8, k = 8 kk + t4 and + 4, read from W's chunk
// ([k][n] in two 128 B-swizzled halves: float n % 4 of 16 B unit (n % 32) /
// 4 ^ k % 8 of row k of half n / 32)
__device__ __forceinline__ void w_frags(const unsigned char* wt, int warp, int g, int t4,
                                        unsigned (&wh)[TF_BK / 8][4],
                                        unsigned (&wl)[TF_BK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < TF_BK / 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 16 * warp + g + 8 * (i & 1), k = 8 * kk + t4 + 4 * (i >> 1);
      const float x = *reinterpret_cast<const float*>(
          wt + (n / 32) * TF_BK * 128 + k * 128 + ((((n % 32) / 4) ^ (k % 8)) * 16) + (n % 4) * 4);
      split_tf32_rz(x, wh[kk][i], wl[kk][i]);
    }
  }
}

// Y = [A | A2] . W + b (+ R), all fp32, for 64 output columns x BR rows,
// computed as its transpose Y^T = W^T . X^T: W^T is wgmma's register-A
// operand (a tf32 operand in shared memory is read K-major only, and W is
// stored (K, N)), loaded from its TMA tile and split in registers; X (the
// activations, K contiguous) is the K-major B operand as TMA writes it, with
// its lo copy written by the consumer. Each k8 step is three m64nBRk8
// products, the small terms first (W_hi.X_lo, W_lo.X_hi, then W_hi.X_hi).
// A producer warpgroup's one thread streams the chunks of A (na of them),
// then of A2 (na2), each with W's rows at its K offset, as
// linear_wgmma_kernel's does; one chunk's products stay in flight while the
// next chunk's fragments load (two register sets).
template <int BR, int STAGES>
__global__ void __launch_bounds__(256, STAGES == TF_SHALLOW ? 2 : 1)
linear_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                         const __grid_constant__ CUtensorMap a2map,
                         const __grid_constant__ CUtensorMap wmap, int na, int na2, int k1,
                         const float* __restrict__ bias, const float* __restrict__ res,
                         float* __restrict__ y, int M, int N, const float* __restrict__ exit_reg,
                         int layer, int rows_per_pair) {
  using S = TfSlot<BR>;
  extern __shared__ __align__(1024) unsigned char wg_raw[];
  unsigned char* const ring = align1024(wg_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + STAGES * S::BYTES);
  uint64_t* const empty = full + STAGES;
  auto slot = [&](int s) { return ring + s * S::BYTES; };
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BR, n0 = blockIdx.x * 64;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  } else if (tid == 128) {
    tma_prefetch(&amap);
    if (na2) tma_prefetch(&a2map);
    tma_prefetch(&wmap);
  }
  __syncthreads();
  wait_prerequisites();  // every operand, the exit register, and y's readers
  if (retired(exit_reg, layer, rows_per_pair, m0, n0, BR, 64, M, N, res, y, tid, 256)) return;

  const int nk = na + na2;
  if (tid >= 128) {  // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 128) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty + s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, S::TX);
        const bool first = t < na;
        const int kc = first ? t * TF_BK : (t - na) * TF_BK;  // column in its operand
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the two 32-float halves of X's and W's chunks
          tma_load(slot(s) + h * BR * 128, first ? &amap : &a2map, full + s, kc + 32 * h, m0);
          tma_load(slot(s) + 2 * S::X + h * TF_BK * 128, &wmap, full + s, n0 + 32 * h,
                   first ? kc : k1 + kc);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;  // accumulator row and column pair
  float acc[BR / 2];
#pragma unroll
  for (int e = 0; e < BR / 2; ++e) acc[e] = 0.f;
  // chunk t: X's lo copy, W^T's fragments into (wh, wl), its 24 products
  // committed; then chunk t - 1's are waited for (their fragments, the
  // previous set, are free again) and its slot released
  auto chunk = [&](int t, unsigned (&wh)[TF_BK / 8][4], unsigned (&wl)[TF_BK / 8][4],
                   unsigned (&ph)[TF_BK / 8][4], unsigned (&pl)[TF_BK / 8][4]) {
    const int s = t % STAGES;
    mbar_wait(full + s, (t / STAGES) & 1);
    unsigned char* const xt = slot(s);
    unsigned char* const xlo = xt + S::X;
    tf32_lo_copy(reinterpret_cast<float*>(xt), reinterpret_cast<float*>(xlo), BR * TF_BK, tid,
                 128);
    fence_proxy_async();  // the copy, written by threads, visible to wgmma
    bar_sync(1, 128);
    w_frags(xt + 2 * S::X, warp, g, t4, wh, wl);
    fence_operand(acc);
    wgmma_fence();
    const uint64_t xh = kmajor_desc(xt, 0), xl = kmajor_desc(xlo, 0);
#pragma unroll
    for (int kk = 0; kk < TF_BK / 8; ++kk) {
      if constexpr (BR == 64) {
        wgmma_tf32_m64n64_rs(acc, wh[kk], desc_step_f32(xl, BR, kk), 1);
        wgmma_tf32_m64n64_rs(acc, wl[kk], desc_step_f32(xh, BR, kk), 1);
      } else {
        wgmma_tf32_m64n32_rs(acc, wh[kk], desc_step_f32(xl, BR, kk), 1);
        wgmma_tf32_m64n32_rs(acc, wl[kk], desc_step_f32(xh, BR, kk), 1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < TF_BK / 8; ++kk) {
      if constexpr (BR == 64)
        wgmma_tf32_m64n64_rs(acc, wh[kk], desc_step_f32(xh, BR, kk), 1);
      else
        wgmma_tf32_m64n32_rs(acc, wh[kk], desc_step_f32(xh, BR, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_operand(acc);
#pragma unroll
    for (int kk = 0; kk < TF_BK / 8; ++kk) {  // chunk t - 1's A registers are read
      fence_operand(ph[kk]);
      fence_operand(pl[kk]);
    }
    __syncwarp();
    if (t > 0 && lane == 0) mbar_arrive(empty + (t - 1) % STAGES);
  };
  unsigned wh0[TF_BK / 8][4], wl0[TF_BK / 8][4], wh1[TF_BK / 8][4], wl1[TF_BK / 8][4];
  for (int t = 0; t < nk; t += 2) {
    chunk(t, wh0, wl0, wh1, wl1);
    if (t + 1 < nk) chunk(t + 1, wh1, wl1, wh0, wl0);
  }
  wgmma_wait<0>();
  fence_operand(acc);
#pragma unroll
  for (int kk = 0; kk < TF_BK / 8; ++kk) {
    fence_operand(wh0[kk]), fence_operand(wl0[kk]);
    fence_operand(wh1[kk]), fence_operand(wl1[kk]);
  }

  // epilogue in fp32 (the reference's rounding to T is the identity): acc
  // holds Y^T, element e at output column n0 + 16 w + g + 8 ((e / 2) & 1)
  // and row m0 + 8 (e / 4) + 2 t4 + (e & 1); + bias, + residual
  const int nc = n0 + 16 * warp + g;
  const float b[2] = {bias[nc], bias[nc + 8]};
#pragma unroll
  for (int e = 0; e < BR / 2; ++e) {
    const int gm = m0 + 8 * (e / 4) + 2 * t4 + (e & 1), gn = nc + 8 * ((e / 2) & 1);
    if (gm >= M) continue;
    float v = acc[e] + b[(e / 2) & 1];
    if (res) v += res[(size_t)gm * N + gn];
    y[(size_t)gm * N + gn] = v;
  }
}

// ---------------------------------------------------------------------------
// W8A8: row quantization and the s8 GEMM
// ---------------------------------------------------------------------------

constexpr int QUANT_WARPS = 2;      // warps of a row_quant block
constexpr int S8_MAX_K = 512;       // the widest row the W8A8 kernels take
constexpr int S8_KC = 512;          // K bytes of A in one cp.async group of the s8 GEMM
constexpr int S8_MIN_BLOCKS = 128;  // blocks s8_plan aims for: about one per SM
constexpr int S8_WARPS = 8;         // warps of an s8 GEMM block
constexpr int S8_PDL = 1;           // both W8A8 kernels launched as programmatic dependents

bool on16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// q = clip(rint(v / sa), -127, 127) over each row of [a | a2], sa =
// max(amax, 1e-6) * (1/127), both in fp32 as the reference computes them.
// A lane takes 16 consecutive values of a row (two 16 B loads, one 16 B
// store of q); a row takes 16 lanes where K <= 256 (two rows a warp), else
// 32. aligned: every 8-value segment of a and a2 starts on 16 B.
__global__ void __launch_bounds__(QUANT_WARPS * 32)
row_quant_kernel(const bf16_t* __restrict__ a, const bf16_t* __restrict__ a2, int k1, int K,
                 int M, int8_t* __restrict__ q, float* __restrict__ sa, int aligned) {
  wait_prerequisites();  // a and a2
  const int G = K > 256 ? 32 : 16;  // lanes of a row
  const int lane = threadIdx.x % 32, c0 = 16 * (lane % G);
  const int row = (blockIdx.x * QUANT_WARPS + threadIdx.x / 32) * (32 / G) + lane / G;
  const int k2 = K - k1;
  float v[2][8], amax = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + 8 * h;
    if (row < M && c < K && aligned) {
      load8(c < k1 ? a + (size_t)row * k1 + c : a2 + (size_t)row * k2 + c - k1, v[h], true);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = c + e;
        v[h][e] = row >= M || col >= K ? 0.f
                  : to_f(col < k1 ? a[(size_t)row * k1 + col] : a2[(size_t)row * k2 + col - k1]);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[h][e]));
  }
  for (int o = G / 2; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = __fmul_rn(fmaxf(amax, 1e-6f), static_cast<float>(1.0 / 127.0));
  if (row >= M || c0 >= K) return;
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const float x = v[e / 8][e % 8];
    const int qi = static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f));
    w[e / 4] |= (static_cast<unsigned>(qi) & 0xffu) << (8 * (e % 4));
  }
  *reinterpret_cast<uint4*>(q + (size_t)row * K + c0) = make_uint4(w[0], w[1], w[2], w[3]);
  if (c0 == 0) sa[row] = s;
}

// K rounded up to the k32 step, and the shared row pitch of the s8 GEMM:
// an odd number of 16 B units, so an ldmatrix's eight rows fall in
// different banks
__host__ __device__ constexpr int s8_k32(int K) { return (K + 31) / 32 * 32; }
__host__ __device__ constexpr int s8_pitch(int K) { return s8_k32(K) + 16; }
// the int32 sum tile's row pitch: 16 B aligned rows, its atomic adds
// (lanes at rows g, columns 2 t4) at most two to a bank
__host__ __device__ constexpr int s8_sum_pitch(int TN) { return TN + 4; }

// the s8 GEMM block's shared memory: the TM x TN int32 sums, TM rows of A
// and TN rows of W^T (whole K), the residual tile (bf16), the scale and bias
// of the tile's columns
constexpr size_t s8_smem(int TM, int TN, int K) {
  return sizeof(int) * TM * s8_sum_pitch(TN) + (size_t)(TM + TN) * s8_pitch(K) +
         sizeof(bf16_t) * TM * TN + 2 * sizeof(float) * TN;
}

// 16 B segments [s0, s1) of `rows` rows of src (row pitch sp bytes) into
// dst (row pitch dp bytes) by cp.async, s1 - s0 <= SEGS (a power of two:
// a thread's row and segment by shifts); rows from `valid` on, and segments
// past the row's `bytes`, are zero
template <int THREADS, int SEGS>
__device__ __forceinline__ void s8_copy(void* dst, int dp, const void* src, size_t sp, int rows,
                                        int valid, int bytes, int s0, int s1, int tid) {
  for (int i = tid; i < rows * SEGS; i += THREADS) {
    const int r = i / SEGS, s = s0 + i % SEGS;
    if (s >= s1) continue;
    int8_t* d = static_cast<int8_t*>(dst) + r * dp + 16 * s;
    if (r >= valid || 16 * s >= bytes)
      *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
    else
      cp_async16(d, static_cast<const int8_t*>(src) + r * sp + 16 * s);
  }
}

// s8_copy of A or W^T rows: segments [s0, s1) of K (s1 - s0 <= 32)
template <int THREADS>
__device__ __forceinline__ void s8_copy_k(int8_t* dst, const int8_t* src, int rows, int valid,
                                          int K, int s0, int s1, int tid) {
  if (s1 - s0 <= 16)
    s8_copy<THREADS, 16>(dst, s8_pitch(K), src, K, rows, valid, K, s0, s1, tid);
  else
    s8_copy<THREADS, 32>(dst, s8_pitch(K), src, K, rows, valid, K, s0, s1, tid);
}

// The s8 GEMM's shared memory, carved: sums [TM][TN + 4] int32, A [TM][pitch]
// and W^T [TN][pitch] int8, the residual [TM][TN] bf16, scale and bias [TN]
template <int TM, int TN>
struct S8Smem {
  int* sums;
  int8_t *a, *w;
  bf16_t* res;
  float *scale, *bias;
  __device__ S8Smem(unsigned char* raw, int K)
      : sums(reinterpret_cast<int*>(raw)),
        a(reinterpret_cast<int8_t*>(sums + TM * s8_sum_pitch(TN))),
        w(a + TM * s8_pitch(K)),
        res(reinterpret_cast<bf16_t*>(w + TN * s8_pitch(K))),
        scale(reinterpret_cast<float*>(res + TM * TN)),
        bias(scale + TN) {}
};

// one cp.async group of the block's W^T rows (whole K, zero to K32), the
// scale and bias of its columns and its residual rows; and the int32 sums
// zeroed
template <int TM, int TN, int THREADS>
__device__ __forceinline__ void s8_stage_weights(const S8Smem<TM, TN>& sm,
                                                 const int8_t* __restrict__ wt,
                                                 const float* __restrict__ wscale,
                                                 const float* __restrict__ bias,
                                                 const bf16_t* __restrict__ res, int m0, int n0,
                                                 int M, int N, int K, int tid) {
  s8_copy_k<THREADS>(sm.w, wt + (size_t)n0 * K, TN, TN, K, 0, s8_k32(K) / 16, tid);
  s8_copy<THREADS, TN / 4>(sm.scale, 0, wscale + n0, 0, 1, 1, 4 * TN, 0, TN / 4, tid);
  s8_copy<THREADS, TN / 4>(sm.bias, 0, bias + n0, 0, 1, 1, 4 * TN, 0, TN / 4, tid);
  if (res)
    s8_copy<THREADS, TN / 8>(sm.res, 2 * TN, res + (size_t)m0 * N + n0, 2 * (size_t)N, TM,
                             M - m0, 2 * TN, 0, TN / 8, tid);
  cp_async_commit();
  for (int i = tid; i < TM * s8_sum_pitch(TN) / 4; i += THREADS)
    reinterpret_cast<int4*>(sm.sums)[i] = make_int4(0, 0, 0, 0);
}

// The product of a block's staged rows, A's cp.async group by group as each
// lands (the W^T group was committed first), into the zeroed int32 sums: warp w owns the 32 x 32 outputs (w % (WM WN)) of
// the tile (2 m16 x 4 n8 tiles of mma.sync m16n8k32) and the k32 steps s
// with s % WK == w / (WM WN) (the block's S8_WARPS warps split K WK ways);
// A and W^T fragments by ldmatrix (an 8 x 16-byte matrix is four k bytes a
// lane, the s8 fragment layout of mma.cuh:mma_s8). Each warp adds its
// sums into the tile with shared-memory atomics: integer adds, exact in
// any order.
template <int WM, int WN>
__device__ __forceinline__ void s8_product(const int8_t* as, const int8_t* ws, int* sums, int K) {
  constexpr int WK = S8_WARPS / (WM * WN), SP = s8_sum_pitch(32 * WN);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wk = warp / (WM * WN), wm = warp % (WM * WN) / WN, wn = warp % WN;
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix matrix and row of this lane
  const int P = s8_pitch(K), nc = (s8_k32(K) + S8_KC - 1) / S8_KC;
  const int8_t* at = as + wm * 32 * P;
  const int8_t* bt = ws + wn * 32 * P;
  int acc[2][4][4] = {};
  for (int c = 0; c < nc; ++c) {
    cp_async_wait_n(nc - 1 - c);  // A's group c (and every older one) has landed
    __syncthreads();              // ... for every thread (and the sums are zero)
    const int s0 = c * (S8_KC / 32), send = min(s8_k32(K), (c + 1) * S8_KC) / 32;
    for (int s = s0 + (wk - s0 % WK + WK) % WK; s < send; s += WK) {
      const int kb = 32 * s;
      unsigned af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)  // a0..a3: rows +0 / +8, k bytes +0 / +16
        ldsm_x4(af[mt], reinterpret_cast<const bf16_t*>(
                            at + (mt * 16 + mr + (mi & 1) * 8) * P + kb + (mi >> 1) * 16));
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // b0, b1 of n8 tiles 2 np and 2 np + 1
        unsigned r[4];
        ldsm_x4(r, reinterpret_cast<const bf16_t*>(
                       bt + (np * 16 + mr + (mi >> 1) * 8) * P + kb + (mi & 1) * 16));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_s8(acc[mt][2 * np], af[mt], r[0], r[1]);
          mma_s8(acc[mt][2 * np + 1], af[mt], r[2], r[3]);
        }
      }
    }
  }
  const int g = lane / 4, t4 = lane % 4;  // accumulator row and column pair
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        atomicAdd(sums + (wm * 32 + mt * 16 + g + 8 * (e / 2)) * SP + wn * 32 + nt * 8 + 2 * t4 +
                      e % 2,
                  acc[mt][nt][e]);
}

// y = round((float(acc) * sa) * scale) + round(b) (+ R), bf16, from the
// block's int32 sums and its staged scale, bias and residual: a thread takes
// eight adjacent outputs of a row, one 16 B store; sa: the scales of the
// block's rows (sa[0] is row m0's)
template <int TM, int TN, int THREADS>
__device__ __forceinline__ void s8_epilogue(const S8Smem<TM, TN>& sm, const float* sa, bool res,
                                            bf16_t* __restrict__ y, int m0, int n0, int M,
                                            int N) {
  constexpr int SP = s8_sum_pitch(TN);
  for (int i = threadIdx.x; i < TM * TN / 8; i += THREADS) {
    const int lm = i / (TN / 8), ln = i % (TN / 8) * 8, gm = m0 + lm;
    if (gm >= M) continue;
    const int4 s0 = *reinterpret_cast<const int4*>(sm.sums + lm * SP + ln);
    const int4 s1 = *reinterpret_cast<const int4*>(sm.sums + lm * SP + ln + 4);
    const int acc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    float r[8] = {};
    if (res) load8(sm.res + lm * TN + ln, r, true);
    const float s = sa[lm];
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = round_to<bf16_t>(__fmul_rn(__fmul_rn(static_cast<float>(acc[e]), s), sm.scale[ln + e]));
      v[e] = round_to<bf16_t>(v[e] + round_to<bf16_t>(sm.bias[ln + e]));
      if (res) v[e] = round_to<bf16_t>(v[e] + r[e]);
    }
    store8(y + (size_t)gm * N + n0 + ln, v);
  }
}

// Y = round((float(Aq . Wq) * sa) * scale) + round(b) (+ R), bf16. Aq (M, K)
// int8 row-major, Wq as W^T (N, K) int8 (K-major: each output channel's K
// bytes in a row), both 16 B aligned, K % 16 == 0, K <= 512. A block of
// S8_WARPS warps owns a (32 WM) x (32 WN) tile: it stages its W^T rows whole
// with the epilogue's operands, waits for row_quant (its programmatic
// prerequisite), stages its A rows whole and multiplies, its warps
// splitting K.
template <int WM, int WN>
__global__ void __launch_bounds__(S8_WARPS * 32)
linear_s8_kernel(const int8_t* __restrict__ aq, const float* __restrict__ asc,
                 const int8_t* __restrict__ wt, const float* __restrict__ wscale,
                 const float* __restrict__ bias, const bf16_t* __restrict__ res,
                 bf16_t* __restrict__ y, int M, int N, int K, const float* __restrict__ exit_reg,
                 int layer, int rows_per_pair) {
  constexpr int TM = 32 * WM, TN = 32 * WN, THREADS = S8_WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const S8Smem<TM, TN> sm(smem_raw, K);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  if (retired(exit_reg, layer, rows_per_pair, m0, n0, TM, TN, M, N, res, y, tid, THREADS))
    return;
  // the exit register, weights and residual were written before row_quant
  // ran: row_quant's blocks all passed their own wait before this block began
  s8_stage_weights<TM, TN, THREADS>(sm, wt, wscale, bias, res, m0, n0, M, N, K, tid);
  wait_prerequisites();  // q and sa
  const int k32 = s8_k32(K);
  for (int c = 0; c * S8_KC < k32; ++c) {
    s8_copy_k<THREADS>(sm.a, aq + (size_t)m0 * K, TM, M - m0, K, c * (S8_KC / 16),
                       min(k32, (c + 1) * S8_KC) / 16, tid);
    cp_async_commit();
  }
  s8_product<WM, WN>(sm.a, sm.w, sm.sums, K);
  __syncthreads();  // every warp's sums are in
  s8_epilogue<TM, TN, THREADS>(sm, asc + m0, res != nullptr, y, m0, n0, M, N);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The wgmma GEMM's tile columns for one pair's rows (the batch never
// changes a tile, so a pair's outputs sum in one order at any batch): 64
// where one pair's launch still gives WG_FILL blocks, else 32
// (kernels/layer_stack.py:linear_plan mirrors it). At 1024 rows qkv, ffn1
// and qk_v take 64 (128-192 blocks), out and ffn2 (N = 256) 32 (128).
int wg_tile_n(int rows_per_pair, int N) {
  return (long long)((rows_per_pair + 63) / 64) * (N / 64) >= WG_FILL ? 64 : 32;
}

// a (rows, cols) row-major operand of T in boxes of (box_cols, box_rows),
// written to shared memory in `swizzle` bytes of swizzle (0: as they lie)
template <typename T>
int matrix_map(CUtensorMap* map, const void* base, int rows, int cols, int box_cols,
               int box_rows, int swizzle) {
  const long long pitch = (long long)sizeof(T) * cols;
  if (!tma_aligned(base, pitch)) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return tma_map(map, base, tma_type<T>(), 2, dims, strides, box, swizzle);
}
// ... in boxes of (box_cols, 64 rows): bf16 one swizzle atom wide (box_cols
// * 2 bytes of swizzle), other types as they lie
template <typename T>
int matrix_map(CUtensorMap* map, const void* base, int rows, int cols, int box_cols) {
  return matrix_map<T>(map, base, rows, cols, box_cols, 64, sizeof(T) == 2 ? 2 * box_cols : 0);
}

template <int BN, typename TA, typename TW, typename TB, typename TO>
int launch_wgmma(const void* a, const void* a2, int k1, const void* w, const void* wscale,
                 const void* bias, const void* res, void* y, int M, int N, int K,
                 const void* exit_reg, int layer, int rows_per_pair, cudaStream_t stream) {
  constexpr size_t smem = wg_smem<TA, TW>(BN);
  auto kernel = linear_wgmma_kernel<BN, TA, TW, TB, TO>;
  static const cudaError_t opt_in = cudaFuncSetAttribute(  // above 48 KB: opt in once
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int k2 = K - k1;
  constexpr int WBOX = std::is_same<TW, bf16_t>::value && BN > 64 ? 64 : BN;
  CUtensorMap am, a2m, wm;
  const int errs[3] = {matrix_map<TA>(&am, a, M, k1, WG_BK),
                       k2 ? matrix_map<TA>(&a2m, a2, M, k2, WG_BK) : 0,
                       matrix_map<TW>(&wm, w, K, N, WBOX)};
  for (const int err : errs)
    if (err) return err;
  if (!k2) a2m = am;  // never read
  return static_cast<int>(launch_dependent(
      kernel, dim3(N / BN, (M + 63) / 64), 256, smem, stream, WG_PDL, am, a2m, wm,
      (k1 + WG_BK - 1) / WG_BK, (k2 + WG_BK - 1) / WG_BK, k1, static_cast<const float*>(wscale),
      static_cast<const TB*>(bias), static_cast<const TA*>(res), static_cast<TO*>(y), M, N,
      static_cast<const float*>(exit_reg), layer, rows_per_pair));
}

template <typename TA, typename TW, typename TB, typename TO>
int run_wgmma(const void* a, const void* a2, int k1, const void* w, const void* wscale,
              const void* bias, const void* res, void* y, int M, int N, int K,
              const void* exit_reg, int layer, int rows_per_pair, int, cudaStream_t s) {
  auto run = wg_tile_n(rows_per_pair, N) == 64 ? launch_wgmma<64, TA, TW, TB, TO>
                                               : launch_wgmma<32, TA, TW, TB, TO>;
  return run(a, a2, k1, w, wscale, bias, res, y, M, N, K, exit_reg, layer, rows_per_pair, s);
}

// The fp32 GEMM's tile rows for one pair's rows (its 64 output columns are
// wgmma's M): 64 where one pair's launch still gives WG_FILL blocks, else
// 32, wg_tile_n's rule with the roles swapped (kernels/layer_stack.py:
// linear_plan mirrors it). At 1024 rows qkv, ffn1 and qk_v take 64 (128-192
// blocks), out and ffn2 (N = 256) 32 (128).
int tf_tile_rows(int rows_per_pair, int N) { return wg_tile_n(rows_per_pair, N); }
// its ring's slots: TF_DEEP while the launch's blocks fit the SMs, else
// TF_SHALLOW at two blocks an SM (the slots never change a sum's order)
int tf_stages(int M, int N, int BR) {
  return (long long)((M + BR - 1) / BR) * (N / 64) <= TF_SMS ? TF_DEEP : TF_SHALLOW;
}

template <int BR, int STAGES>
int launch_tf32(const void* a, const void* a2, int k1, const void* w, const void* bias,
                const void* res, void* y, int M, int N, int K, const void* exit_reg, int layer,
                int rows_per_pair, cudaStream_t stream) {
  constexpr size_t smem = tf_smem<BR, STAGES>();
  auto kernel = linear_tf32_wgmma_kernel<BR, STAGES>;
  static const cudaError_t opt_in = cudaFuncSetAttribute(  // above 48 KB: opt in once
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int k2 = K - k1;
  CUtensorMap am, a2m, wm;  // 32-float boxes (one 128 B atom) in 128 B swizzle
  const int errs[3] = {matrix_map<float>(&am, a, M, k1, 32, BR, 128),
                       k2 ? matrix_map<float>(&a2m, a2, M, k2, 32, BR, 128) : 0,
                       matrix_map<float>(&wm, w, K, N, 32, TF_BK, 128)};
  for (const int err : errs)
    if (err) return err;
  if (!k2) a2m = am;  // never read
  return static_cast<int>(launch_dependent(
      kernel, dim3(N / 64, (M + BR - 1) / BR), 256, smem, stream, WG_PDL, am, a2m, wm,
      (k1 + TF_BK - 1) / TF_BK, (k2 + TF_BK - 1) / TF_BK, k1, static_cast<const float*>(bias),
      static_cast<const float*>(res), static_cast<float*>(y), M, N,
      static_cast<const float*>(exit_reg), layer, rows_per_pair));
}

int run_tf32(const void* a, const void* a2, int k1, const void* w, const void*,
             const void* bias, const void* res, void* y, int M, int N, int K,
             const void* exit_reg, int layer, int rows_per_pair, int, cudaStream_t s) {
  const int br = tf_tile_rows(rows_per_pair, N);
  auto run = tf_stages(M, N, br) == TF_DEEP
                 ? (br == 64 ? launch_tf32<64, TF_DEEP> : launch_tf32<32, TF_DEEP>)
                 : (br == 64 ? launch_tf32<64, TF_SHALLOW> : launch_tf32<32, TF_SHALLOW>);
  return run(a, a2, k1, w, bias, res, y, M, N, K, exit_reg, layer, rows_per_pair, s);
}

// The s8 GEMM's warp tiles (along M, along N; 32 x 32 outputs each) for an
// M x N product: 2 x 2 (64 x 64 outputs a block) where that gives
// S8_MIN_BLOCKS blocks, else 1 x 2 (32 x 64), else 1 x 1; the block's other
// warps split K (kernels/layer_stack.py:s8_plan mirrors it)
void s8_plan(int M, int N, int* wm, int* wn) {
  const int tiles[3][2] = {{2, 2}, {1, 2}, {1, 1}};
  for (const auto& t : tiles) {
    *wm = t[0], *wn = t[1];
    if ((long long)((M + 32 * t[0] - 1) / (32 * t[0])) * (N / (32 * t[1])) >= S8_MIN_BLOCKS)
      return;
  }
}

template <int WM, int WN>
int launch_s8(const void* aq, const void* asc, const void* wt, const void* wscale,
              const void* bias, const void* res, void* y, int M, int N, int K,
              const void* exit_reg, int layer, int rows_per_pair, cudaStream_t stream) {
  constexpr int TM = 32 * WM, TN = 32 * WN;
  auto kernel = linear_s8_kernel<WM, WN>;
  static bool opted_in = false;  // raised once to the widest K, not per launch
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(s8_smem(TM, TN, S8_MAX_K)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  return static_cast<int>(launch_dependent(
      kernel, dim3(N / TN, (M + TM - 1) / TM), S8_WARPS * 32, s8_smem(TM, TN, K), stream, S8_PDL,
      static_cast<const int8_t*>(aq), static_cast<const float*>(asc),
      static_cast<const int8_t*>(wt), static_cast<const float*>(wscale),
      static_cast<const float*>(bias), static_cast<const bf16_t*>(res), static_cast<bf16_t*>(y),
      M, N, K, static_cast<const float*>(exit_reg), layer, rows_per_pair));
}

// operand modes of lg_linear (kernels/layer_stack.py:_LINEAR_MODES mirrors them)
enum Mode { FP32 = 0, BF16 = 1, MIXED = 2, MIXED_BF16_OUT = 3, INT8_WEIGHTS = 4 };

}  // namespace

// a: (M, k1); a2: (M, K - k1) or null with k1 == K; w: (K, N); wscale:
// (N,) fp32 for int8 weights, else null; bias: (N,); res: (M, N) or null;
// y: (M, N). N % 64 == 0, K % 16 == 0. mode: FP32 (all fp32, 3xTF32), BF16
// (all bf16), MIXED (fp32 a, a2, bias, res and y, bf16 w), MIXED_BF16_OUT
// (as MIXED with a bf16 y, no residual), INT8_WEIGHTS (bf16 a, a2, res and
// y, int8 w with wscale, fp32 bias). exit_reg: (B,) fp32 or null; layer:
// the global layer index; the rows of pair b are [b * rows_per_pair, (b +
// 1) * rows_per_pair) (M itself for a product of no pairs). BF16, MIXED and
// INT8 run linear_wgmma_kernel at wg_tile_n's tile, FP32
// linear_tf32_wgmma_kernel at tf_tile_rows' (a, a2 and w on 16 B, their
// rows of a multiple of 16 B: TMA addresses them; else
// cudaErrorInvalidValue).
extern "C" int lg_linear(const void* a, const void* a2, int k1, const void* w,
                         const void* wscale, const void* bias, const void* res, void* y, int M,
                         int N, int K, const void* exit_reg, int layer, int rows_per_pair,
                         int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = mode == FP32 && !wscale ? run_tf32
             : mode == BF16 ? run_wgmma<bf16_t, bf16_t, bf16_t, bf16_t>
             : mode == MIXED ? run_wgmma<float, bf16_t, float, float>
             : mode == MIXED_BF16_OUT && !res ? run_wgmma<float, bf16_t, float, bf16_t>
             : mode == INT8_WEIGHTS && wscale ? run_wgmma<bf16_t, int8_t, float, bf16_t>
                                              : nullptr;
  if (!run) return static_cast<int>(cudaErrorInvalidValue);
  return run(a, a2, k1, w, wscale, bias, res, y, M, N, K, exit_reg, layer, rows_per_pair, 0, s);
}

// W8A8, step 1: a (M, k1) and a2 (M, K - k1) bf16 (a2 null with k1 == K),
// K % 16 == 0, K <= 512, quantized per row of [a | a2] into q (M, K) int8
// (16 B aligned) and sa (M,) fp32.
extern "C" int lg_row_quant(const void* a, const void* a2, int k1, int K, int M, void* q,
                            void* sa, void* stream) {
  if (K % 16 || K > S8_MAX_K || !on16(q)) return static_cast<int>(cudaErrorInvalidValue);
  const int aligned = on16(a) && on16(a2) && k1 % 8 == 0;
  const int rows = QUANT_WARPS * (K > 256 ? 1 : 2);  // rows of a block
  return static_cast<int>(launch_dependent(
      row_quant_kernel, dim3((M + rows - 1) / rows), QUANT_WARPS * 32, 0,
      static_cast<cudaStream_t>(stream), S8_PDL, static_cast<const bf16_t*>(a),
      static_cast<const bf16_t*>(a2), k1, K, M, static_cast<int8_t*>(q), static_cast<float*>(sa),
      aligned));
}

// W8A8, step 2: y (M, N) bf16 = the s8 product of q (M, K) and the weight
// given K-major, wt (N, K) int8 (row n: output channel n's K weights),
// dequantized by sa (M,) and wscale (N,) fp32, + bias (N,) fp32 (+ res (M,
// N) bf16). K % 16 == 0, K <= 512, N % 64 == 0, every pointer 16 B
// aligned. Liveness as lg_linear; the block is s8_plan's.
extern "C" int lg_linear_s8(const void* q, const void* sa, const void* wt, const void* wscale,
                            const void* bias, const void* res, void* y, int M, int N, int K,
                            const void* exit_reg, int layer, int rows_per_pair, void* stream) {
  if (K % 16 || K > S8_MAX_K || N % 64 || !on16(q) || !on16(wt) || !on16(wscale) ||
      !on16(bias) || !on16(res) || !on16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  int wm, wn;
  s8_plan(M, N, &wm, &wn);
  auto run = wm == 2 ? launch_s8<2, 2> : wn == 2 ? launch_s8<1, 2> : launch_s8<1, 1>;
  return run(q, sa, wt, wscale, bias, res, y, M, N, K, exit_reg, layer, rows_per_pair,
             static_cast<cudaStream_t>(stream));
}

// The s8 GEMM's plan at this shape: (rows, columns) of a block's tile and
// its dynamic shared memory in bytes into plan[0..2] (the wrapper's
// s8_plan is held against it).
extern "C" int lg_s8_plan(int M, int N, int K, int* plan) {
  int wm, wn;
  s8_plan(M, N, &wm, &wn);
  plan[0] = 32 * wm, plan[1] = 32 * wn;
  plan[2] = static_cast<int>(s8_smem(plan[0], plan[1], K));
  return 0;
}

// lg_linear's launch at this shape in this mode into plan[0..4]: the tile's
// rows and columns, the ring's chunk slots, the block's dynamic shared memory
// in bytes, and 1 where the kernel is linear_wgmma_kernel (BF16, MIXED,
// INT8), 0 for linear_tf32_wgmma_kernel (FP32) (the wrapper's linear_plan is
// held against it)
extern "C" int lg_linear_plan(int M, int N, int rows_per_pair, int mode, int* plan) {
  if (mode != FP32) {
    const int tn = wg_tile_n(rows_per_pair, N);
    const size_t smem = mode == BF16 ? wg_smem<bf16_t, bf16_t>(tn)
                        : mode == INT8_WEIGHTS ? wg_smem<bf16_t, int8_t>(tn)
                                               : wg_smem<float, bf16_t>(tn);
    plan[0] = 64, plan[1] = tn, plan[2] = WG_STAGES;
    plan[3] = static_cast<int>(smem), plan[4] = 1;
    return 0;
  }
  const int br = tf_tile_rows(rows_per_pair, N), stages = tf_stages(M, N, br);
  plan[0] = br, plan[1] = 64, plan[2] = stages;
  plan[3] = static_cast<int>(stages == TF_DEEP ? (br == 64 ? tf_smem<64, TF_DEEP>()
                                                          : tf_smem<32, TF_DEEP>())
                                               : (br == 64 ? tf_smem<64, TF_SHALLOW>()
                                                           : tf_smem<32, TF_SHALLOW>()));
  plan[4] = 0;
  return 0;
}
