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
// The BF16 kernel (attention_wgmma_kernel) is built in Hopper's shape from
// hopper.cuh's pieces:
// - SPLIT = 8 consumers split each 64-row tile's 64-key chunks, chunk j to
//   consumer j % 8. A consumer is a warpgroup: S = Q.K^T is four wgmma
//   m64n64k16 with Q and K both K-major from shared memory; P.V takes P
//   from registers, the S accumulator rounded to bf16 pairs (wgmma's
//   register-A form, as FlashAttention-3), and V as the MN-major B
//   operand: bf16 in, fp32 sums. Each block has four consumer warpgroups
//   and a producer warpgroup, whose warp r's lane 0 feeds warpgroup r's
//   ring of two slots by TMA (Q once; K in pass 1, V or K and V in pass
//   2; 64 x 64 boxes in 128 B swizzle) behind full / empty mbarriers;
//   setmaxnreg moves the producer's registers to the consumers.
// - Two forms of the same split (Split): a cluster of two blocks a tile,
//   one consumer a warpgroup, meeting through distributed shared memory,
//   while the launch's blocks fit the card's SMs (one pair at N <= 1024: a
//   tile's eight consumers on two SMs); else one block a tile whose
//   warpgroups run two consumers each, one after the other. Both add the
//   same values in one order (a consumer's chunks in order; partials of
//   consumers c and c + 4, then the four in order), so a pair's rows are
//   the same at any batch, which only picks the form and adds blocks.
// - Two passes over the row: pass 1 reduces the row max, pass 2 forms p,
//   sums it and accumulates P.V. At bf16 stats (quant) pass 1 keeps each
//   chunk's rounded s in shared memory (STORE), and pass 2 reads it back
//   and streams V alone: s is rounded by the contract there, so that is
//   exact and saves pass 2's Q.K^T and K; at fp32 stats (MIXED) pass 2
//   recomputes S with the same instructions (bit for bit the same).
// - The 64-row tile: one K and V chunk read serves 64 query rows.
// - At bf16 stats s and p round to bf16 in pairs, one packed conversion
//   (cvt.rn.bf16x2) for two values, and p's packed word is P.V's operand:
//   the same bits as one conversion a value, which ran on a slow pipe.
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
//      loaded or computed (their p is exactly 0 at the clamped m, so that
//      is exact); rows and keys past Nq and Nk arrive from TMA as zeros;
//   4. keep masks and liveness as above;
//   5. Q, K and V are column slices of one (B, N, H*64) projection (row
//      stride 3E for self qkv, 2E for cross [qk | v]): their tensor maps
//      address them at those strides, which TMA needs on 16 B (the
//      wrapper raises on an operand it cannot address).
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
//
// The FP32 kernel (attention_tf32_wgmma_kernel: fp32 operands and out, with
// fp32 or bf16 stats) runs the same two passes and the same contract on
// Hopper's warpgroup MMA in 3xTF32: one TF32 product keeps about three
// decimal digits and misses the fp32 rung's 1e-4 gate, so every product is
// hi.lo + lo.hi + hi.hi of operands split by truncation (hi: x with its low
// 13 bits cleared, lo = x - hi; lo.lo dropped, the small terms first) on
// wgmma m64nNk8, from hopper.cuh's 3xTF32 pieces, as flash_attn.cu's
// flash_tf32_wgmma_kernel runs them. wgmma reads a tf32 operand in shared
// memory K-major only, which sets the layouts:
// - S = Q.K^T: Q (64 rows) and K (a 32-key piece) both K-major as TMA
//   writes them (32-float boxes in 128 B swizzle: two halves along the head
//   dim; the raw tiles serve as hi, since the tensor core reads a raw fp32
//   word as its truncation), beside their lo copies, which the consumers
//   write (Q's once, each K piece's as it lands): 24 m64n32k8 products a
//   piece, the 48 descriptors kept opaque so the compiler does not hoist
//   them out of the piece loop and spill.
// - P.V: P comes from the S accumulator as the register-A operand, split in
//   registers; the accumulator holds keys 2 t4 and 2 t4 + 1 of an 8-key step
//   where the tf32 A fragment takes t4 and t4 + 4, and the order of keys
//   within a step does not change the sum: slot t4 takes key 2 t4, slot
//   t4 + 4 key 2 t4 + 1. V, stored keys x dims, arrives as it lies and the
//   consumer writes it transposed, dims x keys in that slot order, as hi and
//   lo copies in 128 B swizzle: the K-major B operand of m64n64k8.
// - fp32 tiles are twice bf16's bytes and each needs a lo copy, so a ring
//   slot holds a 32-key piece of K (and of V in pass 2), one slot a
//   warpgroup beside its K lo and V^T hi / lo buffers, over which its P.V
//   partial goes once pass 2 is done (TfSmem, ~195 KB a block). Pass 2
//   always recomputes S, bit for bit pass 1's (a stored fp32 s would not
//   fit), so with bf16 stats (quant) s, m, p and l round as the bf16
//   kernel's do.
// - The split: chunk j of a row to consumer j % split, split 8 where one
//   pair's 64-row tiles, two blocks each, fit the card's SMs (tf32_split:
//   one pair of 1024 at H = 4 gives 128 blocks), else 4. A block has no room
//   for a second consumer's partial, so a split of 8 is always a cluster of
//   two blocks, one consumer a warpgroup, and a split of 4 one block: the
//   form follows one pair's shape, never the batch, which only adds blocks,
//   and a row's sums run in one order at any batch (q_c = p_c + p_{c + 4},
//   then q_0 .. q_3 in order, as the bf16 kernel's).
// - The bf16 kernel's items 1-5 above hold on the accumulator layout (the
//   clamp, -1e30 dead columns and -inf pad columns, chunks past kv_len
//   skipped, keep masks and liveness, TMA maps at the strides of qkv and
//   [qk | v]); dir1 needs nothing: p's cast to the fp32 V type is the
//   identity.
// RoPE runs first, in rope_kernel<float>, into an fp32 scratch. Its shared
// memory is TfSmem (kernels/layer_stack.py:attention_plan mirrors it and
// the split, lg_attention_plan).

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace lg;  // Operand, row_ptr and the tensor-core helpers (mma.cuh)

constexpr int D = HD;  // head dim
constexpr float NEG = -1e30f;
constexpr float DEAD = -5e29f;

// ---------------------------------------------------------------------------
// The BF16 kernel: warpgroups on wgmma, fed by TMA rings
// ---------------------------------------------------------------------------

constexpr int SPLIT = 8;        // consumers splitting a row's chunks: chunk j to j % SPLIT
constexpr int WGS = 4;          // consumer warpgroups of a block
constexpr int STAGES = 2;       // chunk slots of each warpgroup's ring
constexpr int TILE = 64 * D;    // elements of a 64-row tile of one head (8 KB in bf16)
constexpr int TILE_BYTES = 2 * TILE;
constexpr int PART_BYTES = 4 * 64 * D;  // a consumer's fp32 P.V partial, 64 x 64
constexpr int CLUSTER_SMS = 132;  // a launch takes clusters of two while their blocks fit the SMs
// registers: a block of WGS + 1 warpgroups, one an SM, launches at 96 a
// thread; setmaxnreg gives the producer's to the consumers
constexpr int LAUNCH_REGS = 65536 / ((WGS + 1) * 128) / 8 * 8;
constexpr int PRODUCER_REGS = 32;
constexpr int CONSUMER_REGS = (LAUNCH_REGS * (WGS + 1) - PRODUCER_REGS) / WGS / 8 * 8;
static_assert(PRODUCER_REGS + WGS * CONSUMER_REGS <= (WGS + 1) * LAUNCH_REGS, "register budget");

// The SPLIT consumers of a 64-row tile run either as a cluster of two
// blocks of WGS warpgroups (CLUSTER = 2: consumer c of block k is k * WGS +
// c) or in one block whose warpgroup c runs consumers c and c + WGS one
// after the other (CLUSTER = 1, VIRT = 2). Both add the same values in the
// same order: a consumer's chunks in order; then for each c the partials of
// consumers c and c + WGS (q_c = p_c + p_{c + WGS}), then q_0 .. q_3 in
// order; so a tile's outputs are bit for bit the same in either form, and a
// launch may take the form that fits its batch.
template <int CLUSTER>
struct Split {
  static constexpr int VIRT = SPLIT / (WGS * CLUSTER);  // consumers of a warpgroup
  static constexpr int KEPT = 1024 / 64 / SPLIT * VIRT;  // its chunks of stored S at Nk <= 1024
};

// Shared memory of a block, bytes: Q; each warpgroup's region, its ring of
// STAGES slots, then its chunks' rounded s (STORE, bf16 pairs) or room for
// its first consumer's partial (VIRT = 2); the warpgroups' partial row max
// and sum p; the block's row max; the barriers (Q, then each ring's full
// and empty slots); 1 KB to align the tiles to 1024 B (the swizzle atom). A
// slot holds K, or K and V where pass 2 recomputes S, V alone where it
// reads stored S. A partial P.V (64 x 64 fp32 in the accumulator's order,
// part_at) goes where nothing is read any more: with VIRT = 2 the first
// consumer's where its s was (or its room), the sum q_c there too; else at
// the start of the region.
template <bool STORE, int CLUSTER>
struct Smem {
  using P = Split<CLUSTER>;
  static constexpr size_t SLOT = STORE ? TILE_BYTES : 2 * TILE_BYTES;
  static constexpr size_t EXTRA_AT = SLOT * STAGES;  // in a region: [KEPT][16][128] u32
  static constexpr size_t EXTRA =
      STORE ? (size_t)P::KEPT * TILE_BYTES : (P::VIRT > 1 ? PART_BYTES : 0);
  static constexpr size_t REGION = EXTRA_AT + EXTRA;
  static constexpr size_t PART_AT = P::VIRT > 1 ? EXTRA_AT : 0;
  static constexpr size_t Q = 0;
  static constexpr size_t REGIONS = Q + TILE_BYTES;
  static constexpr size_t MAX = REGIONS + REGION * WGS;
  static constexpr size_t SUM = MAX + sizeof(float) * WGS * 64;
  static constexpr size_t CMAX = SUM + sizeof(float) * WGS * 64;
  static constexpr size_t BARS = CMAX + sizeof(float) * 64;
  static constexpr size_t BYTES = BARS + sizeof(uint64_t) * (1 + 2 * WGS * STAGES) + 1024;
  static_assert(PART_AT + PART_BYTES <= REGION, "a P.V partial fits its region");
  static_assert(P::VIRT == 1 || !STORE || PART_BYTES <= P::KEPT / P::VIRT * TILE_BYTES,
                "the first consumer's stored s makes room for its partial");
};
constexpr bool use_cluster(int B, int H, int Nq) {
  return 2ll * B * H * ((Nq + 63) / 64) <= CLUSTER_SMS;
}
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

// A 64-row tile of one head: SPLIT consumers (see Split) in one block or a
// cluster of two. Each block has a producer warpgroup (lane 0 of warp r
// feeds warpgroup r's ring by TMA) and WGS consumer warpgroups; consumer gc
// takes the chunks j with j % SPLIT == gc, the 64 rows' S and P.V over
// them. The consumers meet after each pass: in shared memory within a
// block, across a cluster through distributed shared memory (the row max;
// then each block adds the partial sums p and P.V of its share of the rows
// in Split's order). STORE (bf16 stats): pass 1 keeps each chunk's rounded
// s in shared memory, and pass 2 reads it back in place of recomputing
// Q.K^T: s is rounded to bf16 by the contract there, so that is exact, and
// pass 2 streams V alone.
template <bool KEEP, typename TO, bool STORE, int CLUSTER>
__global__ void __launch_bounds__((WGS + 1) * 128, 1)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const int* __restrict__ len_q,
                       const int* __restrict__ len_kv, const float* __restrict__ keep_q,
                       const float* __restrict__ keep_kv, const float* __restrict__ exit_reg,
                       int layer, TO* __restrict__ out, int Nq, int Nk, int H, float scale,
                       int quant, int dir1) {
  using L = Smem<STORE, CLUSTER>;
  constexpr int VIRT = Split<CLUSTER>::VIRT;
  extern __shared__ __align__(1024) unsigned char wg_raw[];
  unsigned char* const smem_raw = align1024(wg_raw);
  bf16_t* const qs = reinterpret_cast<bf16_t*>(smem_raw + L::Q);
  float* const red_max = reinterpret_cast<float*>(smem_raw + L::MAX);  // [WGS][64]
  float* const red_sum = reinterpret_cast<float*>(smem_raw + L::SUM);  // [WGS][64]
  float* const cmax = reinterpret_cast<float*>(smem_raw + L::CMAX);    // [64]
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
  if (exit_reg && !(exit_reg[b] > static_cast<float>(layer))) return;  // the whole cluster
  const bool masked = KEEP || len_q != nullptr;
  const int lq = (!KEEP && len_q) ? len_q[b] : Nq;
  // keys that can be live: every key under KEEP, the valid prefix with lengths
  const int live_k = (!KEEP && len_kv) ? max(min(len_kv[b], Nk), 0) : Nk;
  const float* kq = KEEP ? keep_q + (size_t)b * Nq : nullptr;
  const float* kk = KEEP ? keep_kv + (size_t)b * Nk : nullptr;
  TO* ob = out + (size_t)b * Nq * H * D + h * D;  // row gi at ob + gi * H * D
  constexpr int half = 64 / CLUSTER;  // the rows a block writes: rows0 ..
  const int rows0 = rank * half;

  if (!KEEP && i0 >= lq) {  // a tile wholly past q_len (the whole cluster): zeros
    for (int i = threadIdx.x; i < half * D; i += blockDim.x) {
      const int gi = i0 + rows0 + i / D;
      if (gi < Nq) ob[(size_t)gi * H * D + i % D] = lg::from_f<TO>(0.f);
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

  const int nc = (live_k + 63) / 64;  // chunks over the keys that can be live
  const int wg = threadIdx.x / 128;
  // warpgroup wg's v-th consumer and its first chunk
  auto first = [&](int v) { return v * WGS * CLUSTER + rank * WGS + wg; };
  if (wg == WGS) {  // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    // lane 0 of producer warp r feeds warpgroup r's ring, so no ring waits
    // behind another; warp 0's also loads Q. The other lanes exit; in a
    // cluster these take part in its three barriers (the first at once).
    const int r = threadIdx.x % 128 / 32;
    if (threadIdx.x % 32 == 0) {
      if (CLUSTER > 1) cluster_arrive();
      if (r == 0) {
        tma_prefetch(&qmap);
        tma_prefetch(&kmap);
        tma_prefetch(&vmap);
        mbar_expect_tx(qbar, TILE_BYTES);
        tma_load(qs, &qmap, qbar, h * D, i0, b);
      }
      // pass 1 streams K, pass 2 K and V (V alone with stored S): the
      // chunks of warpgroup r's consumers, one consumer's after the other,
      // as its ring's fills i = 0, 1, ... (pass 2 continues the count)
      int i = 0;
      for (int pass = 0; pass < 2; ++pass) {
        for (int v = 0; v < VIRT; ++v) {
          for (int j = v * WGS * CLUSTER + rank * WGS + r; j < nc; j += SPLIT, ++i) {
            const int s = i % STAGES;
            mbar_wait(empty(r, s), ((i / STAGES) & 1) ^ 1);
            mbar_expect_tx(full(r, s), TILE_BYTES * (pass && !STORE ? 2 : 1));
            if (!pass || !STORE) tma_load(slot(r, s), &kmap, full(r, s), h * D, j * 64, b);
            if (pass)
              tma_load(slot(r, s) + (STORE ? 0 : TILE), &vmap, full(r, s), h * D, j * 64, b);
          }
        }
      }
      if (CLUSTER > 1) {
        cluster_wait();
        cluster_arrive();
        cluster_wait();
        cluster_arrive();
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int tid = threadIdx.x % 128, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;  // accumulator row and column pair
  const int row0 = 16 * warp + g;         // this thread's rows: row0 and row0 + 8

  // s = quant(Q.K^T * scale) over chunk j's 64 keys in slot s of this ring:
  // pad columns past Nk are -inf, dead columns (keep < 0.5, or at or past
  // kv_len) -1e30; without keep masks only the chunk that holds kv_len or
  // Nk has any. This thread's 16 columns (bit 2 n + h: column 8 n + 2 t4 +
  // h) are classified while the product runs.
  auto scores = [&](float (&sc)[32], int s, int j) {
    const bf16_t* ks = slot(wg, s);
    fence_operand(sc);
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < D / 16; ++k16)
      wgmma_m64n64<0>(sc, kmajor_desc(qs, k16), kmajor_desc(ks, k16), k16);
    wgmma_commit();
    const int c0 = j * 64;
    const bool ragged = KEEP || c0 + 64 > live_k;
    unsigned pad = 0u, dead = 0u;
    if (ragged) {
#pragma unroll
      for (int bit = 0; bit < 16; ++bit) {
        const int col = c0 + 8 * (bit / 2) + 2 * t4 + (bit & 1);
        if (col >= Nk)
          pad |= 1u << bit;
        else if (KEEP ? __ldg(kk + col) < 0.5f : col >= live_k)
          dead |= 1u << bit;
      }
    }
    wgmma_wait<0>();
    fence_operand(sc);
#pragma unroll
    for (int k = 0; k < 16; ++k) {  // a pair of a row's columns at a time
      float x[2] = {sc[2 * k] * scale, sc[2 * k + 1] * scale};
      if (STORE) {  // bf16 stats (quant): both rounded in one packed conversion
        const unsigned w = pack_bf16(x[0], x[1]);
        x[0] = __uint_as_float(w << 16), x[1] = __uint_as_float(w & 0xffff0000u);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int bit = 2 * (k / 2) + h;  // column 8 (k / 2) + 2 t4 + h
        sc[2 * k + h] = (pad >> bit) & 1u ? -INFINITY : ((dead >> bit) & 1u ? NEG : x[h]);
      }
    }
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(wg, s));
  };

  mbar_wait(qbar, 0);

  // pass 1: the row max over this warpgroup's chunks (and with STORE each
  // chunk's s, packed in bf16 pairs: word k of this thread holds s[2 k],
  // s[2 k + 1], at [chunk][k][tid]; consumer v's chunks from chunk v * OWN)
  constexpr int OWN = Split<CLUSTER>::KEPT / VIRT;  // stored chunks of one consumer
  float mx[2] = {-INFINITY, -INFINITY};
  unsigned* const store = reinterpret_cast<unsigned*>(region(wg) + L::EXTRA_AT);
  int i = 0;  // fills of this ring consumed
  // a warpgroup's consumers one after the other, in the same registers
#pragma unroll 1
  for (int v = 0; v < VIRT; ++v) {
    int c = v * OWN;  // this chunk's place in the store
    for (int j = first(v); j < nc; j += SPLIT, ++i, ++c) {
      const int s = i % STAGES;
      mbar_wait(full(wg, s), (i / STAGES) & 1);
      float sc[32];
      scores(sc, s, j);
      release(s);
#pragma unroll
      for (int e = 0; e < 32; ++e) mx[(e / 2) & 1] = fmaxf(mx[(e / 2) & 1], sc[e]);
      if (STORE) {
#pragma unroll
        for (int k = 0; k < 16; ++k)
          store[(c * 16 + k) * 128 + tid] = pack_bf16(sc[2 * k], sc[2 * k + 1]);
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
  float m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int k = 0; k < CLUSTER; ++k)
      if (k != rank) mx[r] = fmaxf(mx[r], ld_dsmem(dsmem(cmax + row0 + 8 * r, k)));
    m[r] = lg::quant_stat(mx[r], quant);
    if (masked) m[r] = fmaxf(m[r], DEAD);
  }

  // pass 2, consumer by consumer: p against the row max, sum p and P.V with
  // P cast to bf16 from the S accumulator (wgmma's register-A form); with
  // VIRT = 2 the first consumer's partial waits in shared memory and the
  // second's is added to it (q_c = p_c + p_{c + WGS})
  float* const mine = part(wg);  // [16][128] float2, part_at
  float ps[2];
#pragma unroll 1
  for (int v = 0; v < VIRT; ++v) {
    ps[0] = ps[1] = 0.f;
    float pv[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) pv[e] = 0.f;
    int c = v * OWN;
    for (int j = first(v); j < nc; j += SPLIT, ++i, ++c) {
      const int s = i % STAGES;
      mbar_wait(full(wg, s), (i / STAGES) & 1);
      float sc[32];
      if (STORE) {  // the rounded s of pass 1 (dead columns' -1e30 as bf16: p is 0 either way)
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const unsigned w = store[(c * 16 + k) * 128 + tid];
          sc[2 * k] = __uint_as_float(w << 16);
          sc[2 * k + 1] = __uint_as_float(w & 0xffff0000u);
        }
      } else {
        scores(sc, s, j);
      }
      unsigned pa[D / 16][4];  // keys 16 kk.. of the chunk: n-tiles 2 kk and 2 kk + 1
      if constexpr (STORE) {
        // bf16 stats: p in pairs (one row, columns 2 t4, 2 t4 + 1) rounded
        // in one packed conversion, which is also P.V's A operand
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int r = k & 1;  // row0 or row0 + 8
          const unsigned w = pack_bf16(expf(sc[2 * k] - m[r]), expf(sc[2 * k + 1] - m[r]));
          ps[r] += __uint_as_float(w << 16);
          ps[r] += __uint_as_float(w & 0xffff0000u);
          pa[k / 4][k % 4] = w;
        }
      } else {  // fp32 stats: p as it is, cast to bf16 for P.V
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const float p = expf(sc[e] - m[(e / 2) & 1]);
          sc[e] = p;
          ps[(e / 2) & 1] += dir1 ? lg::round_to<bf16_t>(p) : p;  // direction 1 sums P in the V type
        }
#pragma unroll
        for (int k = 0; k < 16; ++k) pa[k / 4][k % 4] = pack_bf16(sc[2 * k], sc[2 * k + 1]);
      }
      const bf16_t* vs = slot(wg, s) + (STORE ? 0 : TILE);
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
      release(s);
    }
    ps[0] = quad_sum(ps[0]);
    ps[1] = quad_sum(ps[1]);
    // this consumer's partial into shared memory (the second one's added to
    // the first's, which this thread wrote there itself)
    if (v == 0) bar_sync(2 + wg, 128);  // every warp of this group has read the s and V there
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

  // each block's consumer threads add the partials of its share of the rows
  // in Split's order, eight outputs each
  if (CLUSTER > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    bar_sync(1, WGS * 128);
  }
  for (int it = threadIdx.x; it < half * (D / 8); it += WGS * 128) {
    const int row = rows0 + it / (D / 8), c8 = it % (D / 8) * 8, gi = i0 + row;
    if (gi >= Nq) continue;
    float ls[WGS * CLUSTER];  // every block's partial sums p and P.V of these outputs
    float4 lo[WGS * CLUSTER], hi[WGS * CLUSTER];
#pragma unroll
    for (int k = 0; k < CLUSTER; ++k) {
#pragma unroll
      for (int w = 0; w < WGS; ++w) {
        const float* src = part(w) + part_at(row, c8);
        if constexpr (CLUSTER > 1) {  // all loads first
          ls[k * WGS + w] = ld_dsmem(dsmem(red_sum + w * 64 + row, k));
          lo[k * WGS + w] = ld_dsmem4(dsmem(src, k));
          hi[k * WGS + w] = ld_dsmem4(dsmem(src + 4, k));
        } else {
          ls[w] = red_sum[w * 64 + row];
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
    const float l = lg::quant_stat(sum, quant);
    const float den = l == 0.f ? 1.f : l;
    const bool zero = !KEEP && masked && gi >= lq;
    const float keep = KEEP ? kq[gi] : 1.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      x[e] = x[e] / den;
      if (KEEP) x[e] *= keep;
      if (zero) x[e] = 0.f;
    }
    store8(ob + (size_t)gi * H * D + c8, x);
  }
  if (CLUSTER > 1) {
    cluster_arrive();  // no block leaves while another reads its shared memory
    cluster_wait();
  }
}

// ---------------------------------------------------------------------------
// The FP32 kernel: the same warpgroups in 3xTF32 on wgmma m64nNk8
// ---------------------------------------------------------------------------

constexpr int PIECE_KEYS = 32;             // keys of an fp32 ring slot: half a chunk
constexpr int PIECE = 4 * PIECE_KEYS * D;  // bytes of an fp32 piece of K or V (8 KB)
constexpr int F32_TILE = 4 * TILE;         // bytes of a 64-row fp32 tile of one head

// consumers splitting a 64-row tile's chunks at fp32 operands: 8 where one
// pair's tiles, two blocks each, fit the card's SMs, else 4 (the pair's
// shape, never the batch; kernels/layer_stack.py:tf32_split mirrors it)
constexpr int tf32_split(int H, int Nq) {
  return 2ll * H * ((Nq + 63) / 64) <= CLUSTER_SMS ? 8 : 4;
}

// Shared memory of an fp32 block, bytes: Q as TMA writes it (two [64][32]
// halves in 128 B swizzle) and its lo copy; each warpgroup's region, its
// one ring slot (a 32-key piece of K, two [32][32] halves in 128 B swizzle,
// and in pass 2 of V, [32][64] as it lies), then K's lo copy and V's piece
// transposed and split, hi and lo ([64][32] each, keys in P's order, 128 B
// swizzle), over which the warpgroup's P.V partial goes once pass 2 is
// done; the warpgroups' partial row max and sum p; the block's row max; the
// barriers (Q, then each ring's full and empty slot); 1 KB to align the
// tiles to 1024 B. The same in either form (a cluster's block or one block).
struct TfSmem {
  static constexpr size_t SLOT = 2 * PIECE;
  static constexpr size_t KLO = SLOT, VTH = KLO + PIECE, VTL = VTH + PIECE;
  static constexpr size_t REGION = VTL + PIECE;
  static constexpr size_t PART_AT = KLO;
  static constexpr size_t Q = 0, QLO = F32_TILE;
  static constexpr size_t REGIONS = QLO + F32_TILE;
  static constexpr size_t MAX = REGIONS + REGION * WGS;
  static constexpr size_t SUM = MAX + sizeof(float) * WGS * 64;
  static constexpr size_t CMAX = SUM + sizeof(float) * WGS * 64;
  static constexpr size_t BARS = CMAX + sizeof(float) * 64;
  static constexpr size_t BYTES = BARS + sizeof(uint64_t) * (1 + 2 * WGS) + 1024;
  static_assert(PART_AT + PART_BYTES <= REGION, "a P.V partial fits over the copies");
  static_assert(BYTES <= 232448, "a block fits the SM's shared memory");
};

// A 64-row tile of one head in 3xTF32: WGS * CLUSTER consumers (a cluster
// of two blocks at a split of 8, one block at 4), consumer rank * WGS + wg
// taking the chunks j with j % (WGS * CLUSTER) == rank * WGS + wg, each as
// two 32-key pieces, a ring fill each; otherwise the bf16 kernel's
// structure: producer warp r feeds warpgroup r's ring, the consumers meet
// after each pass, each block's consumer threads add the partials of its
// share of the rows.
template <bool KEEP, int CLUSTER>
__global__ void __launch_bounds__((WGS + 1) * 128, 1)
attention_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const int* __restrict__ len_q, const int* __restrict__ len_kv,
                            const float* __restrict__ keep_q, const float* __restrict__ keep_kv,
                            const float* __restrict__ exit_reg, int layer,
                            float* __restrict__ out, int Nq, int Nk, int H, float scale,
                            int quant) {
  using L = TfSmem;
  constexpr int SPLIT_F = WGS * CLUSTER;  // consumers of a tile
  extern __shared__ __align__(1024) unsigned char wg_raw[];
  unsigned char* const smem_raw = align1024(wg_raw);
  unsigned char* const qs = smem_raw + L::Q;     // Q as TMA writes it: its hi
  unsigned char* const qlo = smem_raw + L::QLO;  // Q's lo copy
  float* const red_max = reinterpret_cast<float*>(smem_raw + L::MAX);  // [WGS][64]
  float* const red_sum = reinterpret_cast<float*>(smem_raw + L::SUM);  // [WGS][64]
  float* const cmax = reinterpret_cast<float*>(smem_raw + L::CMAX);    // [64]
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem_raw + L::BARS);
  uint64_t* const qbar = bars;
  auto region = [&](int r) { return smem_raw + L::REGIONS + L::REGION * r; };
  auto part = [&](int r) { return reinterpret_cast<float*>(region(r) + L::PART_AT); };
  auto full = [&](int r) { return bars + 1 + r; };
  auto empty = [&](int r) { return bars + 1 + WGS + r; };

  const int rank = CLUSTER > 1 ? cluster_rank() : 0;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x / CLUSTER * 64;
  if (exit_reg && !(exit_reg[b] > static_cast<float>(layer))) return;  // the whole cluster
  const bool masked = KEEP || len_q != nullptr;
  const int lq = (!KEEP && len_q) ? len_q[b] : Nq;
  // keys that can be live: every key under KEEP, the valid prefix with lengths
  const int live_k = (!KEEP && len_kv) ? max(min(len_kv[b], Nk), 0) : Nk;
  const float* kq = KEEP ? keep_q + (size_t)b * Nq : nullptr;
  const float* kk = KEEP ? keep_kv + (size_t)b * Nk : nullptr;
  float* ob = out + (size_t)b * Nq * H * D + h * D;  // row gi at ob + gi * H * D
  constexpr int half = 64 / CLUSTER;  // the rows a block writes: rows0 ..
  const int rows0 = rank * half;

  if (!KEEP && i0 >= lq) {  // a tile wholly past q_len (the whole cluster): zeros
    for (int i = threadIdx.x; i < half * D; i += blockDim.x) {
      const int gi = i0 + rows0 + i / D;
      if (gi < Nq) ob[(size_t)gi * H * D + i % D] = 0.f;
    }
    return;
  }
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int r = 0; r < WGS; ++r) {
      mbar_init(full(r), 1);
      mbar_init(empty(r), 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int nc = (live_k + 63) / 64;  // chunks over the keys that can be live
  const int wg = threadIdx.x / 128;
  if (wg == WGS) {  // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    // lane 0 of producer warp r feeds warpgroup r's ring; warp 0's also
    // loads Q (two 32-float halves). The other lanes exit; in a cluster
    // these take part in its three barriers (the first at once).
    const int r = threadIdx.x % 128 / 32;
    if (threadIdx.x % 32 == 0) {
      if (CLUSTER > 1) cluster_arrive();
      if (r == 0) {
        tma_prefetch(&qmap);
        tma_prefetch(&kmap);
        tma_prefetch(&vmap);
        mbar_expect_tx(qbar, F32_TILE);
        tma_load(qs, &qmap, qbar, h * D, i0, b);
        tma_load(qs + F32_TILE / 2, &qmap, qbar, h * D + 32, i0, b);
      }
      // pass 1 streams K's pieces, pass 2 K's and V's: the chunks of
      // consumer rank * WGS + r, two pieces each, as its ring's fills i
      int i = 0;
      for (int pass = 0; pass < 2; ++pass) {
        for (int j = rank * WGS + r; j < nc; j += SPLIT_F) {
          for (int hp = 0; hp < 2; ++hp, ++i) {
            const int row = j * 64 + PIECE_KEYS * hp;
            unsigned char* const dst = region(r);
            mbar_wait(empty(r), (i & 1) ^ 1);
            mbar_expect_tx(full(r), PIECE * (pass ? 2 : 1));
            tma_load(dst, &kmap, full(r), h * D, row, b);
            tma_load(dst + PIECE / 2, &kmap, full(r), h * D + 32, row, b);
            if (pass) tma_load(dst + PIECE, &vmap, full(r), h * D, row, b);
          }
        }
      }
      if (CLUSTER > 1) {
        cluster_wait();
        cluster_arrive();
        cluster_wait();
        cluster_arrive();
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int tid = threadIdx.x % 128, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;  // accumulator row and column pair
  const int row0 = 16 * warp + g;         // this thread's rows: row0 and row0 + 8
  const int first = rank * WGS + wg;      // this consumer's first chunk

  // s = quant(Q.K^T * scale) over keys k0 .. k0 + 31 of chunk j, the piece
  // in this warpgroup's slot with its lo copy written: Q_hi.K_lo, Q_lo.K_hi,
  // Q_hi.K_hi (24 m64n32k8; the raw tiles serve as hi). Pad columns past Nk
  // are -inf, dead columns (keep < 0.5, or at or past kv_len) -1e30;
  // without keep masks only the chunk that holds kv_len or Nk has any. This
  // thread's 8 columns (bit 2 n + e: column k0 + 8 n + 2 t4 + e) are
  // classified while the product runs.
  auto scores = [&](float (&sc)[16], int j, int k0) {
    fence_operand(sc);
    wgmma_fence();
    const uint64_t qh = opaque(kmajor_desc(qs, 0)), ql = qh + (L::QLO - L::Q) / 16;
    const uint64_t kh = opaque(kmajor_desc(region(wg), 0)), kl = kh + L::KLO / 16;
#pragma unroll
    for (int k8 = 0; k8 < D / 8; ++k8)
      wgmma_tf32_m64n32(sc, desc_step_f32(qh, 64, k8), desc_step_f32(kl, PIECE_KEYS, k8), k8);
#pragma unroll
    for (int k8 = 0; k8 < D / 8; ++k8)
      wgmma_tf32_m64n32(sc, desc_step_f32(ql, 64, k8), desc_step_f32(kh, PIECE_KEYS, k8), 1);
#pragma unroll
    for (int k8 = 0; k8 < D / 8; ++k8)
      wgmma_tf32_m64n32(sc, desc_step_f32(qh, 64, k8), desc_step_f32(kh, PIECE_KEYS, k8), 1);
    wgmma_commit();
    const int c0 = j * 64 + k0;
    const bool ragged = KEEP || c0 + PIECE_KEYS > live_k;
    unsigned pad = 0u, dead = 0u;
    if (ragged) {
#pragma unroll
      for (int bit = 0; bit < 8; ++bit) {
        const int col = c0 + 8 * (bit / 2) + 2 * t4 + (bit & 1);
        if (col >= Nk)
          pad |= 1u << bit;
        else if (KEEP ? __ldg(kk + col) < 0.5f : col >= live_k)
          dead |= 1u << bit;
      }
    }
    wgmma_wait<0>();
    fence_operand(sc);
#pragma unroll
    for (int k = 0; k < 8; ++k) {  // a pair of a row's columns at a time
      float x[2] = {sc[2 * k] * scale, sc[2 * k + 1] * scale};
      if (quant) {  // bf16 stats: both rounded in one packed conversion
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
  auto release = [&]() {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(wg));
  };
  // the ring's fill-th piece has landed, its K lo copy written (and with_v
  // V's piece transposed and split: V^T[d][8 j + q] holds key 8 j + 2 q (q <
  // 4) or 8 j + 2 (q - 4) + 1 of the piece, P's order, as 16 B unit u = (8 j
  // + q) / 4 of row d at u ^ d % 8), then the warpgroup synced
  auto land = [&](int fill, bool with_v) {
    mbar_wait(full(wg), fill & 1);
    unsigned char* const kr = region(wg);
    tf32_lo_copy(reinterpret_cast<float*>(kr), reinterpret_cast<float*>(kr + L::KLO),
                 PIECE_KEYS * D, tid, 128);
    if (with_v) {
      const float* vr = reinterpret_cast<const float*>(kr + PIECE);  // [32 keys][64]
      unsigned char* const vth = kr + L::VTH;
      unsigned char* const vtl = kr + L::VTL;
#pragma unroll 1
      for (int it = 0; it < PIECE_KEYS * D / 4 / 128; ++it) {  // beside P.V's acc: one at a time
        const int item = tid + 128 * it, d = item % D, u = item / D;
        const int key0 = 8 * (u / 2) + (u & 1);  // keys key0, + 2, + 4, + 6
        unsigned hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32_rz(vr[(key0 + 2 * e) * D + d], hi[e], lo[e]);
        const int at = d * 128 + ((u ^ (d % 8)) * 16);
        *reinterpret_cast<uint4*>(vth + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(vtl + at) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
    fence_proxy_async();  // the copies, written by threads, visible to wgmma
    bar_sync(2 + wg, 128);
  };

  mbar_wait(qbar, 0);  // Q's lo copy, once, by every consumer thread of the block
  tf32_lo_copy(reinterpret_cast<float*>(qs), reinterpret_cast<float*>(qlo), 64 * D, threadIdx.x,
               WGS * 128);
  fence_proxy_async();
  bar_sync(1, WGS * 128);

  // pass 1: the row max over this consumer's chunks, a piece at a time
  float mx[2] = {-INFINITY, -INFINITY};
  int i = 0;  // fills of this ring consumed
  for (int j = first; j < nc; j += SPLIT_F) {
#pragma unroll 1
    for (int hp = 0; hp < 2; ++hp, ++i) {
      land(i, false);
      float sc[16];
      scores(sc, j, PIECE_KEYS * hp);
      release();
#pragma unroll
      for (int e = 0; e < 16; ++e) mx[(e / 2) & 1] = fmaxf(mx[(e / 2) & 1], sc[e]);
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
  float m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int k = 0; k < CLUSTER; ++k)
      if (k != rank) mx[r] = fmaxf(mx[r], ld_dsmem(dsmem(cmax + row0 + 8 * r, k)));
    m[r] = lg::quant_stat(mx[r], quant);
    if (masked) m[r] = fmaxf(m[r], DEAD);
  }

  // pass 2: S again, p against the row max, sum p and P.V in 3xTF32 (P
  // split in registers from the S accumulator; its cast to the fp32 V type
  // is the identity, so direction 1 sums p as the others do)
  float ps[2] = {0.f, 0.f};
  float pv[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) pv[e] = 0.f;
  for (int j = first; j < nc; j += SPLIT_F) {
#pragma unroll 1
    for (int hp = 0; hp < 2; ++hp, ++i) {
      land(i, true);
      float sc[16];
      scores(sc, j, PIECE_KEYS * hp);
      release();  // V is in its copies and S is done: the next piece may land
#pragma unroll
      for (int k = 0; k < 8; ++k) {  // p in pairs of a row; bf16 stats: rounded together
        const int r = k & 1;
        float p0 = expf(sc[2 * k] - m[r]), p1 = expf(sc[2 * k + 1] - m[r]);
        if (quant) {
          const unsigned w = pack_bf16(p0, p1);
          p0 = __uint_as_float(w << 16), p1 = __uint_as_float(w & 0xffff0000u);
        }
        ps[r] += p0;
        ps[r] += p1;
        sc[2 * k] = p0, sc[2 * k + 1] = p1;
      }
      // P.V in 16-key halves: P's A fragment of k step kk (keys 8 kk..)
      // takes key 2 t4 in slot t4 (accumulator 4 kk, row g; 4 kk + 2, row
      // g + 8) and key 2 t4 + 1 in slot t4 + 4 (4 kk + 1, 4 kk + 3), split
      // into (hi, lo); V^T's k step kk is 32 B along its rows
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        unsigned ph[2][4], pl[2][4];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float* pk = sc + 8 * hh + 4 * q;
          split_tf32_rz(pk[0], ph[q][0], pl[q][0]);
          split_tf32_rz(pk[2], ph[q][1], pl[q][1]);
          split_tf32_rz(pk[1], ph[q][2], pl[q][2]);
          split_tf32_rz(pk[3], ph[q][3], pl[q][3]);
        }
        const uint64_t vh = opaque(kmajor_desc(region(wg) + L::VTH, 2 * hh));
        const uint64_t vl = opaque(kmajor_desc(region(wg) + L::VTL, 2 * hh));
        fence_operand(pv);
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < 2; ++q) wgmma_tf32_m64n64_rs(pv, ph[q], vl + 2 * q, 1);
#pragma unroll
        for (int q = 0; q < 2; ++q) wgmma_tf32_m64n64_rs(pv, pl[q], vh + 2 * q, 1);
#pragma unroll
        for (int q = 0; q < 2; ++q) wgmma_tf32_m64n64_rs(pv, ph[q], vh + 2 * q, 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(pv);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          fence_operand(ph[q]);
          fence_operand(pl[q]);
        }
      }
    }
  }
  ps[0] = quad_sum(ps[0]);
  ps[1] = quad_sum(ps[1]);
  // this consumer's partial into its region, over the copies, once every
  // warp of the group is past its last product
  bar_sync(2 + wg, 128);
  float2* const pairs = reinterpret_cast<float2*>(part(wg)) + tid;
#pragma unroll
  for (int e = 0; e < 32; e += 2) pairs[e / 2 * 128] = make_float2(pv[e], pv[e + 1]);
  if (t4 == 0) {
    red_sum[wg * 64 + row0] = ps[0];
    red_sum[wg * 64 + row0 + 8] = ps[1];
  }

  // each block's consumer threads add the partials of its share of the rows
  // in the split's order (q_c = p_c + p_{c + WGS} in a cluster, then q_0 ..
  // q_3), eight outputs each; in a cluster one consumer's pair of partials
  // at a time (all loads first would hold 72 registers and spill)
  if (CLUSTER > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    bar_sync(1, WGS * 128);
  }
  for (int it = threadIdx.x; it < half * (D / 8); it += WGS * 128) {
    const int row = rows0 + it / (D / 8), c8 = it % (D / 8) * 8, gi = i0 + row;
    if (gi >= Nq) continue;
    float sum = 0.f, x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int c = 0; c < WGS; ++c) {
      const float* src = part(c) + part_at(row, c8);
      float q, y[8];
      if constexpr (CLUSTER > 1) {  // block 0's consumer c, then block 1's
        q = ld_dsmem(dsmem(red_sum + c * 64 + row, 0)) +
            ld_dsmem(dsmem(red_sum + c * 64 + row, 1));
        const float4 l0 = ld_dsmem4(dsmem(src, 0)), l1 = ld_dsmem4(dsmem(src, 1));
        const float4 h0 = ld_dsmem4(dsmem(src + 4, 0)), h1 = ld_dsmem4(dsmem(src + 4, 1));
        y[0] = l0.x + l1.x, y[1] = l0.y + l1.y, y[2] = l0.z + l1.z, y[3] = l0.w + l1.w;
        y[4] = h0.x + h1.x, y[5] = h0.y + h1.y, y[6] = h0.z + h1.z, y[7] = h0.w + h1.w;
      } else {
        q = red_sum[c * 64 + row];
        const float4 l0 = *reinterpret_cast<const float4*>(src);
        const float4 h0 = *reinterpret_cast<const float4*>(src + 4);
        y[0] = l0.x, y[1] = l0.y, y[2] = l0.z, y[3] = l0.w;
        y[4] = h0.x, y[5] = h0.y, y[6] = h0.z, y[7] = h0.w;
      }
      sum += q;
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] += y[e];
    }
    const float l = lg::quant_stat(sum, quant);
    const float den = l == 0.f ? 1.f : l;
    const bool zero = !KEEP && masked && gi >= lq;
    const float keep = KEEP ? kq[gi] : 1.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      x[e] = x[e] / den;
      if (KEEP) x[e] *= keep;
      if (zero) x[e] = 0.f;
    }
    store8(ob + (size_t)gi * H * D + c8, x);
  }
  if (CLUSTER > 1) {
    cluster_arrive();  // no block leaves while another reads its shared memory
    cluster_wait();
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// One head's columns of a (B, rows, H*64) operand of `type` (bf16 or fp32)
// addressed by (batch, row) strides in elements, read in boxes of box_cols x
// box_rows written in `swizzle` bytes of swizzle (0: as they lie)
int head_map(CUtensorMap* map, const Operand& o, int B, int rows, int H, CUtensorMapDataType type,
             int box_cols, int box_rows, int swizzle) {
  const int es = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const long long bs = B > 1 ? o.bs : (long long)rows * o.rs;  // one batch entry: any stride
  if (!tma_aligned(o.ptr, es * o.rs, es * bs)) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[3] = {(cuuint64_t)H * D, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)(es * o.rs), (cuuint64_t)(es * bs)};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  return tma_map(map, o.ptr, type, 3, dims, strides, box, swizzle);
}

// A kernel of a 64-row tile of a head per block, or per cluster of
// cluster_blocks blocks
template <typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, int cluster_blocks, size_t smem, int B, int Nq, int H,
                 cudaStream_t stream, Args... args) {
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = cluster_blocks;
  cluster[0].val.clusterDim.y = cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster_blocks * ((Nq + 63) / 64), H, B);
  cfg.blockDim = dim3((WGS + 1) * 128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = cluster_blocks > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
}

// The FP32 kernel in one form: Q in 32-float boxes of 64 rows and K in
// 32-float boxes of 32 keys (128 B swizzle), V in 64-float boxes of 32 keys
// as they lie
template <bool KEEP, int CLUSTER>
int launch_tf32(Operand q, Operand k, Operand v, const void* len_q, const void* len_kv,
                const void* keep_q, const void* keep_kv, const void* exit_reg, int layer,
                void* out, int B, int Nq, int Nk, int H, float scale, int quant,
                cudaStream_t stream) {
  constexpr size_t smem = TfSmem::BYTES;
  auto kernel = attention_tf32_wgmma_kernel<KEEP, CLUSTER>;
  static const cudaError_t opt_in =  // above 48 KB: opt in once
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap qm, km, vm;
  const int errs[3] = {head_map(&qm, q, B, Nq, H, F32, 32, 64, 128),
                       head_map(&km, k, B, Nk, H, F32, 32, PIECE_KEYS, 128),
                       head_map(&vm, v, B, Nk, H, F32, D, PIECE_KEYS, 0)};
  for (const int err : errs)
    if (err) return err;
  return launch_tiles(kernel, CLUSTER, smem, B, Nq, H, stream, qm, km, vm,
                      static_cast<const int*>(len_q), static_cast<const int*>(len_kv),
                      static_cast<const float*>(keep_q), static_cast<const float*>(keep_kv),
                      static_cast<const float*>(exit_reg), layer, static_cast<float*>(out), Nq, Nk,
                      H, scale, quant);
}

// tf32_split's form: a cluster of two blocks a tile at a split of 8, one
// block at 4
template <bool KEEP>
int launch_fp32(Operand q, Operand k, Operand v, const void* len_q, const void* len_kv,
                const void* keep_q, const void* keep_kv, const void* exit_reg, int layer,
                void* out, int B, int Nq, int Nk, int H, float scale, int quant, cudaStream_t s) {
  auto run = tf32_split(H, Nq) == 8 ? launch_tf32<KEEP, 2> : launch_tf32<KEEP, 1>;
  return run(q, k, v, len_q, len_kv, keep_q, keep_kv, exit_reg, layer, out, B, Nq, Nk, H, scale,
             quant, s);
}

template <bool KEEP, typename TO, bool STORE, int CLUSTER>
int launch_wgmma(Operand q, Operand k, Operand v, const void* len_q, const void* len_kv,
                 const void* keep_q, const void* keep_kv, const void* exit_reg, int layer,
                 void* out, int B, int Nq, int Nk, int H, float scale, int quant, int dir1,
                 cudaStream_t stream) {
  constexpr size_t smem = Smem<STORE, CLUSTER>::BYTES;
  auto kernel = attention_wgmma_kernel<KEEP, TO, STORE, CLUSTER>;
  static const cudaError_t opt_in =  // above 48 KB: opt in once
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  if (STORE && Nk > 64 * SPLIT * Split<CLUSTER>::KEPT / Split<CLUSTER>::VIRT)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr CUtensorMapDataType BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qm, km, vm;
  const int errs[3] = {head_map(&qm, q, B, Nq, H, BF, D, 64, 128),
                       head_map(&km, k, B, Nk, H, BF, D, 64, 128),
                       head_map(&vm, v, B, Nk, H, BF, D, 64, 128)};
  for (const int err : errs)
    if (err) return err;
  return launch_tiles(kernel, CLUSTER, smem, B, Nq, H, stream, qm, km, vm,
                      static_cast<const int*>(len_q), static_cast<const int*>(len_kv),
                      static_cast<const float*>(keep_q), static_cast<const float*>(keep_kv),
                      static_cast<const float*>(exit_reg), layer, static_cast<TO*>(out), Nq, Nk,
                      H, scale, quant, dir1);
}

// bf16 stats (quant) keep pass 1's s, fp32 stats recompute it; clusters of
// two blocks while their blocks fit the SMs (use_cluster), else one block a
// tile: the same sums either way
template <bool KEEP, typename TO>
int launch_bf16(Operand q, Operand k, Operand v, const void* len_q, const void* len_kv,
                const void* keep_q, const void* keep_kv, const void* exit_reg, int layer,
                void* out, int B, int Nq, int Nk, int H, float scale, int quant, int dir1,
                cudaStream_t stream) {
  const bool cl = use_cluster(B, H, Nq);
  auto run = quant ? (cl ? launch_wgmma<KEEP, TO, true, 2> : launch_wgmma<KEEP, TO, true, 1>)
                   : (cl ? launch_wgmma<KEEP, TO, false, 2> : launch_wgmma<KEEP, TO, false, 1>);
  return run(q, k, v, len_q, len_kv, keep_q, keep_kv, exit_reg, layer, out, B, Nq, Nk, H, scale,
             quant, dir1, stream);
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
// attention_tf32_wgmma_kernel in tf32_split's form), BF16 (bf16 operands and
// out) or BF16_F32_OUT (bf16 operands, fp32 out), the last two
// attention_wgmma_kernel; each a block or a cluster of two per 64 rows of a
// head, its operands read by TMA (on 16 B: base, row and batch strides;
// else cudaErrorInvalidValue) (kernels/layer_stack.py:attention_plan mirrors
// both). dir1: the row sum
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
        quant, s);
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

// mma.cuh:fill_row_groups, the 16-row groups per block of the four-warp
// attention kernels at one pair's shape, whatever the batch (flash_plan is
// held against it).
extern "C" int lg_attention_row_groups(int H, int Nq) { return fill_row_groups(H, Nq); }

// lg_attention's block at this shape in this mode: out = {16-row groups (4:
// a 64-row tile), consumer warpgroups splitting each row's chunks, dynamic
// shared memory in bytes} (the wrapper's attention_plan is held against
// it), and the blocks of the launch. The bf16 kernel splits SPLIT ways at
// every shape and batch, a cluster of two blocks a tile where use_cluster
// says so; its shared memory holds pass 1's s at bf16 stats (quant). The
// fp32 kernel splits tf32_split ways, a cluster of two blocks a tile at a
// split of 8.
extern "C" int lg_attention_plan(int B, int H, int Nq, int mode, int quant, int* out) {
  const bool f32 = mode == FP32;
  const int split = f32 ? tf32_split(H, Nq) : SPLIT;
  const bool cluster = f32 ? split == 8 : use_cluster(B, H, Nq);
  out[0] = 4;
  out[1] = split;
  out[2] = static_cast<int>(f32 ? TfSmem::BYTES : wgmma_smem(quant, cluster));
  out[3] = (cluster ? 2 : 1) * ((Nq + 63) / 64) * H * B;
  return 0;
}
