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
// The FP32 kernel (flash_tf32_wgmma_kernel: the fp32 rung, and fp32
// operands with bf16 stats in the ring step) is the same design, the same
// body (flash_tile) at T = float, with every product in 3xTF32 on wgmma
// m64nNk8: one TF32 product keeps about three decimal digits and misses the
// fp32 gate of 1e-4, so each operand x is split into hi (x with its low 13
// bits cleared, mma.cuh:split_tf32_rz) and lo = x - hi, and a product is
// hi.lo + lo.hi + hi.hi, fp32 sums, the small terms first and lo.lo dropped
// (hopper.cuh). wgmma reads a tf32 operand in shared memory K-major only,
// which sets the layouts:
// - S = Q.K^T: Q and K are both K-major as TMA writes them (32-float boxes
//   in 128 B swizzle: two halves along the head dim). The raw tiles serve
//   as hi (hopper.cuh); the consumers write Q's lo copy once and each K
//   piece's as it lands, so S is three m64n32k8 products a k step, both
//   operands from shared memory (Q in registers as hi and lo would take 64
//   registers of the 112 a consumer has).
// - P.V: P comes from the S accumulator as the register-A operand, split
//   in registers. The accumulator holds keys 2 t4 and 2 t4 + 1 of an 8-key
//   step where the tf32 A fragment wants t4 and t4 + 4, and the order of
//   keys within a step does not change the sum: slot t4 takes key 2 t4,
//   slot t4 + 4 key 2 t4 + 1. V, stored keys x dims (MN-major), arrives as
//   it lies and the consumer writes it transposed, dims x keys, keys in that
//   slot order, as hi and lo copies in 128 B swizzle: the K-major B operand
//   of m64n64k8.
// - fp32 tiles are twice bf16's bytes and each needs a lo copy, so a ring
//   slot holds a 32-key piece of K and of V (one fill; a chunk is two
//   pieces, S in 32-key halves as the bf16 recompute path takes it) and a
//   warpgroup has one slot, beside its K lo and V^T hi / lo buffers, over
//   which its P.V partial goes once pass 2 is done (~208 KB a block). With
//   no room for a second consumer's partial, a split of 8 is always a
//   cluster of two blocks; pass 2 always recomputes S (a stored fp32 s would
//   not fit either).
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
// The kernels: warpgroups on wgmma, fed by TMA rings
// ---------------------------------------------------------------------------

constexpr int WGS = 4;             // consumer warpgroups of a block
constexpr int STAGES = 2;          // chunk slots of each warpgroup's ring (bf16)
constexpr int PIECE_KEYS = 32;     // keys of an fp32 ring slot: half a chunk
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
// orders a row's sums); in bf16 a split of 8 runs as clusters of two blocks
// while the whole launch's blocks fit the SMs, else as one block a tile,
// and bf16 stats keep pass 1's s where the tile fits (block_k <=
// MAX_STORED_K); in fp32 a split of 8 is always a cluster (a block has no
// room for a second consumer's P.V partial) and pass 2 always recomputes S.
struct WgPlan {
  int split, cluster, store;
};
inline int flash_split(int H, int Nq) {
  return 2ll * H * ((Nq + 63) / 64) <= CLUSTER_SMS ? 8 : 4;
}
inline WgPlan wgmma_plan(int B, int H, int Nq, int block_k, int quant, bool f32) {
  const int split = flash_split(H, Nq);
  if (f32) return {split, split == 8, 0};
  return {split, split == 8 && 2ll * B * H * ((Nq + 63) / 64) <= CLUSTER_SMS,
          quant && block_k <= MAX_STORED_K};
}

// Shared memory of a block, bytes (T: the operand type): Q, as TMA writes
// it (fp32: two [64][32] halves in 128 B swizzle), and in fp32 its lo copy;
// each warpgroup's region; the block's rows of acc and l (fp32); the
// warpgroups' partial row max and sum p; the block's row max; each row's
// correction and max; the barriers (Q, then each ring's full and empty
// slots); 1 KB to align the tiles to 1024 B (the swizzle atom). A bf16
// region is its ring of STAGES slots (K, or K and V where pass 2 recomputes
// S, V alone where it reads stored S), then its chunks' rounded s (STORE,
// bf16 pairs: a warpgroup's chunks of a tile at block_k <= MAX_STORED_K),
// where the first consumer's P.V partial goes once pass 2 has read them, or
// room for that partial. An fp32 region is one slot of a 32-key piece of K
// (two [32][32] halves in 128 B swizzle) and of V ([32][64] as it lies),
// then K's lo copy and V's piece transposed and split, hi and lo ([64][32]
// each, keys in P's order, 128 B swizzle), over which the warpgroup's P.V
// partial goes once pass 2 is done.
template <typename T, bool STORE, int CLUSTER>
struct Smem {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int SLOTS = F32 ? 1 : STAGES;  // ring slots of a warpgroup
  static constexpr int KEPT = MAX_STORED_K / 64 / (WGS * CLUSTER);  // stored chunks of a warpgroup
  static constexpr size_t PIECE = F32 ? sizeof(float) * PIECE_KEYS * D : TILE_BYTES;
  static constexpr size_t SLOT = STORE && !F32 ? PIECE : 2 * PIECE;
  // in a region: the kept s ([KEPT][16][128] u32) or the partial; fp32: K's
  // lo copy, V^T hi and V^T lo, and then the partial
  static constexpr size_t PART_AT = SLOT * SLOTS;
  static constexpr size_t KLO = PART_AT, VTH = KLO + PIECE, VTL = VTH + PIECE;
  static constexpr size_t REGION =
      PART_AT + (F32 ? 3 * PIECE : STORE ? (size_t)KEPT * TILE_BYTES : PART_BYTES);
  static constexpr size_t Q = 0;
  static constexpr size_t QLO = Q + (F32 ? 2 * TILE_BYTES : TILE_BYTES);
  static constexpr size_t REGIONS = F32 ? 2 * QLO : QLO;
  static constexpr size_t ACC = REGIONS + REGION * WGS;  // [64 / CLUSTER][64] fp32
  static constexpr size_t LS = ACC + sizeof(float) * 64 / CLUSTER * D;  // [64 / CLUSTER]
  static constexpr size_t MAX = LS + sizeof(float) * 64 / CLUSTER;
  static constexpr size_t SUM = MAX + sizeof(float) * WGS * 64;
  static constexpr size_t CMAX = SUM + sizeof(float) * WGS * 64;
  static constexpr size_t CF = CMAX + sizeof(float) * 64;
  static constexpr size_t MS = CF + sizeof(float) * 64;
  static constexpr size_t BARS = MS + sizeof(float) * 64;
  static constexpr size_t BYTES = BARS + sizeof(uint64_t) * (1 + 2 * WGS * SLOTS) + 1024;
  static_assert(PART_BYTES <= REGION - PART_AT, "a P.V partial fits its region");
  static_assert(BYTES <= 232448, "a block fits the SM's shared memory");
};
constexpr size_t wgmma_smem(bool f32, bool store, bool cluster) {
  return f32 ? (cluster ? Smem<float, false, 2>::BYTES : Smem<float, false, 1>::BYTES)
         : store ? (cluster ? Smem<bf16_t, true, 2>::BYTES : Smem<bf16_t, true, 1>::BYTES)
                 : (cluster ? Smem<bf16_t, false, 2>::BYTES : Smem<bf16_t, false, 1>::BYTES);
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
//
// T = float (flash_tf32_wgmma_kernel) runs every product in 3xTF32 on
// m64nNk8 (hopper.cuh): Q's lo copy is written once; each 64-key chunk
// arrives as two 32-key pieces, one ring fill each, and the consumer writes
// the piece's K lo copy (and in pass 2 V transposed and split, keys in P's
// order) before its products: S = Q_hi.K_lo + Q_lo.K_hi + Q_hi.K_hi (Q and
// K both K-major in shared memory), P.V = P_hi.V_lo + P_lo.V_hi + P_hi.V_hi
// (P split in registers from the S accumulator).
template <typename T, bool STEP, typename TO, bool STORE, int CLUSTER, int VIRT>
__device__ __forceinline__ void flash_tile(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                           const CUtensorMap* vmap, int hrows, const Out& o,
                                           const Carries& cy, const int* __restrict__ lens,
                                           int Nq, int Nk, float scale, int block_k, int quant) {
  constexpr bool F32 = std::is_same<T, float>::value;
  using L = Smem<T, STORE, CLUSTER>;
  constexpr int NS = L::SLOTS;                 // ring slots of a warpgroup
  constexpr int SPLIT = WGS * CLUSTER * VIRT;  // consumers of a tile
  constexpr int OWN = L::KEPT / VIRT;          // stored chunks of one consumer
  static_assert(!F32 || (!STORE && VIRT == 1), "fp32: S recomputed, one consumer a warpgroup");
  extern __shared__ __align__(1024) unsigned char wg_raw[];
  unsigned char* const smem_raw = align1024(wg_raw);
  unsigned char* const qs = smem_raw + L::Q;      // Q as TMA writes it (fp32: hi)
  unsigned char* const qlo = smem_raw + L::QLO;   // fp32: Q's lo copy
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
  auto full = [&](int r, int s) { return bars + 1 + r * NS + s; };
  auto empty = [&](int r, int s) { return bars + 1 + WGS * NS + r * NS + s; };

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
  // STEP: the carry row of i0; the rows of this head of out. Formed where
  // they are used, so they hold no registers through the tile loop
  auto cbase = [&]() { return ((size_t)opaque(b) * gridDim.y + opaque(h)) * Nq + i0; };
  auto out_rows = [&]() { return static_cast<TO*>(o.ptr) + b * o.bs + h * o.hs; };
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
        const size_t at = cbase() + rows0 + i / D;
        if (i0 + rows0 + i / D < Nq) cy.acc_out[at * D + i % D] = cy.acc_in[at * D + i % D];
      }
      if (threadIdx.x < half && i0 + rows0 + threadIdx.x < Nq) {
        const size_t at = cbase() + rows0 + threadIdx.x;
        cy.m_out[at] = cy.m_in[at];
        cy.l_out[at] = cy.l_in[at];
      }
      return;
    }
  }
  if (!STEP && i0 >= lq) {  // a tile wholly past q_len (the whole cluster): zeros
    TO* const out = out_rows();
    for (int i = threadIdx.x; i < half * D; i += blockDim.x) {
      const int gi = i0 + rows0 + i / D;
      if (gi < Nq) out[(long long)gi * o.rs + i % D] = lg::from_f<TO>(0.f);
    }
    return;
  }
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int r = 0; r < WGS; ++r)
      for (int s = 0; s < NS; ++s) {
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
      // a box of rows from `row` of head h of map m, from column x (bit m
      // of hrows: its rank-4 map runs (64, H, N, B), else (64, N, H, B))
      auto load = [&](void* dst, const CUtensorMap* map, int m, uint64_t* bar, int row,
                      int x = 0) {
        if ((hrows >> m) & 1)
          tma_load(dst, map, bar, x, h, row, b);
        else
          tma_load(dst, map, bar, x, row, h, b);
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
        tma_prefetch(qmap);
        tma_prefetch(kmap);
        tma_prefetch(vmap);
        if constexpr (F32) {  // two 32-float halves
          mbar_expect_tx(qbar, 2 * TILE_BYTES);
          load(qs, qmap, 0, qbar, i0);
          load(qs + TILE_BYTES, qmap, 0, qbar, i0, 32);
        } else {
          mbar_expect_tx(qbar, TILE_BYTES);
          load(qs, qmap, 0, qbar, i0);
        }
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
          if constexpr (F32) {  // a chunk's two 32-key pieces, a fill each: K's
                                // two 32-float halves, and V's piece in pass 2
            for (int j = first(0, r); j < nct; j += SPLIT) {
              for (int hp = 0; hp < 2; ++hp, ++i) {
                const int s = i % NS, row = base + j * 64 + PIECE_KEYS * hp;
                unsigned char* const dst = region(r) + L::SLOT * s;
                mbar_wait(empty(r, s), ((i / NS) & 1) ^ 1);
                mbar_expect_tx(full(r, s), static_cast<int>(L::PIECE) * (pass ? 2 : 1));
                load(dst, kmap, 1, full(r, s), row);
                load(dst + L::PIECE / 2, kmap, 1, full(r, s), row, 32);
                if (pass) load(dst + L::PIECE, vmap, 2, full(r, s), row);
              }
            }
          } else {
            for (int v = 0; v < VIRT; ++v) {
              for (int j = first(v, r); j < nct; j += SPLIT, ++i) {
                const int s = i % NS;
                mbar_wait(empty(r, s), ((i / NS) & 1) ^ 1);
                mbar_expect_tx(full(r, s), TILE_BYTES * (pass && !STORE ? 2 : 1));
                if (!pass || !STORE) load(slot(r, s), kmap, 1, full(r, s), base + j * 64);
                if (pass)
                  load(slot(r, s) + (STORE ? 0 : TILE), vmap, 2, full(r, s), base + j * 64);
              }
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
    m[r] = STEP && i0 + row0 + 8 * r < Nq ? cy.m_in[cbase() + row0 + 8 * r] : NEG;
  if (owner) {
    const int row = own_row(), c8 = own_col();
    const bool carried = STEP && i0 + rows0 + row < Nq;
    float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (carried) load8(cy.acc_in + (cbase() + rows0 + row) * D + c8, a, true);
    store8(acc_s + row * D + c8, a);
    if (c8 == 0) l_s[row] = carried ? cy.l_in[cbase() + rows0 + row] : 0.f;
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
  // fp32: E = 16, the piece k0 / 32 in slot s, 24 m64n32k8 products in
  // 3xTF32 with K's lo copy already written.
  auto scores = [&](auto& sc, int s, int base, int j, int k0) {
    constexpr int E = std::extent_v<std::remove_reference_t<decltype(sc)>>;
    fence_operand(sc);
    wgmma_fence();
    if constexpr (F32) {  // Q_hi.K_lo, Q_lo.K_hi, Q_hi.K_hi (K_hi: the piece as TMA wrote it)
      const uint64_t qh = opaque(kmajor_desc(qs, 0)), ql = qh + (L::QLO - L::Q) / 16;
      const uint64_t kh = opaque(kmajor_desc(region(wg) + L::SLOT * s, 0));
      const uint64_t kl = kh + (L::KLO - L::SLOT * s) / 16;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        wgmma_tf32_m64n32(sc, desc_step_f32(qh, 64, kk), desc_step_f32(kl, PIECE_KEYS, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        wgmma_tf32_m64n32(sc, desc_step_f32(ql, 64, kk), desc_step_f32(kh, PIECE_KEYS, kk), 1);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        wgmma_tf32_m64n32(sc, desc_step_f32(qh, 64, kk), desc_step_f32(kh, PIECE_KEYS, kk), 1);
    } else {
      const bf16_t* ks = slot(wg, s) + k0 * D;
#pragma unroll
      for (int k16 = 0; k16 < D / 16; ++k16) {
        if constexpr (E == 32)
          wgmma_m64n64<0>(sc, kmajor_desc(qs, k16), kmajor_desc(ks, k16), k16);
        else
          wgmma_m64n32<0>(sc, kmajor_desc(qs, k16), kmajor_desc(ks, k16), k16);
      }
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
  // fp32: the ring's fill-th piece landed in its slot (returned), its K lo
  // copy written (and with_v V's piece transposed and split: V^T[d][8 j + q]
  // holds key 8 j + 2 q (q < 4) or 8 j + 2 (q - 4) + 1 of the piece, P's
  // order, as 16 B unit u = (8 j + q) / 4 of row d at u ^ d % 8), then the
  // warpgroup synced
  auto land = [&](int fill, bool with_v) {
    const int s = fill % NS;
    if constexpr (F32) {
      mbar_wait(full(wg, s), (fill / NS) & 1);
      unsigned char* const kr = region(wg) + L::SLOT * s;
      unsigned char* const kl = region(wg) + L::KLO;
      tf32_lo_copy(reinterpret_cast<float*>(kr), reinterpret_cast<float*>(kl), PIECE_KEYS * D,
                   tid, 128);
      if (with_v) {
        const float* vr = reinterpret_cast<const float*>(kr + L::PIECE);  // [32 keys][64]
        unsigned char* const vth = region(wg) + L::VTH;
        unsigned char* const vtl = region(wg) + L::VTL;
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
    }
    return s;
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
  if constexpr (F32) {  // Q's lo copy, once, by every consumer thread
    tf32_lo_copy(reinterpret_cast<float*>(qs), reinterpret_cast<float*>(qlo), 64 * D,
                 threadIdx.x, WGS * 128);
    fence_proxy_async();
    bar_sync(1, WGS * 128);
  }

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
    if constexpr (F32) {  // a chunk's two pieces, a fill each
      for (int j = first(0, wg); j < nct; j += SPLIT) {
#pragma unroll 1
        for (int hp = 0; hp < 2; ++hp, ++i) {
          const int s = land(i, false);
          float sc[16];
          scores(sc, s, base, j, PIECE_KEYS * hp);
          release(s);
#pragma unroll
          for (int e = 0; e < 16; ++e) mx[(e / 2) & 1] = fmaxf(mx[(e / 2) & 1], sc[e]);
        }
      }
    } else {
#pragma unroll 1
      for (int v = 0; v < VIRT; ++v) {
        int c = v * OWN;  // this chunk's place in the store
        for (int j = first(v, wg); j < nct; j += SPLIT, ++i, ++c) {
          const int s = i % NS;
          mbar_wait(full(wg, s), (i / NS) & 1);
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
      if constexpr (F32) {  // a chunk's two pieces: S again, p, and their P.V in 3xTF32
        for (int j = first(v, wg); j < nct; j += SPLIT) {
#pragma unroll 1
          for (int hp = 0; hp < 2; ++hp, ++i) {
            const int s = land(i, true);
            float sc[16];
            scores(sc, s, base, j, PIECE_KEYS * hp);
            release(s);  // V is in its copies and S is done: the next piece may land
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
            // P.V in 16-key halves (P's registers of one half live beside
            // P.V's accumulator): P's A fragment of k step kk (keys 8 kk..)
            // takes key 2 t4 in slot t4 (accumulator 4 kk, row g; 4 kk + 2,
            // row g + 8) and key 2 t4 + 1 in slot t4 + 4 (4 kk + 1, 4 kk +
            // 3), split into (hi, lo); V^T's k step kk is 32 B along its rows
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
      } else {
        for (int j = first(v, wg); j < nct; j += SPLIT, ++i, ++c) {
          const int s = i % NS;
          mbar_wait(full(wg, s), (i / NS) & 1);
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
      float sum = 0.f, x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      // fp32: one consumer's pair of partials at a time (all loads first
      // would hold 72 registers beside the carries and spill); the same sums
      if constexpr (F32 && CLUSTER > 1) {
#pragma unroll 1
        for (int c = 0; c < WGS; ++c) {  // q_c = p_c + p_{c + WGS}: block 0's c, block 1's c
          const float* src = part(c) + part_at(irow, c8);
          const float q = ld_dsmem(dsmem(red_sum + c * 64 + irow, 0)) +
                          ld_dsmem(dsmem(red_sum + c * 64 + irow, 1));
          const float4 l0 = ld_dsmem4(dsmem(src, 0)), l1 = ld_dsmem4(dsmem(src, 1));
          const float4 h0 = ld_dsmem4(dsmem(src + 4, 0)), h1 = ld_dsmem4(dsmem(src + 4, 1));
          const float y[8] = {l0.x + l1.x, l0.y + l1.y, l0.z + l1.z, l0.w + l1.w,
                              h0.x + h1.x, h0.y + h1.y, h0.z + h1.z, h0.w + h1.w};
          sum += q;
#pragma unroll
          for (int e = 0; e < 8; ++e) x[e] += y[e];
        }
      } else {
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
    const size_t at = cbase() + irow;
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
  store8(out_rows() + (long long)gi * o.rs + c8, a);
}

// bf16 operands (BF16, MIXED's fp32 output TO, the ring step at bf16)
template <bool STEP, typename TO, bool STORE, int CLUSTER, int VIRT>
__global__ void __launch_bounds__((WGS + 1) * 128, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, int hrows, Out o, Carries cy,
                   const int* __restrict__ lens, int Nq, int Nk, float scale, int block_k,
                   int quant) {
  flash_tile<bf16_t, STEP, TO, STORE, CLUSTER, VIRT>(&qmap, &kmap, &vmap, hrows, o, cy, lens, Nq,
                                                     Nk, scale, block_k, quant);
}

// fp32 operands in 3xTF32 (the FP32 rung, fp32 operands at bf16 stats in
// the ring step): an fp32 output, S recomputed in pass 2, one consumer a
// warpgroup (a split of 8 as a cluster of two blocks)
template <bool STEP, int CLUSTER>
__global__ void __launch_bounds__((WGS + 1) * 128, 1)
flash_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, int hrows, Out o, Carries cy,
                        const int* __restrict__ lens, int Nq, int Nk, float scale, int block_k,
                        int quant) {
  flash_tile<float, STEP, float, false, CLUSTER, 1>(&qmap, &kmap, &vmap, hrows, o, cy, lens, Nq,
                                                    Nk, scale, block_k, quant);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// One head's rows of an operand of `type` (2 or 4 bytes an element),
// (B, H, N, 64) by (batch, head, row) strides in elements (an activation
// (B, N, H*64) has head stride 64), as a rank-4 tensor map read in boxes of
// box_cols x box_rows written in `swizzle` bytes of swizzle: (64, H, N, B)
// where heads lie inside a row (hrows = 1), else (64, N, H, B), so the
// strides grow outward. A dimension of one takes a stride past the others.
int head_map(CUtensorMap* map, const Operand& o, int B, int H, int rows, int& hrows,
             CUtensorMapDataType type, int box_cols, int box_rows, int swizzle) {
  const int es = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  hrows = H > 1 && o.hs < o.rs;
  const long long hs = H > 1 ? o.hs : (long long)rows * o.rs;
  const long long bs = B > 1 ? o.bs : (hrows ? (long long)rows * o.rs : (long long)H * hs);
  if (!tma_aligned(o.ptr, es * o.rs, es * hs) || (es * bs) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[4] = {D, (cuuint64_t)(hrows ? H : rows), (cuuint64_t)(hrows ? rows : H),
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(es * (hrows ? hs : o.rs)),
                                 (cuuint64_t)(es * (hrows ? o.rs : hs)), (cuuint64_t)(es * bs)};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, hrows ? 1u : (cuuint32_t)box_rows,
                             hrows ? (cuuint32_t)box_rows : 1u, 1};
  return tma_map(map, o.ptr, type, 4, dims, strides, box, swizzle);
}

template <typename T, bool STEP, typename TO, bool STORE, int CLUSTER, int VIRT>
int launch_wgmma(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, int hrows,
                 Out o, Carries cy, const void* lens, int B, int H, int Nq, int Nk, float scale,
                 int block_k, int quant, cudaStream_t stream) {
  constexpr size_t smem = Smem<T, STORE, CLUSTER>::BYTES;
  auto kernel = [] {
    if constexpr (std::is_same<T, float>::value)
      return flash_tf32_wgmma_kernel<STEP, CLUSTER>;
    else
      return flash_wgmma_kernel<STEP, TO, STORE, CLUSTER, VIRT>;
  }();
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

// Either kernel at wgmma_plan's launch, which the caller's plan (row_groups,
// col_split, stages: kernels/attention.py:flash_plan) must be: four 16-row
// groups (a 64-row tile), the split, the ring's slots. T: the operand type
// (bf16: 64 x 64 boxes in 128 B swizzle; fp32: Q and K in 32-float boxes of
// 64 and 32 rows in 128 B swizzle, V in 64 x 32 boxes as they lie)
template <typename T, bool STEP, typename TO>
int launch_wg(Operand q, Operand k, Operand v, Out o, Carries cy, const void* lens, int B, int H,
              int Nq, int Nk, float scale, int block_k, int quant, int row_groups, int col_split,
              int stages, cudaStream_t s) {
  constexpr bool F32 = std::is_same<T, float>::value;
  const WgPlan p = wgmma_plan(B, H, Nq, block_k, quant, F32);
  if (row_groups != 4 || col_split != p.split || stages != (F32 ? 1 : STAGES))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  int hq, hk, hv;
  constexpr CUtensorMapDataType type = tma_type<T>();
  const int errs[3] = {
      head_map(&qm, q, B, H, Nq, hq, type, F32 ? 32 : D, 64, 128),
      head_map(&km, k, B, H, Nk, hk, type, F32 ? 32 : D, F32 ? PIECE_KEYS : 64, 128),
      head_map(&vm, v, B, H, Nk, hv, type, D, F32 ? PIECE_KEYS : 64, F32 ? 0 : 128)};
  for (const int err : errs)
    if (err) return err;
  // the forms: a cluster of two blocks, one consumer a warpgroup (split 8);
  // one block, two consumers a warpgroup (split 8, bf16) or one (split 4)
  decltype(&launch_wgmma<T, STEP, TO, false, 1, 1>) run;
  if constexpr (F32)
    run = p.cluster ? launch_wgmma<T, STEP, TO, false, 2, 1> : launch_wgmma<T, STEP, TO, false, 1, 1>;
  else
    run = p.store ? (p.cluster          ? launch_wgmma<T, STEP, TO, true, 2, 1>
                     : p.split == 8     ? launch_wgmma<T, STEP, TO, true, 1, 2>
                                        : launch_wgmma<T, STEP, TO, true, 1, 1>)
                  : (p.cluster          ? launch_wgmma<T, STEP, TO, false, 2, 1>
                     : p.split == 8     ? launch_wgmma<T, STEP, TO, false, 1, 2>
                                        : launch_wgmma<T, STEP, TO, false, 1, 1>);
  return run(qm, km, vm, hq | hk << 1 | hv << 2, o, cy, lens, B, H, Nq, Nk, scale, block_k, quant,
             s);
}

// operand modes (kernels/attention.py mirrors them): FP32 (fp32 operands and
// out), BF16 (bf16 operands and out), BF16_F32_OUT (bf16 operands, fp32 out;
// not the ring step, which writes fp32 carries in every mode)
enum Mode { FP32 = 0, BF16 = 1, BF16_F32_OUT = 2 };

// Both kernels at the plan of kernels/attention.py:flash_plan, (4, split,
// ring slots): bf16 operands on flash_wgmma_kernel, fp32 operands on
// flash_tf32_wgmma_kernel. A caller with RoPE has rotated q and k first.
template <bool STEP>
int launch(Operand q, Operand k, Operand v, Out o, Carries cy, const void* lens, int B, int H,
           int Nq, int Nk, float scale, int block_k, int quant, int row_groups, int col_split,
           int stages, int mode, cudaStream_t s) {
  if (mode == FP32)
    return launch_wg<float, STEP, float>(q, k, v, o, cy, lens, B, H, Nq, Nk, scale, block_k,
                                         quant, row_groups, col_split, stages, s);
  if (mode == BF16)  // the ring step writes fp32 carries: its TO is never stored
    return launch_wg<bf16_t, STEP, std::conditional_t<STEP, float, bf16_t>>(
        q, k, v, o, cy, lens, B, H, Nq, Nk, scale, block_k, quant, row_groups, col_split, stages,
        s);
  if constexpr (!STEP) {
    if (mode == BF16_F32_OUT)
      return launch_wg<bf16_t, false, float>(q, k, v, o, cy, lens, B, H, Nq, Nk, scale, block_k,
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
// a block (a 64-row tile), consumers splitting each tile's chunks, ring slots
// of a consumer warpgroup, blocks of the launch, dynamic shared memory in
// bytes, clusters of two blocks a tile, pass 1's s kept}: FP32
// flash_tf32_wgmma_kernel's, bf16 flash_wgmma_kernel's, at wgmma_plan's.
extern "C" int lg_flash_plan(int B, int H, int Nq, int block_k, int mode, int quant, int* out) {
  const bool f32 = mode == FP32;
  const WgPlan p = wgmma_plan(B, H, Nq, block_k, quant, f32);
  const int plan[7] = {4, p.split, f32 ? 1 : STAGES,
                       (p.cluster ? 2 : 1) * ((Nq + 63) / 64) * H * B,
                       static_cast<int>(wgmma_smem(f32, p.store, p.cluster)), p.cluster, p.store};
  for (int i = 0; i < 7; ++i) out[i] = plan[i];
  return 0;
}
