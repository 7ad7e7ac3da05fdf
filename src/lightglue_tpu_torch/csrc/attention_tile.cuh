// The two-pass attention tile on Hopper's warpgroup MMA, shared by the
// layer stack's attention (attention.cu: attention_wgmma_kernel,
// attention_tf32_wgmma_kernel) and both cross directions in one launch
// (bidir_cross.cu: bidir_wgmma_kernel, bidir_tf32_wgmma_kernel). Each of
// those kernels is a thin shell: it finds its 64-row tile of one head (and,
// in bidir_cross.cu, its direction), fills a Tile and runs the body here;
// attention.cu describes the design (its header comment) and bidir_cross.cu
// what the second user changes.
//
// What a body computes over one 64-row tile of one head: s = quant(Q.K^T *
// scale); pad columns past Nk at -inf (TMA brings rows past Nk as zeros,
// which would score 0), dead columns (keep < 0.5, or at or past the live
// keys) at -1e30; pass 1 the row max m = quant(max s), clamped at -5e29
// where Tile::clamp says so; pass 2 p = quant(exp(s - m)), l = quant(sum p)
// (dir1: p summed after its cast to the V type) and P.V in fp32 with P in
// the V type; o = P.V / (l == 0 ? 1 : l), times keep (KEEP) or 0 for rows
// at or past Tile::lq; one cast to the output type. A tile wholly past lq
// writes its zeros before any work. Chunks wholly past the live keys are
// not loaded or computed: with a live key in the row, m comes from it and a
// dead p is exactly 0.
//
// - bf16 operands (attention_tile): SPLIT consumers of a tile split its
//   64-key chunks (chunk j to consumer j % SPLIT) in one of two forms of
//   the same sums (Split). Stats: fp32 (BSTATS false), or bf16 (BSTATS),
//   where s and p round to bf16 in packed pairs and pass 2 either reads
//   pass 1's rounded s back from shared memory (STORE: s is rounded by the
//   contract, so that is exact, and pass 2 streams V alone; Nk <= 1024) or
//   recomputes S with the same instructions, bit for bit pass 1's.
// - fp32 operands (attention_tf32_tile): 3xTF32 on wgmma m64nNk8, 32-key
//   pieces a ring fill, WGS * CLUSTER consumers (a split of 8 a cluster of
//   two blocks, 4 one block); pass 2 always recomputes S. p's cast to the
//   fp32 V type is the identity, so dir1 changes nothing there.
#pragma once

#include <math.h>

#include "hopper.cuh"

namespace lg {

constexpr int D = HD;  // head dim
constexpr float NEG = -1e30f;
constexpr float DEAD = -5e29f;

// ---------------------------------------------------------------------------
// bf16 operands: warpgroups on wgmma, fed by TMA rings
// ---------------------------------------------------------------------------

constexpr int SPLIT = 8;        // consumers splitting a row's chunks: chunk j to j % SPLIT
constexpr int WGS = 4;          // consumer warpgroups of a block
constexpr int STAGES = 2;       // chunk slots of each warpgroup's ring
constexpr int TILE = 64 * D;    // elements of a 64-row tile of one head (8 KB in bf16)
constexpr int TILE_BYTES = 2 * TILE;
constexpr int PART_BYTES = 4 * 64 * D;  // a consumer's fp32 P.V partial, 64 x 64
constexpr int CLUSTER_SMS = 132;  // a launch takes clusters of two while their blocks fit the SMs
constexpr int STORED_KEYS = 1024;  // the most keys whose rounded s pass 1 keeps (STORE)
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
  static constexpr int KEPT = STORED_KEYS / 64 / SPLIT * VIRT;  // its chunks of stored S
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

// 64-row tiles of n rows
constexpr int tiles_of(int n) { return (n + 63) / 64; }
// the bf16 kernels' form: clusters of two blocks a tile while a launch of
// `tiles` tiles a head fits the card's SMs, else one block a tile
constexpr bool use_cluster(int B, int H, int tiles) { return 2ll * B * H * tiles <= CLUSTER_SMS; }
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

// One 64-row tile of one head, as its kernel found it
template <typename TO>
struct Tile {
  const CUtensorMap* qmap;  // Q's rows (its kernel's __grid_constant__ maps)
  const CUtensorMap* kmap;  // K's rows
  const CUtensorMap* vmap;  // V's rows
  TO* ob;                   // this head's output: row gi at ob + gi * H * D
  int b, h, i0;             // pair, head, first row
  int Nq, Nk, H;
  int lq;                   // rows at or past it are 0
  int live_k;               // keys that can be live: the chunks past them are skipped
  bool clamp;               // the row max clamped at -5e29
  const float* kq;          // KEEP: this pair's (Nq,) and (Nk,) keep vectors
  const float* kk;
};

// A 64-row tile of one head: SPLIT consumers (see Split) in one block or a
// cluster of two. Each block has a producer warpgroup (lane 0 of warp r
// feeds warpgroup r's ring by TMA) and WGS consumer warpgroups; consumer gc
// takes the chunks j with j % SPLIT == gc, the 64 rows' S and P.V over
// them. The consumers meet after each pass: in shared memory within a
// block, across a cluster through distributed shared memory (the row max;
// then each block adds the partial sums p and P.V of its share of the rows
// in Split's order). BSTATS: bf16 stats; STORE (bf16 stats): pass 1 keeps
// each chunk's rounded s in shared memory, and pass 2 reads it back in
// place of recomputing Q.K^T and streams V alone.
template <bool KEEP, typename TO, bool STORE, bool BSTATS, int CLUSTER>
__device__ __forceinline__ void attention_tile(const Tile<TO>& t, float scale, int quant,
                                               int dir1) {
  static_assert(BSTATS || !STORE, "pass 1 keeps s only at bf16 stats");
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
  const int b = t.b, h = t.h, i0 = t.i0, Nq = t.Nq, Nk = t.Nk, H = t.H;
  const int lq = t.lq, live_k = t.live_k;
  TO* const ob = t.ob;
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
        tma_prefetch(t.qmap);
        tma_prefetch(t.kmap);
        tma_prefetch(t.vmap);
        mbar_expect_tx(qbar, TILE_BYTES);
        tma_load(qs, t.qmap, qbar, h * D, i0, b);
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
            if (!pass || !STORE) tma_load(slot(r, s), t.kmap, full(r, s), h * D, j * 64, b);
            if (pass)
              tma_load(slot(r, s) + (STORE ? 0 : TILE), t.vmap, full(r, s), h * D, j * 64, b);
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
        else if (KEEP ? __ldg(t.kk + col) < 0.5f : col >= live_k)
          dead |= 1u << bit;
      }
    }
    wgmma_wait<0>();
    fence_operand(sc);
#pragma unroll
    for (int k = 0; k < 16; ++k) {  // a pair of a row's columns at a time
      float x[2] = {sc[2 * k] * scale, sc[2 * k + 1] * scale};
      if (BSTATS) {  // bf16 stats (quant): both rounded in one packed conversion
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
    if (t.clamp) m[r] = fmaxf(m[r], DEAD);
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
      if constexpr (BSTATS) {
        // bf16 stats: p in pairs (one row, columns 2 t4, 2 t4 + 1) rounded
        // in one packed conversion, which is also P.V's A operand (p is
        // already in the V type, so dir1's sum is the same)
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
    const bool zero = !KEEP && gi >= lq;
    const float keep = KEEP ? t.kq[gi] : 1.f;
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
// fp32 operands: the same warpgroups in 3xTF32 on wgmma m64nNk8
// ---------------------------------------------------------------------------

constexpr int PIECE_KEYS = 32;             // keys of an fp32 ring slot: half a chunk
constexpr int PIECE = 4 * PIECE_KEYS * D;  // bytes of an fp32 piece of K or V (8 KB)
constexpr int F32_TILE = 4 * TILE;         // bytes of a 64-row fp32 tile of one head

// consumers splitting a 64-row tile's chunks at fp32 operands: 8 where one
// pair's `tiles` tiles a head, two blocks each, fit the card's SMs, else 4
// (the pair's shape, never the batch; kernels/layer_stack.py:tf32_split and
// kernels/attention.py:bidir_plan mirror it)
constexpr int tf32_split(int H, int tiles) { return 2ll * H * tiles <= CLUSTER_SMS ? 8 : 4; }

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
// two 32-key pieces, a ring fill each; otherwise the bf16 body's
// structure: producer warp r feeds warpgroup r's ring, the consumers meet
// after each pass, each block's consumer threads add the partials of its
// share of the rows. Q's map reads 32-float boxes of 64 rows, K's of 32
// keys (both 128 B swizzle), V's 64-float boxes of 32 keys as they lie.
// QUANT: bf16 stats (1) or not (0) fixed at compile time, or (-1) read from
// quant_arg.
template <bool KEEP, int CLUSTER, int QUANT = -1>
__device__ __forceinline__ void attention_tf32_tile(const Tile<float>& t, float scale,
                                                    int quant_arg) {
  const int quant = QUANT < 0 ? quant_arg : QUANT;
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
  const int b = t.b, h = t.h, i0 = t.i0, Nq = t.Nq, Nk = t.Nk, H = t.H;
  const int lq = t.lq, live_k = t.live_k;
  float* const ob = t.ob;
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
        tma_prefetch(t.qmap);
        tma_prefetch(t.kmap);
        tma_prefetch(t.vmap);
        mbar_expect_tx(qbar, F32_TILE);
        tma_load(qs, t.qmap, qbar, h * D, i0, b);
        tma_load(qs + F32_TILE / 2, t.qmap, qbar, h * D + 32, i0, b);
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
            tma_load(dst, t.kmap, full(r), h * D, row, b);
            tma_load(dst + PIECE / 2, t.kmap, full(r), h * D + 32, row, b);
            if (pass) tma_load(dst + PIECE, t.vmap, full(r), h * D, row, b);
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
        else if (KEEP ? __ldg(t.kk + col) < 0.5f : col >= live_k)
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
    if (t.clamp) m[r] = fmaxf(m[r], DEAD);
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
    const bool zero = !KEEP && gi >= lq;
    const float keep = KEEP ? t.kq[gi] : 1.f;
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
// host: tensor maps and launches
// ---------------------------------------------------------------------------

// One head's columns of a (B, rows, H*64) operand of `type` (bf16 or fp32)
// addressed by (batch, row) strides in elements, read in boxes of box_cols x
// box_rows written in `swizzle` bytes of swizzle (0: as they lie); TMA needs
// 16 B bases and strides (else cudaErrorInvalidValue)
inline int head_map(CUtensorMap* map, const Operand& o, int B, int rows, int H,
                    CUtensorMapDataType type, int box_cols, int box_rows, int swizzle) {
  const int es = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const long long bs = B > 1 ? o.bs : (long long)rows * o.rs;  // one batch entry: any stride
  if (!tma_aligned(o.ptr, es * o.rs, es * bs)) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[3] = {(cuuint64_t)H * D, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)(es * o.rs), (cuuint64_t)(es * bs)};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  return tma_map(map, o.ptr, type, 3, dims, strides, box, swizzle);
}

// A kernel of `tiles` 64-row tiles a head per block, or per cluster of
// cluster_blocks blocks (grid: the tiles' blocks, heads, pairs)
template <typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, int cluster_blocks, size_t smem, int B, int tiles, int H,
                 cudaStream_t stream, Args... args) {
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = cluster_blocks;
  cluster[0].val.clusterDim.y = cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster_blocks * tiles, H, B);
  cfg.blockDim = dim3((WGS + 1) * 128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = cluster_blocks > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
}

}  // namespace lg
