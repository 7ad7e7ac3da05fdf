// Both directions of LightGlue's symmetric cross-attention in one launch:
// image 0's rows attend to image 1 (the row softmax of S) and image 1's rows
// attend to image 0 (the column softmax of the same S).
//
// Replaces lightglue_tpu/kernels/attention.py:bidirectional_cross_attention
// (wrapper :925, pallas_call :985, body :811-919). The TPU kernel holds one
// S per head in VMEM and softmaxes it along both axes. Here a direction-1
// tile computes rows of S^T as qk1_j . qk0_i, the same products over d.
//
// Contract (attention.py:855-910): s = quant(qk0 . qk1 * scale) once, no
// online rescaling; per direction the kv columns >= the other image's length
// become -1e30 and pad columns past Nk -inf, m = quant(rowmax), p =
// quant(exp(s - m)), l = quant(sum p) (direction 1 sums P after its cast to
// the V type, :885-897), P.V accumulates in fp32 with P in the V type and is
// divided by l in fp32 (l == 0 divides by 1), padded rows are 0. quant
// rounds through bf16 at bf16 stats. There is no -5e29 clamp. One
// deliberate departure: a direction whose kv side has length 0 writes 0
// rows, as fused_mha and the layer stack do; the TPU kernel gives the mean
// of the padded values in fp32 and NaN in bf16 there (ROADMAP queue 3).
//
// Bound on the H100: per head 2 * 2 * N0 * N1 * D FLOP for the two P.V
// products and 2 * N0 * N1 * D for S (the TPU kernel's one S; here each
// direction computes it, and recomputes it in pass 2 where s is not kept),
// against (2 N0 + 2 N1) * D operands: tensor-core bound (~0.013 ms at 960 x
// 960, B = 1, H = 4, in bf16; ~0.077 ms in fp32 at three TF32 products a
// product).
//
// Both kernels are the layer stack's attention tile on Hopper's warpgroup
// MMA (attention_tile.cuh, whose design attention.cu's header sets out),
// both directions in one grid:
// - blockIdx.x runs over direction 0's 64-row tiles (CLUSTER blocks each),
//   then direction 1's; blockIdx.y the head, blockIdx.z the pair. A
//   direction-0 tile takes Q = qk0, K = qk1, V = v1 with (len_q, len_kv) =
//   (n0, n1); a direction-1 tile Q = qk1, K = qk0, V = v0 with the lengths
//   swapped and dir1 set. The kernel takes one TMA tensor map per operand
//   and role (__grid_constant__, 128 B each) and picks by direction: bf16
//   four (qk0 and qk1 serve as Q and as K: one box), fp32 six (Q's boxes are
//   64 rows, K's 32-key pieces). The four operands are column slices of the
//   [qk | v] projection at row stride 2E; TMA needs 16 B bases and strides,
//   and an operand off them is refused (cudaErrorInvalidValue; the wrapper
//   raises a ValueError before any launch). The old kernels' element loads
//   for unaligned rows are gone.
// - What the tile body does for this contract: no clamp (Tile::clamp
//   false: with a live key in the row m comes from it, so the clamp could
//   not fire, and an empty kv side never reaches it); pad keys past Nk at
//   -inf at every call, masked or not (the body classifies the columns of
//   any chunk that reaches past the live keys, and those past Nk first:
//   Nk need not be a multiple of 64); chunks wholly past the live keys
//   skipped; an empty kv side writes its zero rows before any work (lq =
//   0); direction 1 sums p in the V type (dir1; at bf16 stats p is already
//   bf16, at fp32 operands the cast is the identity).
// - bf16 operands (bidir_wgmma_kernel<TO, STORE, BSTATS, CLUSTER>: BF16 and
//   INT8 at bf16 stats and out, MIXED at fp32 stats and out): eight
//   consumers split each row's 64-key chunks; a cluster of two blocks a
//   tile while the launch's blocks fit the 132 SMs, else one block a tile
//   whose warpgroups run two consumers each (the same sums: the batch may
//   pick the form); at bf16 stats pass 1 keeps its rounded s while both Nk
//   are at most 1024 (STORE), else pass 2 recomputes S at bf16 stats
//   (BSTATS without STORE, bit for bit the same), so any N fits.
// - fp32 operands (bidir_tf32_wgmma_kernel<CLUSTER, QUANT>: FP32, at fp32
//   or bf16 stats): 3xTF32 on wgmma m64nNk8, a split of 8 as a cluster
//   where one pair's tiles of both directions, two blocks each, fit the
//   SMs, else 4 in one block (tf32_split over both directions' tiles: the
//   pair's shape, never the batch). Its consumers have no register to
//   spare: the body is inlined once per direction, so each one's maps,
//   sizes and output stay kernel parameters, and the stats' rounding is a
//   template argument (a select between the directions' values, or quant
//   read at run time, spilled in ptxas; attention.cu's fp32 kernel has no
//   direction to select).
// - One pair at 960 x 960, H = 4 is 30 tiles a head, 120 in all: one block
//   a tile in bf16 (240 blocks would not fit 132 SMs as clusters), a split
//   of 4 in fp32; at H = 2 (60 tiles) and H = 1 (30) clusters and a split
//   of 8 (kernels/attention.py:bidir_plan mirrors lg_bidir_plan).
// The kernels they replace ran on mma.sync (bidir_mma_kernel, 16-row
// groups, a 64-key cp.async double buffer, warps meeting in shared memory;
// bidir_tf32_kernel, its 3xTF32 form on m16n8k8): at 960 x 960 on an H100
// at 700 W, 9 launches a pad-to-64 pair, 0.451 ms (BF16), 0.396 (MIXED),
// 0.711 (FP32), 0.4619 / 0.3818 at the TP shards' H = 2 / 1 (PERF.md
// section 6).

#include "attention_tile.cuh"

namespace {

using namespace lg;  // Operand, the tile bodies and their launch helpers (attention_tile.cuh)

// The tile of a block of the bidirectional grid, in direction dir1, with
// Q, K and V read through the given maps: the direction's lengths (lens:
// (B, 2) [n0, n1] or null), no clamp, and an empty kv side as lq = 0
template <typename TO>
__device__ __forceinline__ Tile<TO> bidir_tile(bool dir1, const CUtensorMap* q,
                                               const CUtensorMap* k, const CUtensorMap* v,
                                               const int* lens, TO* o0, TO* o1, int tiles0,
                                               int tile, int N0, int N1, int H) {
  Tile<TO> t;
  const int b = blockIdx.z, h = blockIdx.y;
  const int Nq = dir1 ? N1 : N0, Nk = dir1 ? N0 : N1;
  t.qmap = q, t.kmap = k, t.vmap = v;
  t.ob = (dir1 ? o1 : o0) + (size_t)b * Nq * H * D + h * D;
  t.b = b, t.h = h, t.i0 = (dir1 ? tile - tiles0 : tile) * 64;
  t.Nq = Nq, t.Nk = Nk, t.H = H;
  // keys that can be live: the other image's valid prefix
  t.live_k = lens ? max(min(lens[2 * b + !dir1], Nk), 0) : Nk;
  t.lq = t.live_k == 0 ? 0 : (lens ? lens[2 * b + dir1] : Nq);
  t.clamp = false;
  t.kq = t.kk = nullptr;
  return t;
}

// bf16 operands: a 64-row tile of one head of either direction per block
// or cluster of two (attention_tile.cuh:attention_tile)
template <typename TO, bool STORE, bool BSTATS, int CLUSTER>
__global__ void __launch_bounds__((WGS + 1) * 128, 1)
bidir_wgmma_kernel(const __grid_constant__ CUtensorMap qk0, const __grid_constant__ CUtensorMap qk1,
                   const __grid_constant__ CUtensorMap v0, const __grid_constant__ CUtensorMap v1,
                   const int* __restrict__ lens, TO* __restrict__ o0, TO* __restrict__ o1, int N0,
                   int N1, int H, float scale, int quant, int tiles0) {
  const int tile = blockIdx.x / CLUSTER;
  const bool dir1 = tile >= tiles0;  // image 1's rows attend to image 0
  const Tile<TO> t = bidir_tile(dir1, dir1 ? &qk1 : &qk0, dir1 ? &qk0 : &qk1, dir1 ? &v0 : &v1,
                                lens, o0, o1, tiles0, tile, N0, N1, H);
  attention_tile<false, TO, STORE, BSTATS, CLUSTER>(t, scale, quant, dir1);
}

// fp32 operands: the same grid in 3xTF32 (attention_tile.cuh:
// attention_tf32_tile) at bf16 stats (QUANT 1) or fp32 (0); q0 / q1 read
// 64-row boxes, k0 / k1 32-key pieces
template <int CLUSTER, int QUANT>
__global__ void __launch_bounds__((WGS + 1) * 128, 1)
bidir_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap q0,
                        const __grid_constant__ CUtensorMap q1,
                        const __grid_constant__ CUtensorMap k0,
                        const __grid_constant__ CUtensorMap k1,
                        const __grid_constant__ CUtensorMap v0,
                        const __grid_constant__ CUtensorMap v1, const int* __restrict__ lens,
                        float* __restrict__ o0, float* __restrict__ o1, int N0, int N1, int H,
                        float scale, int tiles0) {
  const int tile = blockIdx.x / CLUSTER;
  // the body inlined once per direction: each one's maps, sizes and output
  // stay kernel parameters (a select between them spilled)
  if (tile >= tiles0)  // image 1's rows attend to image 0
    attention_tf32_tile<false, CLUSTER, QUANT>(
        bidir_tile(true, &q1, &k0, &v0, lens, o0, o1, tiles0, tile, N0, N1, H), scale, QUANT);
  else
    attention_tf32_tile<false, CLUSTER, QUANT>(
        bidir_tile(false, &q0, &k1, &v1, lens, o0, o1, tiles0, tile, N0, N1, H), scale, QUANT);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// operand modes (kernels/attention.py mirrors them)
enum Mode { FP32 = 0, BF16 = 1, BF16_F32_OUT = 2 };

// The launch of one shape: the kernel (fp32 operands or bf16), the
// consumers splitting a row's chunks, the form (a cluster of two blocks a
// tile or one block), whether pass 1 keeps s, and both directions' tiles a
// head (kernels/attention.py:bidir_plan mirrors it)
struct Plan {
  bool f32, cluster, store;
  int split, tiles0, tiles;
  size_t smem;
};

inline Plan bidir_plan(int B, int H, int N0, int N1, int mode, int quant) {
  Plan p;
  p.tiles0 = tiles_of(N0);
  p.tiles = p.tiles0 + tiles_of(N1);
  p.f32 = mode == FP32;
  if (p.f32) {  // the pair's shape sets the split and its form
    p.split = tf32_split(H, p.tiles);
    p.cluster = p.split == 8;
    p.store = false;
    p.smem = TfSmem::BYTES;
  } else {  // the batch may pick the form: both give the same sums
    p.split = SPLIT;
    p.cluster = use_cluster(B, H, p.tiles);
    p.store = quant && (N0 > N1 ? N0 : N1) <= STORED_KEYS;
    p.smem = wgmma_smem(p.store, p.cluster);
  }
  return p;
}

// bf16 operands in one instantiation: each operand in 64 x 64 boxes (128 B
// swizzle), qk0's and qk1's maps read as Q or as K by direction
template <typename TO, bool STORE, bool BSTATS, int CLUSTER>
int launch_wgmma(Operand qk0, Operand qk1, Operand v0, Operand v1, const void* lens, void* o0,
                 void* o1, int B, int N0, int N1, int H, float scale, int quant, const Plan& p,
                 cudaStream_t stream) {
  constexpr size_t smem = Smem<STORE, CLUSTER>::BYTES;
  auto kernel = bidir_wgmma_kernel<TO, STORE, BSTATS, CLUSTER>;
  static const cudaError_t opt_in =  // above 48 KB: opt in once
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  constexpr CUtensorMapDataType BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap m0, m1, w0, w1;
  const int errs[4] = {head_map(&m0, qk0, B, N0, H, BF, D, 64, 128),
                       head_map(&m1, qk1, B, N1, H, BF, D, 64, 128),
                       head_map(&w0, v0, B, N0, H, BF, D, 64, 128),
                       head_map(&w1, v1, B, N1, H, BF, D, 64, 128)};
  for (const int err : errs)
    if (err) return err;
  return launch_tiles(kernel, CLUSTER, smem, B, p.tiles, H, stream, m0, m1, w0, w1,
                      static_cast<const int*>(lens), static_cast<TO*>(o0), static_cast<TO*>(o1),
                      N0, N1, H, scale, quant, p.tiles0);
}

// fp32 operands in one form and stats: Q in 32-float boxes of 64 rows and
// K in 32-float boxes of 32 keys (128 B swizzle), V in 64-float boxes of 32
// keys as they lie
template <int CLUSTER, int QUANT>
int launch_tf32(Operand qk0, Operand qk1, Operand v0, Operand v1, const void* lens, void* o0,
                void* o1, int B, int N0, int N1, int H, float scale, const Plan& p,
                cudaStream_t stream) {
  constexpr size_t smem = TfSmem::BYTES;
  auto kernel = bidir_tf32_wgmma_kernel<CLUSTER, QUANT>;
  static const cudaError_t opt_in =  // above 48 KB: opt in once
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap q0, q1, k0, k1, w0, w1;
  const int errs[6] = {head_map(&q0, qk0, B, N0, H, F32, 32, 64, 128),
                       head_map(&q1, qk1, B, N1, H, F32, 32, 64, 128),
                       head_map(&k0, qk0, B, N0, H, F32, 32, PIECE_KEYS, 128),
                       head_map(&k1, qk1, B, N1, H, F32, 32, PIECE_KEYS, 128),
                       head_map(&w0, v0, B, N0, H, F32, D, PIECE_KEYS, 0),
                       head_map(&w1, v1, B, N1, H, F32, D, PIECE_KEYS, 0)};
  for (const int err : errs)
    if (err) return err;
  return launch_tiles(kernel, CLUSTER, smem, B, p.tiles, H, stream, q0, q1, k0, k1, w0, w1,
                      static_cast<const int*>(lens), static_cast<float*>(o0),
                      static_cast<float*>(o1), N0, N1, H, scale, p.tiles0);
}

// bf16 operands at the plan's form: bf16 stats keep s (or recompute it past
// 1024 keys), fp32 stats recompute it
template <typename TO>
int launch_bf16(Operand qk0, Operand qk1, Operand v0, Operand v1, const void* lens, void* o0,
                void* o1, int B, int N0, int N1, int H, float scale, int quant, const Plan& p,
                cudaStream_t s) {
  auto run = !quant    ? (p.cluster ? launch_wgmma<TO, false, false, 2>
                                    : launch_wgmma<TO, false, false, 1>)
             : p.store ? (p.cluster ? launch_wgmma<TO, true, true, 2>
                                    : launch_wgmma<TO, true, true, 1>)
                       : (p.cluster ? launch_wgmma<TO, false, true, 2>
                                    : launch_wgmma<TO, false, true, 1>);
  return run(qk0, qk1, v0, v1, lens, o0, o1, B, N0, N1, H, scale, quant, p, s);
}

}  // namespace

// qk0/v0: rows of N0, qk1/v1: rows of N1; head h of a row at columns
// [h*64, h*64 + 64), addressed by (batch, row) strides in elements, read by
// TMA (16 B bases and strides, else cudaErrorInvalidValue). lens: (B, 2)
// int32 [n0, n1] or null (unmasked). o0: (B, N0, H*64) and o1: (B, N1,
// H*64), contiguous, in the mode's output type. mode: FP32 (fp32 operands
// and out, bidir_tf32_wgmma_kernel), BF16 (bf16 operands and out) or
// BF16_F32_OUT (bf16 operands, fp32 out; both bidir_wgmma_kernel); quant:
// bf16 stats. One launch at lg_bidir_plan's form.
extern "C" int lg_bidirectional_cross(
    const void* qk0, long long qk0_bs, long long qk0_rs, const void* qk1,
    long long qk1_bs, long long qk1_rs, const void* v0, long long v0_bs,
    long long v0_rs, const void* v1, long long v1_bs, long long v1_rs,
    const void* lens, void* o0, void* o1, int B, int N0, int N1, int H,
    float scale, int quant, int mode, void* stream) {
  const Operand a{qk0, qk0_bs, D, qk0_rs}, c{qk1, qk1_bs, D, qk1_rs}, w0{v0, v0_bs, D, v0_rs},
      w1{v1, v1_bs, D, v1_rs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode != FP32 && mode != BF16 && mode != BF16_F32_OUT)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = bidir_plan(B, H, N0, N1, mode, quant);
  if (mode == FP32)
    return (quant ? (p.cluster ? launch_tf32<2, 1> : launch_tf32<1, 1>)
                  : (p.cluster ? launch_tf32<2, 0> : launch_tf32<1, 0>))(
        a, c, w0, w1, lens, o0, o1, B, N0, N1, H, scale, p, s);
  return (mode == BF16 ? launch_bf16<bf16_t> : launch_bf16<float>)(a, c, w0, w1, lens, o0, o1, B,
                                                                   N0, N1, H, scale, quant, p, s);
}

// lg_bidirectional_cross's launch at this shape, mode and stats: out =
// {kernel (0: bidir_wgmma_kernel, 1: bidir_tf32_wgmma_kernel), consumers
// splitting a row's chunks, a cluster of two blocks a tile (else one
// block), pass 1's s kept, blocks of the launch, dynamic shared memory in
// bytes} (kernels/attention.py:bidir_plan is held against it).
extern "C" int lg_bidir_plan(int B, int H, int N0, int N1, int mode, int quant, int* out) {
  const Plan p = bidir_plan(B, H, N0, N1, mode, quant);
  out[0] = p.f32;
  out[1] = p.split;
  out[2] = p.cluster;
  out[3] = p.store;
  out[4] = (p.cluster ? 2 : 1) * p.tiles * H * B;
  out[5] = static_cast<int>(p.smem);
  return 0;
}
