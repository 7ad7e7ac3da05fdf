// SuperPoint's conv2 pair in one launch: conv2a (+bias, ReLU, rounded to the
// input type) -> conv2b (+bias [+ReLU]) -> 2x2 max-pool, NHWC, 64 channels.
//
// Replaces the TPU kernel lightglue_tpu/kernels/conv_chain.py:conv2_chain
// (wrapper :140, pallas_call :180, body _chain_kernel :51-134), which keeps
// the conv2a strip in VMEM and feeds conv2b from it. Its contract: conv2a's
// output is relu(conv + ba), set to 0 outside the image (conv2b's SAME
// padding, :105-110; relu(ba) is not 0), then rounded to x's type; conv2b
// accumulates it in fp32 against wb, adds bb, applies ReLU when asked, and
// the 2x2 pool follows; the result is cast once to the output type. The
// paired/offset column packings are the MXU's and are not kept.
//
// Bound on the H100: at 2x240x320 the pair is ~23 GFLOP against ~20 MB of
// input and output, so the tensor cores bound it (~0.023 ms at the bf16
// peak, ~0.137 ms at three TF32 products per fp32 product); the
// intermediate never needs to reach device memory (its round trip through
// it would be ~39 MB, ~0.012 ms).
//
// Both kernels work on 16x16 conv2b output tiles (8x8 pooled), so conv2a
// runs over the 18x18 tile that conv2b reads (27 % of conv2a recomputed in
// the halo: 324 of 256 pixels) from a 20x20 input tile; 8 warps, warp w
// computing conv2b's output rows 2w and 2w + 1 and conv2a's m16 tiles w,
// w + 8 and w + 16 (21 of 16 pixels each over the 18x18 tile in row-major
// order; a fragment row is a pixel, so a fragment may span two tile rows;
// rows past the tile are computed and never stored).
//
// chain_mma_kernel, the bf16-operand calls, on the tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 sums, with conv3x3.cu's model-conv fragments):
// - Persistent blocks (one per SM) keep both layers' nine taps of weights
//   resident, 2 x 82,944 B at mma.cuh's LD pitch, copied once per block.
// - The rest of the 227 KB, 57,600 B, is ONE activation buffer: a tile's
//   20x20 input lands there by cp.async; conv2a's A fragments come from it
//   by ldmatrix (each lane's row address its own pixel); after a barrier
//   its epilogue writes relu(acc + ba), zero outside the image, rounded to
//   bf16, over the input it no longer needs; conv2b reads that bf16 tile
//   by ldmatrix straight from shared memory, as the model conv reads its
//   input tile, and its epilogue adds bb in fp32, applies ReLU when asked,
//   takes the pool max (a window's rows in one thread, its columns in
//   lanes 4 apart) and casts once, storing 2 values a lane.
// - Why one buffer: the weights and separate input and conv2a tiles fit
//   only at a 16x8 output tile (12x20 input, 10x18 conv2a: 226,368 B, no
//   room to prefetch), which recomputes 41 % of conv2a in the halo; reusing
//   the input's buffer fits a 16x16 tile. The price: the next tile's input
//   can only be copied once conv2b has read the buffer, behind that tile's
//   epilogue, so most of each tile's 51 KB load is exposed.
//
// chain_tf32x3_kernel, the fp32-operand calls, on the tensor cores in
// 3xTF32 (one TF32 product per MAC would miss the fp32 gate of 1e-4;
// hi*lo + lo*hi + hi*hi on mma.sync m16n8k8, conv3x3.cu's generic fp32
// design): one block per 16x16 output tile.
// - fp32 doubles every byte: both layers' weights (2 x 147 KB) cannot stay,
//   so K streams in 16 chunks of 8 input channels, conv2a's eight (the
//   20x20 input tile's 8 channels at a 12-float pitch and their nine taps
//   of wa) then conv2b's eight (wb's taps only), through a two-stage
//   cp.async ring of raw fp32: chunk c + 1 copies while chunk c computes,
//   wb's first chunk behind conv2a's last. Each chunk's weights are split
//   once, for all warps, into (hi, lo) pairs at a 68-pair pitch; the
//   activations are split by truncation (mma.cuh:split_tf32_rz) as each A
//   fragment loads.
// - What stays on chip is conv2a's 18x18 tile in fp32 at a 68-float pitch
//   (88,128 B; a fragment's 8 pixels x 4 channels fall in 32 banks): its
//   epilogue writes relu(acc + ba), 0 outside the image, after conv2a's
//   last chunk; conv2b's A fragments load from it past the barrier of
//   wb's first chunk. conv2a's 96 accumulators a thread die before conv2b's
//   64 are set.
// - 202,560 B of shared memory: one block an SM (two would need 113 KB
//   each: the conv2a tile alone at a 12x16 output tile is 68,544 B, and the
//   ring and the split weights 114,432 B more), so registers are not held
//   to 128. kernels/conv_chain.py:chain_plan mirrors the launch
//   (lg_chain_plan).
// - Epilogue in registers: fp32 acc + fp32 bb, ReLU when asked, the pool
//   max across the thread's two rows and the lane 4 apart, one cast, 2-value
//   stores masked per pixel (any even H and W: 180x244 runs 16 of 12
//   tiles with the edges masked).

#include "mma.cuh"

namespace {

using lg::bf16_t;
using lg::LD;                     // bf16 pixel pitch in shared memory (144 B)
constexpr int C = 64;             // channels in, between and out
constexpr int OT = 16;            // conv2b output tile side (pre-pool)
constexpr int AT = OT + 2;        // conv2a tile side: conv2b's halo
constexpr int XT = OT + 4;        // input tile side: conv2a's halo
constexpr int A_PIX = AT * AT;    // conv2a pixels per tile (324)
constexpr int MWARPS = OT / 2;    // warps of a block: two conv2b rows each
constexpr int THREADS = MWARPS * 32;
constexpr int A_MT = (A_PIX + 15) / 16;                  // conv2a m16 tiles (21)
constexpr int A_MT_WARP = (A_MT + MWARPS - 1) / MWARPS;  // per warp, at most (3)

// ---------------------------------------------------------------------------
// The bf16 chain on the tensor cores
// ---------------------------------------------------------------------------

constexpr size_t MMA_SMEM = sizeof(bf16_t) * (2 * 9 * C + XT * XT) * LD;  // 223,488 B

template <typename O>
__global__ void __launch_bounds__(MWARPS * 32, 1)
chain_mma_kernel(const bf16_t* __restrict__ x, const bf16_t* __restrict__ wa,
                 const float* __restrict__ ba, const bf16_t* __restrict__ wb,
                 const float* __restrict__ bb, O* __restrict__ y, int H, int W, int tiles_x,
                 int tiles_y, int tiles, int relu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* wsa = reinterpret_cast<bf16_t*>(smem_raw);  // [tap * 64 + ci][LD]: conv2a's weights
  bf16_t* wsb = wsa + 9 * C * LD;                     // conv2b's
  bf16_t* buf = wsb + 9 * C * LD;  // [XT * XT][LD]: the input tile, then conv2a's [A_PIX][LD]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;   // mma fragment row and column pair
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix matrix and row of this lane
  const int per_image = tiles_x * tiles_y;

  // both layers' nine taps, once per block (in the first tile's copy group)
  for (int s = tid; s < 2 * 9 * C * (C / 8); s += blockDim.x) {
    const int r = s / (C / 8), c = s % (C / 8) * 8;  // rows of wa, then of wb
    const bf16_t* src = r < 9 * C ? wa + (size_t)r * C : wb + (size_t)(r - 9 * C) * C;
    lg::cp_async16(wsa + r * LD + c, src + c);
  }
  float bva[C / 8][2], bvb[C / 8][2];  // channels n * 8 + 2 * t4 + {0, 1}
#pragma unroll
  for (int n = 0; n < C / 8; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      bva[n][j] = __ldg(ba + n * 8 + 2 * t4 + j);
      bvb[n][j] = __ldg(bb + n * 8 + 2 * t4 + j);
    }
  // conv2a's m16 tiles of this warp: warp + MWARPS * j, of A_MT over the
  // 18x18 tile in row-major order; this lane's ldmatrix row is pixel q of
  // the tile (clamped into it: rows past A_PIX are computed, never stored),
  // at input-tile pixel a_in[j] for tap (0, 0)
  const bool third = warp + MWARPS * 2 < A_MT;  // the same for the whole warp
  int a_in[A_MT_WARP];
#pragma unroll
  for (int j = 0; j < A_MT_WARP; ++j) {
    const int q = min(16 * (warp + MWARPS * j) + mr + (mi & 1) * 8, A_PIX - 1);
    a_in[j] = q / AT * XT + q % AT;
  }

  // the input tile of output tile t: image rows y0 - 2.., cols x0 - 2..;
  // zeros outside (conv2a's SAME padding)
  auto stage = [&](int t) {
    const int b = t / per_image, y0 = t % per_image / tiles_x * OT, x0 = t % tiles_x * OT;
    for (int s = tid; s < XT * XT * (C / 8); s += blockDim.x) {
      const int p = s / (C / 8), c = s % (C / 8) * 8;
      const int gy = y0 - 2 + p / XT, gx = x0 - 2 + p % XT;
      bf16_t* d = buf + p * LD + c;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        lg::cp_async16(d, x + (((size_t)b * H + gy) * W + gx) * C + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  };

  stage(blockIdx.x);  // gridDim.x <= tiles
  lg::cp_async_commit();
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b = t / per_image, ty = t % per_image / tiles_x, tx = t % tiles_x;
    const int y0 = ty * OT, x0 = tx * OT;
    lg::cp_async_wait<0>();  // the tile (and, the first time, the weights) landed
    __syncthreads();

    // ---- conv2a: acc[j][n], tile j's 16 pixels x channels n * 8.. --------
    float acc[A_MT_WARP][C / 8][4];
#pragma unroll
    for (int j = 0; j < A_MT_WARP; ++j)
#pragma unroll
      for (int n = 0; n < C / 8; ++n) acc[j][n][0] = acc[j][n][1] = acc[j][n][2] = acc[j][n][3] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = tap / 3 * XT + tap % 3;
#pragma unroll
      for (int k16 = 0; k16 < C / 16; ++k16) {
        unsigned a[A_MT_WARP][4];
#pragma unroll
        for (int j = 0; j < A_MT_WARP; ++j)
          if (j < 2 || third)
            lg::ldsm_x4(a[j], buf + (a_in[j] + shift) * LD + k16 * 16 + (mi >> 1) * 8);
        const bf16_t* wk = wsa + (tap * C + k16 * 16 + mr + (mi & 1) * 8) * LD + (mi >> 1) * 8;
#pragma unroll
        for (int np = 0; np < C / 16; ++np) {
          unsigned r[4];
          lg::ldsm_x4_trans(r, wk + np * 16);
#pragma unroll
          for (int j = 0; j < A_MT_WARP; ++j)
            if (j < 2 || third) {
              lg::mma_bf16(acc[j][2 * np], a[j], r[0], r[1]);
              lg::mma_bf16(acc[j][2 * np + 1], a[j], r[2], r[3]);
            }
        }
      }
    }
    __syncthreads();  // every warp is done with the input: buf becomes conv2a's tile

    // relu(acc + ba), 0 outside the image (conv2b's SAME padding), rounded
    // to bf16 at tile pixel p, row p of buf
#pragma unroll
    for (int j = 0; j < A_MT_WARP; ++j) {
      if (j == 2 && !third) break;
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // fragment rows g and g + 8
        const int p = 16 * (warp + MWARPS * j) + g + 8 * i;
        if (p >= A_PIX) continue;
        const int gy = y0 - 1 + p / AT, gx = x0 - 1 + p % AT;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int n = 0; n < C / 8; ++n)
          lg::store2(buf + p * LD + n * 8 + 2 * t4,
                     inside ? fmaxf(acc[j][n][2 * i] + bva[n][0], 0.f) : 0.f,
                     inside ? fmaxf(acc[j][n][2 * i + 1] + bva[n][1], 0.f) : 0.f);
      }
    }
    __syncthreads();

    // ---- conv2b: acc2[m][n], output row 2 * warp + m -----------------------
    float acc2[2][C / 8][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < C / 8; ++n) acc2[m][n][0] = acc2[m][n][1] = acc2[m][n][2] = acc2[m][n][3] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int k16 = 0; k16 < C / 16; ++k16) {
        unsigned a[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)  // 16 conv2a pixels of a row, shifted by the tap
          lg::ldsm_x4(a[m], buf + ((2 * warp + m + dy) * AT + mr + (mi & 1) * 8 + dx) * LD +
                                k16 * 16 + (mi >> 1) * 8);
        const bf16_t* wk = wsb + (tap * C + k16 * 16 + mr + (mi & 1) * 8) * LD + (mi >> 1) * 8;
#pragma unroll
        for (int np = 0; np < C / 16; ++np) {
          unsigned r[4];
          lg::ldsm_x4_trans(r, wk + np * 16);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            lg::mma_bf16(acc2[m][2 * np], a[m], r[0], r[1]);
            lg::mma_bf16(acc2[m][2 * np + 1], a[m], r[2], r[3]);
          }
        }
      }
    }

    __syncthreads();  // every warp is done with buf: the next tile's input copies
    if (t + gridDim.x < tiles) stage(t + gridDim.x);  // behind this tile's epilogue
    lg::cp_async_commit();

    // fp32 bb, [ReLU,] the pool max, one cast; 2 values a lane, masked at the edge
    const int Ho = H / 2, Wo = W / 2, oy = y0 / 2 + warp;
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float top = acc2[0][n][2 * i + k] + bvb[n][k];
          float bot = acc2[1][n][2 * i + k] + bvb[n][k];
          if (relu) top = fmaxf(top, 0.f), bot = fmaxf(bot, 0.f);
          v[k] = fmaxf(top, bot);
          v[k] = fmaxf(v[k], __shfl_xor_sync(0xffffffffu, v[k], 4));  // the column pair
        }
        const int ox = x0 / 2 + (g + 8 * i) / 2;
        if (!(g & 1) && oy < Ho && ox < Wo)
          lg::store2(y + (((size_t)b * Ho + oy) * Wo + ox) * C + n * 8 + 2 * t4, v[0], v[1]);
      }
  }
}

template <typename O>
int launch_mma(const void* x, const void* wa, const void* ba, const void* wb, const void* bb,
               void* y, int B, int H, int W, int relu, cudaStream_t stream) {
  // x and the weights are read 16 B at a time
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wa) % 16 ||
      reinterpret_cast<uintptr_t>(wb) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  static int resident = 0;  // blocks the card runs at once, found once per instantiation
  if (!resident) {
    cudaError_t err = cudaFuncSetAttribute(chain_mma_kernel<O>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(MMA_SMEM));
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_mma_kernel<O>,
                                                          MWARPS * 32, MMA_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * max(per_sm, 1);
  }
  const int tiles_x = (W + OT - 1) / OT, tiles_y = (H + OT - 1) / OT;
  const int tiles = B * tiles_x * tiles_y;
  chain_mma_kernel<O><<<min(tiles, resident), MWARPS * 32, MMA_SMEM, stream>>>(
      static_cast<const bf16_t*>(x), static_cast<const bf16_t*>(wa),
      static_cast<const float*>(ba), static_cast<const bf16_t*>(wb),
      static_cast<const float*>(bb), static_cast<O*>(y), H, W, tiles_x, tiles_y, tiles, relu);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The fp32 chain on the tensor cores: 3xTF32
// ---------------------------------------------------------------------------

constexpr int FK = 8;              // input channels per K chunk: one k8 step per tap
constexpr int FCHUNKS = C / FK;    // K chunks of one layer (8)
constexpr int FPA = FK + 4;        // fp32 pixel pitch of a chunk's input tile (48 B): the
                                   // eight pixels of an A fragment column fall in different banks
constexpr int FPN = C + 4;         // (hi, lo) pair pitch of the split weights (68 pairs): a
                                   // half-warp's B pairs fall in different bank pairs
constexpr int FPT = C + 4;         // fp32 pixel pitch of conv2a's tile (68 floats): a
                                   // fragment's 8 pixels x 4 channels fall in 32 banks
constexpr int FSTAGE = XT * XT * FPA + 9 * FK * C;  // floats of a raw ring stage
constexpr size_t TF32_SMEM = sizeof(float) * (A_PIX * FPT + 2 * FSTAGE) +
                             sizeof(float2) * 9 * FK * FPN;  // 202,560 B

// One block an SM (202,560 B of shared memory): registers are not held to 128
template <typename O>
__global__ void __launch_bounds__(THREADS, 1)
chain_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ wa,
                    const float* __restrict__ ba, const float* __restrict__ wb,
                    const float* __restrict__ bb, O* __restrict__ y, int H, int W, int relu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* mid = reinterpret_cast<float*>(smem_raw);  // [A_PIX][FPT]: conv2a's tile
  // [2] x {[XT * XT][FPA] input chunk, [9 * FK][C] its taps' weights}, as copied
  float* raw = mid + A_PIX * FPT;
  // [9 * FK][FPN] (hi, lo) of the chunk's weights, split once for all warps
  float2* ws = reinterpret_cast<float2*>(raw + 2 * FSTAGE);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;  // mma fragment row and column
  const int x0 = blockIdx.x * OT, y0 = blockIdx.y * OT, b = blockIdx.z;

  // chunk c's raw stage. c < FCHUNKS: conv2a's input channels c * FK.. of
  // the 20x20 input tile (image rows y0 - 2.., cols x0 - 2..; zeros outside,
  // conv2a's SAME padding) and their nine taps of wa; c >= FCHUNKS: conv2b's
  // input channels (c - FCHUNKS) * FK.. of wb (its input is conv2a's tile)
  auto stage = [&](int c) {
    float* xs = raw + c % 2 * FSTAGE;
    float* wr = xs + XT * XT * FPA;
    const bool first = c < FCHUNKS;
    const int c0 = (first ? c : c - FCHUNKS) * FK;
    if (first)
      for (int s = tid; s < XT * XT * (FK / 4); s += THREADS) {
        const int p = s / (FK / 4), k4 = s % (FK / 4) * 4;
        const int gy = y0 - 2 + p / XT, gx = x0 - 2 + p % XT;
        float* d = xs + p * FPA + k4;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W)
          lg::cp_async16(d, x + (((size_t)b * H + gy) * W + gx) * C + c0 + k4);
        else
          *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    const float* w = first ? wa : wb;
    for (int s = tid; s < 9 * FK * (C / 4); s += THREADS) {
      const int r = s / (C / 4), n4 = s % (C / 4) * 4;  // r = tap * FK + channel in chunk
      lg::cp_async16(wr + r * C + n4, w + ((size_t)(r / FK) * C + c0 + r % FK) * C + n4);
    }
  };
  // chunk c lands (every thread's copies, past the barrier), c + 1 starts
  // copying, and c's weights are split into ws for all warps; the barrier
  // at the top also means every warp is done with chunk c - 1 (its stage
  // and ws)
  auto next_chunk = [&](int c) -> const float* {
    lg::cp_async_wait<0>();
    __syncthreads();
    if (c + 1 < 2 * FCHUNKS) stage(c + 1);
    lg::cp_async_commit();
    const float* xs = raw + c % 2 * FSTAGE;
    const float4* wr = reinterpret_cast<const float4*>(xs + XT * XT * FPA);
    for (int s = tid; s < 9 * FK * (C / 4); s += THREADS) {
      const float4 v = wr[s];
      unsigned h[4], l[4];
      lg::split_tf32_rz(v.x, h[0], l[0]);
      lg::split_tf32_rz(v.y, h[1], l[1]);
      lg::split_tf32_rz(v.z, h[2], l[2]);
      lg::split_tf32_rz(v.w, h[3], l[3]);
      uint4* d = reinterpret_cast<uint4*>(ws + s / (C / 4) * FPN + s % (C / 4) * 4);
      d[0] = make_uint4(h[0], l[0], h[1], l[1]);
      d[1] = make_uint4(h[2], l[2], h[3], l[3]);
    }
    __syncthreads();
    return xs;
  };

  // ---- conv2a: acc[j][n], m16 tile warp + MWARPS * j, channels n * 8.. ----
  // fragment rows g and g + 8 of tile j are tile pixels q (clamped into the
  // tile: rows past A_PIX are computed, never stored), at input-tile pixel
  // a_in[j][i] for tap (0, 0)
  const bool third = warp + MWARPS * 2 < A_MT;  // the same for the whole warp
  int a_in[A_MT_WARP][2];
#pragma unroll
  for (int j = 0; j < A_MT_WARP; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = min(16 * (warp + MWARPS * j) + g + 8 * i, A_PIX - 1);
      a_in[j][i] = q / AT * XT + q % AT;
    }
  float acc[A_MT_WARP][C / 8][4];
#pragma unroll
  for (int j = 0; j < A_MT_WARP; ++j)
#pragma unroll
    for (int n = 0; n < C / 8; ++n) acc[j][n][0] = acc[j][n][1] = acc[j][n][2] = acc[j][n][3] = 0.f;

  stage(0);
  lg::cp_async_commit();
#pragma unroll 1
  for (int c = 0; c < FCHUNKS; ++c) {
    const float* xs = next_chunk(c);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = tap / 3 * XT + tap % 3;
      unsigned ah[A_MT_WARP][4], al[A_MT_WARP][4];
#pragma unroll
      for (int j = 0; j < A_MT_WARP; ++j) {
        if (j == 2 && !third) break;
        const float* p0 = xs + (a_in[j][0] + shift) * FPA + t4;  // pixel of row g, k t4
        const float* p1 = xs + (a_in[j][1] + shift) * FPA + t4;  // row g + 8
        lg::split_tf32_rz(p0[0], ah[j][0], al[j][0]);
        lg::split_tf32_rz(p1[0], ah[j][1], al[j][1]);
        lg::split_tf32_rz(p0[4], ah[j][2], al[j][2]);            // k t4 + 4
        lg::split_tf32_rz(p1[4], ah[j][3], al[j][3]);
      }
      const float2* wk = ws + (tap * FK + t4) * FPN + g;  // k t4, column g
#pragma unroll
      for (int n = 0; n < C / 8; ++n) {
        const float2 w0 = wk[n * 8], w1 = wk[4 * FPN + n * 8];  // k t4 and t4 + 4
        const unsigned bh0 = __float_as_uint(w0.x), bl0 = __float_as_uint(w0.y);
        const unsigned bh1 = __float_as_uint(w1.x), bl1 = __float_as_uint(w1.y);
#pragma unroll
        for (int j = 0; j < A_MT_WARP; ++j) {
          if (j == 2 && !third) break;
          lg::mma_3xtf32(acc[j][n], ah[j], al[j], bh0, bl0, bh1, bl1);
        }
      }
    }
  }

  // relu(acc + ba), 0 outside the image (conv2b's SAME padding), at tile
  // pixel p, row p of mid; conv2b reads it past next_chunk's first barrier
  {
    float bva[C / 8][2];  // channels n * 8 + 2 * t4 + {0, 1}
#pragma unroll
    for (int n = 0; n < C / 8; ++n) {
      bva[n][0] = __ldg(ba + n * 8 + 2 * t4);
      bva[n][1] = __ldg(ba + n * 8 + 2 * t4 + 1);
    }
#pragma unroll
    for (int j = 0; j < A_MT_WARP; ++j) {
      if (j == 2 && !third) break;
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // fragment rows g and g + 8
        const int p = 16 * (warp + MWARPS * j) + g + 8 * i;
        if (p >= A_PIX) continue;
        const int gy = y0 - 1 + p / AT, gx = x0 - 1 + p % AT;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int n = 0; n < C / 8; ++n)
          lg::store2(mid + p * FPT + n * 8 + 2 * t4,
                     inside ? fmaxf(acc[j][n][2 * i] + bva[n][0], 0.f) : 0.f,
                     inside ? fmaxf(acc[j][n][2 * i + 1] + bva[n][1], 0.f) : 0.f);
      }
    }
  }

  // ---- conv2b: acc2[m][n], output row 2 * warp + m, channels n * 8.. -----
  float acc2[2][C / 8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < C / 8; ++n) acc2[m][n][0] = acc2[m][n][1] = acc2[m][n][2] = acc2[m][n][3] = 0.f;
#pragma unroll 1
  for (int c = FCHUNKS; c < 2 * FCHUNKS; ++c) {
    next_chunk(c);
    const float* a = mid + (c - FCHUNKS) * FK + t4;  // conv2a's channels of this chunk, k t4
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {  // 16 conv2a pixels of a row, shifted by the tap
        const float* px = a + ((2 * warp + m + dy) * AT + dx + g) * FPT;
        lg::split_tf32_rz(px[0], ah[m][0], al[m][0]);            // pixel g, k t4
        lg::split_tf32_rz(px[8 * FPT], ah[m][1], al[m][1]);      // pixel g + 8
        lg::split_tf32_rz(px[4], ah[m][2], al[m][2]);            // k t4 + 4
        lg::split_tf32_rz(px[8 * FPT + 4], ah[m][3], al[m][3]);
      }
      const float2* wk = ws + (tap * FK + t4) * FPN + g;  // k t4, column g
#pragma unroll
      for (int n = 0; n < C / 8; ++n) {
        const float2 w0 = wk[n * 8], w1 = wk[4 * FPN + n * 8];
        const unsigned bh0 = __float_as_uint(w0.x), bl0 = __float_as_uint(w0.y);
        const unsigned bh1 = __float_as_uint(w1.x), bl1 = __float_as_uint(w1.y);
#pragma unroll
        for (int m = 0; m < 2; ++m) lg::mma_3xtf32(acc2[m][n], ah[m], al[m], bh0, bl0, bh1, bl1);
      }
    }
  }

  // fp32 bb, [ReLU,] the pool max, one cast; 2 values a lane, masked at the edge
  const int Ho = H / 2, Wo = W / 2, oy = y0 / 2 + warp;
#pragma unroll
  for (int n = 0; n < C / 8; ++n) {
    const float bv0 = __ldg(bb + n * 8 + 2 * t4), bv1 = __ldg(bb + n * 8 + 2 * t4 + 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // fragment rows g and g + 8
      float v[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float top = acc2[0][n][2 * i + k] + (k ? bv1 : bv0);
        float bot = acc2[1][n][2 * i + k] + (k ? bv1 : bv0);
        if (relu) top = fmaxf(top, 0.f), bot = fmaxf(bot, 0.f);
        v[k] = fmaxf(top, bot);
        v[k] = fmaxf(v[k], __shfl_xor_sync(0xffffffffu, v[k], 4));  // the column pair
      }
      const int ox = x0 / 2 + (g + 8 * i) / 2;
      if (!(g & 1) && oy < Ho && ox < Wo)
        lg::store2(y + (((size_t)b * Ho + oy) * Wo + ox) * C + n * 8 + 2 * t4, v[0], v[1]);
    }
  }
}

template <typename O>
int launch_tf32x3(const void* x, const void* wa, const void* ba, const void* wb, const void* bb,
                  void* y, int B, int H, int W, int relu, cudaStream_t stream) {
  // x and the weights are read 16 B at a time
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wa) % 16 ||
      reinterpret_cast<uintptr_t>(wb) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  // above 48 KB: opt in once per instantiation
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      chain_tf32x3_kernel<O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(TF32_SMEM));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  dim3 grid((W + OT - 1) / OT, (H + OT - 1) / OT, B);
  chain_tf32x3_kernel<O><<<grid, THREADS, TF32_SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wa), static_cast<const float*>(ba),
      static_cast<const float*>(wb), static_cast<const float*>(bb), static_cast<O*>(y), H, W,
      relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, H, W, 64) input type, H and W even; wa/wb: (3, 3, 64, 64) HWIO
// input type; ba/bb: (64,) fp32. y: (B, H/2, W/2, 64) in the output type
// (bf16 when bf16_out, else fp32).
extern "C" int lg_conv2_chain(const void* x, const void* wa, const void* ba,
                              const void* wb, const void* bb, void* y, int B,
                              int H, int W, int relu, int bf16, int bf16_out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (bf16_out ? launch_mma<bf16_t> : launch_mma<float>)(x, wa, ba, wb, bb, y, B, H, W,
                                                               relu, s);
  return (bf16_out ? launch_tf32x3<bf16_t> : launch_tf32x3<float>)(x, wa, ba, wb, bb, y, B, H,
                                                                   W, relu, s);
}

// A launch at (B, H, W) with bf16 (chain_mma_kernel) or fp32
// (chain_tf32x3_kernel) operands: out = {output tile side, threads, tiles,
// dynamic shared memory in bytes}. The bf16 kernel's blocks are persistent:
// it launches min(tiles, the blocks the card holds at once) of them.
extern "C" int lg_chain_plan(int B, int H, int W, int fp32, int* out) {
  out[0] = OT;
  out[1] = THREADS;
  out[2] = B * ((H + OT - 1) / OT) * ((W + OT - 1) / OT);
  out[3] = static_cast<int>(fp32 ? TF32_SMEM : MMA_SMEM);
  return 0;
}
