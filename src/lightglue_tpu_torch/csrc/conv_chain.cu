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
// peak); the intermediate never needs to reach device memory (its round
// trip through it would be ~39 MB, ~0.012 ms).
//
// chain_mma_kernel, the bf16-operand calls, on the tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 sums, with conv3x3.cu's model-conv fragments):
// - Persistent blocks (one per SM) keep both layers' nine taps of weights
//   resident, 2 x 82,944 B at mma.cuh's LD pitch, copied once per block.
// - The rest of the 227 KB, 57,600 B, is ONE activation buffer: a tile's
//   20x20 input (conv2a's halo of conv2b's halo) lands there by cp.async;
//   conv2a runs over the 18x18 pixels conv2b reads, as 21 m16 tiles of 16
//   pixels in row-major order (warp w takes tiles w, w + 8, w + 16; each
//   lane's ldmatrix row addresses its own pixel, so a fragment may span two
//   tile rows); after a barrier its epilogue writes relu(acc + ba), zero
//   outside the image, rounded to bf16, over the input it no longer needs;
//   conv2b reads that bf16 tile by ldmatrix straight from shared memory, as
//   the model conv reads its input tile (warp w: output rows 2w, 2w + 1),
//   and its epilogue adds bb in fp32, applies ReLU when asked, takes the
//   pool max (a window's rows in one thread, its columns in lanes 4 apart)
//   and casts once, storing 2 values a lane.
// - Why one buffer: the weights and separate input and conv2a tiles fit
//   only at a 16x8 output tile (12x20 input, 10x18 conv2a: 226,368 B, no
//   room to prefetch), which recomputes 41 % of conv2a in the halo; reusing
//   the input's buffer fits a 16x16 tile, 27 % recomputed (324 of 256
//   pixels). The price: the next tile's input can only be copied once
//   conv2b has read the buffer, behind that tile's epilogue, so most of
//   each tile's 51 KB load is exposed. Streaming wb tap by tap behind
//   conv2a would free room for a full prefetch but read 74 KB of weights
//   per tile from L2 instead of once per block.
//
// chain_kernel, the fp32-operand calls, on the fp32 FMA units (one TF32 mma
// would miss their 1e-4 gate): one block per 8x16 conv2b output tile (4x8
// pooled). It first computes conv2a over the 10x18 tile that conv2b reads
// (the tile plus its halo), from a 12x20 input tile staged 16 channels at a
// time with the taps' weights, and keeps the result, zeroed outside the
// image, in shared memory (46 KB). Then conv2b runs over that tile with
// conv3x3.cu's thread layout (2x4 pixels x 4 channels per thread) and the
// bias/ReLU/pool epilogue in registers. Adjacent tiles recompute their
// shared conv2a halo (180 of 128 pixels, +41 % of conv2a's work).

#include "mma.cuh"

namespace {

constexpr int C = 64;                 // channels in, between and out
constexpr int TH = 8, TW = 16;        // conv2b output tile (pre-pool)
constexpr int AH = TH + 2, AW = TW + 2;  // conv2a tile: conv2b's halo
constexpr int XH = AH + 2, XW = AW + 2;  // input tile: conv2a's halo
constexpr int CI = 16;                // input channels staged per step
constexpr int APX = AH * AW;          // conv2a pixels per block (180)
constexpr int APT = (APX + 15) / 16;  // per pixel group (16 groups)
constexpr int THREADS = 256;
constexpr size_t SMEM = sizeof(float) * (XH * XW * CI + 9 * CI * C + APX * C);

__device__ void stage_weights(float* ws, const float* w, int c0) {
  for (int i = threadIdx.x; i < 9 * CI * C; i += THREADS) {
    const int co = i % C;
    const int ci = (i / C) % CI;
    const int tap = i / (C * CI);
    ws[i] = w[((size_t)tap * C + c0 + ci) * C + co];
  }
}

template <typename O, bool RELU>
__global__ void __launch_bounds__(THREADS)
chain_kernel(const float* __restrict__ x, const float* __restrict__ wa,
             const float* __restrict__ ba, const float* __restrict__ wb,
             const float* __restrict__ bb, O* __restrict__ y, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [XH * XW][CI] input tile
  float* ws = xs + XH * XW * CI;    // [tap][CI][C] weights (16-byte aligned)
  float* as = ws + 9 * CI * C;      // [APX][C] conv2a tile

  const int tid = threadIdx.x;
  const int cg = tid % 16;  // channels 4cg .. 4cg+3
  const int pg = tid / 16;  // pixel group
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const float* xb = x + (size_t)b * H * W * C;

  // ---- conv2a over the AH x AW tile: image rows y0-1.., cols x0-1.. ------
  int off[APT];  // each owned pixel's top-left tap in xs, in pixels
#pragma unroll
  for (int i = 0; i < APT; ++i) {
    const int p = min(pg + 16 * i, APX - 1);
    off[i] = (p / AW) * XW + p % AW;
  }
  float acc[APT][4];
#pragma unroll
  for (int i = 0; i < APT; ++i)
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[i][o] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CI) {
    __syncthreads();  // the previous chunk is no longer read
    for (int i = tid; i < XH * XW * CI; i += THREADS) {
      const int ci = i % CI;
      const int pix = i / CI;
      const int gy = y0 - 2 + pix / XW;
      const int gx = x0 - 2 + pix % XW;
      float v = 0.f;  // conv2a's SAME zero padding
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = xb[((size_t)gy * W + gx) * C + c0 + ci];
      xs[i] = v;
    }
    stage_weights(ws, wa, c0);
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int tap_off = (tap / 3) * XW + tap % 3;
#pragma unroll 2
      for (int ci = 0; ci < CI; ++ci) {
        const float4 wv =
            *reinterpret_cast<const float4*>(&ws[(tap * CI + ci) * C + 4 * cg]);
#pragma unroll
        for (int i = 0; i < APT; ++i) {
          const float xv = xs[(off[i] + tap_off) * CI + ci];
          acc[i][0] = fmaf(xv, wv.x, acc[i][0]);
          acc[i][1] = fmaf(xv, wv.y, acc[i][1]);
          acc[i][2] = fmaf(xv, wv.z, acc[i][2]);
          acc[i][3] = fmaf(xv, wv.w, acc[i][3]);
        }
      }
    }
  }
  // bias, ReLU, 0 outside the image (conv2b's padding)
#pragma unroll
  for (int i = 0; i < APT; ++i) {
    const int p = pg + 16 * i;
    if (p >= APX) continue;
    const int gy = y0 - 1 + p / AW;
    const int gx = x0 - 1 + p % AW;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const float v = fmaxf(acc[i][o] + ba[4 * cg + o], 0.f);
      as[p * C + 4 * cg + o] = inside ? v : 0.f;
    }
  }

  // ---- conv2b over the conv2a tile, then bias [+ReLU] and the pool -------
  const int pr = 2 * (pg / 4);  // the group's 2 rows x 4 cols of the tile
  const int pc = 4 * (pg % 4);
  float acc2[2][4][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int o = 0; o < 4; ++o) acc2[r][c][o] = 0.f;
  for (int c0 = 0; c0 < C; c0 += CI) {
    __syncthreads();  // conv2a's tile is written; the previous weights are read
    stage_weights(ws, wb, c0);
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
#pragma unroll 4
      for (int ci = 0; ci < CI; ++ci) {
        const float4 wv =
            *reinterpret_cast<const float4*>(&ws[(tap * CI + ci) * C + 4 * cg]);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float av = as[((pr + r + dy) * AW + pc + c + dx) * C + c0 + ci];
            acc2[r][c][0] = fmaf(av, wv.x, acc2[r][c][0]);
            acc2[r][c][1] = fmaf(av, wv.y, acc2[r][c][1]);
            acc2[r][c][2] = fmaf(av, wv.z, acc2[r][c][2]);
            acc2[r][c][3] = fmaf(av, wv.w, acc2[r][c][3]);
          }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const float v = acc2[r][c][o] + bb[4 * cg + o];
        acc2[r][c][o] = RELU ? fmaxf(v, 0.f) : v;
      }
  // the group's 2 rows x 4 cols hold two whole 2x2 windows
  const int Ho = H / 2, Wo = W / 2;
  const int oy = (y0 + pr) / 2;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int ox = (x0 + pc) / 2 + k;
    if (oy >= Ho || ox >= Wo) continue;
    O* dst = y + (((size_t)b * Ho + oy) * Wo + ox) * C + 4 * cg;
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const float m = fmaxf(fmaxf(acc2[0][2 * k][o], acc2[0][2 * k + 1][o]),
                            fmaxf(acc2[1][2 * k][o], acc2[1][2 * k + 1][o]));
      dst[o] = lg::from_f<O>(m);
    }
  }
}

template <typename O, bool RELU>
int launch(const void* x, const void* wa, const void* ba, const void* wb,
           const void* bb, void* y, int B, int H, int W, cudaStream_t stream) {
  static bool opted_in = false;  // above 48 KB: opt in once per instantiation
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        chain_kernel<O, RELU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  chain_kernel<O, RELU><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wa), static_cast<const float*>(ba),
      static_cast<const float*>(wb), static_cast<const float*>(bb), static_cast<O*>(y), H, W);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The bf16 chain on the tensor cores
// ---------------------------------------------------------------------------

using lg::bf16_t;
using lg::LD;                     // bf16 pixel pitch in shared memory (144 B)
constexpr int OT = 16;            // conv2b output tile side (pre-pool)
constexpr int AT = OT + 2;        // conv2a tile side: conv2b's halo
constexpr int XT = OT + 4;        // input tile side: conv2a's halo
constexpr int A_PIX = AT * AT;    // conv2a pixels per tile (324)
constexpr int MWARPS = OT / 2;    // warps of a block: two conv2b rows each
constexpr int A_MT = (A_PIX + 15) / 16;                  // conv2a m16 tiles (21)
constexpr int A_MT_WARP = (A_MT + MWARPS - 1) / MWARPS;  // per warp, at most (3)
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

template <typename O>
int launch_fp32(const void* x, const void* wa, const void* ba, const void* wb, const void* bb,
                void* y, int B, int H, int W, int relu, cudaStream_t s) {
  return (relu ? launch<O, true> : launch<O, false>)(x, wa, ba, wb, bb, y, B, H, W, s);
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
  return (bf16_out ? launch_fp32<bf16_t> : launch_fp32<float>)(x, wa, ba, wb, bb, y, B, H, W,
                                                               relu, s);
}
