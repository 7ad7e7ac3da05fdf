// SAME 3x3 conv, NHWC, fp32 accumulation, fp32 bias, optional ReLU and an
// optional fused 2x2 max-pool, cast to the output type.
//
// Replaces two TPU kernels of lightglue_tpu/kernels/conv.py:
//   conv3x3_paired  wrapper :356, pallas_call :458, body _conv_kernel
//                   :45-160: SuperPoint's conv1b (+pool), conv2a and conv2b
//                   (+pool), 64 -> 64 with ReLU. The paired/offset column
//                   packing only exists to fill the 128-wide MXU; this
//                   kernel computes superpoint.py:_relu_conv directly.
//   conv3x3         wrapper :182, pallas_call :222, the same body: any
//                   C_in, C_out multiple of 8, ReLU optional, any output
//                   type (a tested variant the model does not call).
// The contract kept is superpoint.py:_relu_conv's: fp32 accumulation over all
// 9 taps x C_in, fp32 bias, ReLU, the optional 2x2 max-pool in fp32, then ONE
// cast to the output type.
//
// Bound on the H100: at 2x480x640 the three 64-channel convs are ~68 GFLOP
// against ~0.2 GB of activations, so the tensor cores bound them (~0.07 ms
// at the bf16 peak); the C >= 128 shapes are further above the ridge.
//
// The model's bf16 calls (C_in = C_out = 64, ReLU, bf16 out) run
// conv3x3_mma_kernel, an implicit GEMM on the tensor cores: M = a tile's
// output pixels, N = the 64 output channels, K = 9 taps x 64 input channels
// (36 k16 steps of mma.sync m16n8k16, bf16 in, fp32 sums).
// - Persistent blocks (as many as fit on the card at once) walk the 16x16
//   output tiles; each block stages all nine taps' weights once (HWIO is
//   [tap][ci][co], i.e. [k][n]: 72 KB, read by ldmatrix.trans as
//   linear.cu reads the stack's weights).
// - The haloed 18x18 input tile stages by 16 B cp.async (NHWC: a pixel's 64
//   channels are one 128 B row, padded to mma.cuh's LD pitch so the eight
//   rows of an ldmatrix fall in different banks), zero-filled for the SAME
//   padding and past the image; the next tile copies while this one
//   computes. The A fragments of tap (dy, dx) come by ldmatrix straight from
//   the tile at that offset: no im2col copy.
// - Eight warps, two tile rows of 16 pixels each, all 64 channels: the two
//   m-tiles share every B fragment, and a 2x2 pool window lies in one
//   warp (its rows in one thread, its columns in lanes 4 apart).
// - Epilogue: fp32 acc + fp32 bias, ReLU, the pool max, one cast to bf16,
//   through the finished input tile as a stage to 16 B stores; edge tiles
//   are masked per pixel, so any H and W run (360x488 gives a 488-wide
//   conv1b and a 244-wide conv2a).
//
// Left on the fp32 FMA units: the fp32 rung (one TF32 mma would miss its
// 1e-4 gate) and the generic instantiation in both types (a tested variant
// no path calls), conv3x3_kernel: one block per 8x16 output tile and 64
// output channels, the haloed input tile and the taps' weights staged in
// shared memory 16 input channels at a time (under the 48 KB static limit;
// a chunk past C_in is zero-filled), 8 pixels x 4 output channels of fp32
// accumulators per thread, and the bias/ReLU/pool epilogue in registers. Its
// fixed instantiation (C_in = C_out = 64, ReLU) takes the channel counts as
// compile-time constants; the generic one takes them at run time and tiles
// C_out over 64-channel blocks.

#include "mma.cuh"

namespace {

constexpr int C = 64;        // output channels per block (and the fixed C_in)
constexpr int TH = 8;        // output tile rows (pre-pool)
constexpr int TW = 16;       // output tile cols (pre-pool)
constexpr int CI = 16;       // input channels staged per step
constexpr int HR = TH + 2;   // haloed tile rows
constexpr int HC = TW + 2;   // haloed tile cols
constexpr int THREADS = 256;

template <typename T, typename O, bool GENERIC, bool RELU>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, O* __restrict__ y,
               int H, int W, int Cin, int Cout, int pool) {
  __shared__ float xs[HR * HC * CI];               // [row][col][ci] 11.5 KB
  __shared__ __align__(16) float ws[9 * CI * C];   // [tap][ci][co]  36.9 KB

  const int cin = GENERIC ? Cin : C;
  const int cout = GENERIC ? Cout : C;
  const int tiles = GENERIC ? (cout + C - 1) / C : 1;  // 64-channel output tiles
  const int tid = threadIdx.x;
  const int cg = tid % 16;             // output channels co0 + 4cg .. co0 + 4cg+3
  const int pg = tid / 16;             // pixel group: 2 rows x 4 cols
  const int pr = 2 * (pg / 4);         // tile row of the group
  const int pc = 4 * (pg % 4);         // tile col of the group
  const int b = GENERIC ? blockIdx.z / tiles : blockIdx.z;
  const int co0 = GENERIC ? blockIdx.z % tiles * C : 0;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const T* xb = x + (size_t)b * H * W * cin;

  float acc[2][4][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int o = 0; o < 4; ++o) acc[r][c][o] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CI) {
    __syncthreads();  // the previous step's tiles are no longer read
    for (int i = tid; i < HR * HC * CI; i += THREADS) {
      const int ci = i % CI;
      const int pix = i / CI;
      const int gy = y0 - 1 + pix / HC;
      const int gx = x0 - 1 + pix % HC;
      float v = 0.f;  // SAME zero padding, and channels past C_in
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && (!GENERIC || c0 + ci < cin))
        v = lg::to_f(xb[((size_t)gy * W + gx) * cin + c0 + ci]);
      xs[i] = v;
    }
    for (int i = tid; i < 9 * CI * C; i += THREADS) {
      const int co = i % C;
      const int ci = (i / C) % CI;
      const int tap = i / (C * CI);
      float v = 0.f;
      if (!GENERIC || (c0 + ci < cin && co0 + co < cout))
        v = lg::to_f(w[((size_t)tap * cin + c0 + ci) * cout + co0 + co]);
      ws[i] = v;
    }
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
            const float xv = xs[((pr + r + dy) * HC + pc + c + dx) * CI + ci];
            acc[r][c][0] = fmaf(xv, wv.x, acc[r][c][0]);
            acc[r][c][1] = fmaf(xv, wv.y, acc[r][c][1]);
            acc[r][c][2] = fmaf(xv, wv.z, acc[r][c][2]);
            acc[r][c][3] = fmaf(xv, wv.w, acc[r][c][3]);
          }
      }
    }
  }

  const int co = co0 + 4 * cg;  // C_out % 8 == 0: all four channels or none
  if (GENERIC && co >= cout) return;
  float bv[4];
#pragma unroll
  for (int o = 0; o < 4; ++o) bv[o] = bias[co + o];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const float v = acc[r][c][o] + bv[o];
        acc[r][c][o] = RELU ? fmaxf(v, 0.f) : v;
      }

  if (pool) {
    // the group's 2 rows x 4 cols hold two whole 2x2 windows
    const int Ho = H / 2, Wo = W / 2;
    const int oy = (y0 + pr) / 2;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int ox = (x0 + pc) / 2 + k;
      if (oy >= Ho || ox >= Wo) continue;
      O* dst = y + (((size_t)b * Ho + oy) * Wo + ox) * cout + co;
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const float m = fmaxf(fmaxf(acc[0][2 * k][o], acc[0][2 * k + 1][o]),
                              fmaxf(acc[1][2 * k][o], acc[1][2 * k + 1][o]));
        dst[o] = lg::from_f<O>(m);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gy = y0 + pr + r;
        const int gx = x0 + pc + c;
        if (gy >= H || gx >= W) continue;
        O* dst = y + (((size_t)b * H + gy) * W + gx) * cout + co;
#pragma unroll
        for (int o = 0; o < 4; ++o) dst[o] = lg::from_f<O>(acc[r][c][o]);
      }
  }
}

template <typename T, typename O, bool GENERIC, bool RELU>
int launch(const void* x, const void* w, const void* bias, void* y, int B,
           int H, int W, int Cin, int Cout, int pool, cudaStream_t stream) {
  const int tiles = GENERIC ? (Cout + C - 1) / C : 1;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * tiles);
  conv3x3_kernel<T, O, GENERIC, RELU><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<O*>(y), H, W, Cin, Cout, pool);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The model's bf16 64 -> 64 ReLU conv on the tensor cores
// ---------------------------------------------------------------------------

using lg::bf16_t;
using lg::LD;                  // bf16 pixel pitch in shared memory: 64 channels + 8 (144 B)
constexpr int MT = 16;         // output tile side (pre-pool)
constexpr int MH = MT + 2;     // haloed input tile side
constexpr int MWARPS = MT / 2;  // warps of a block: two tile rows each
constexpr int TILE_PIX = MH * MH;
constexpr size_t MMA_SMEM = sizeof(bf16_t) * (9 * C + 2 * TILE_PIX) * LD;  // 176,256 B

__global__ void __launch_bounds__(MWARPS * 32, 1)
conv3x3_mma_kernel(const bf16_t* __restrict__ x, const bf16_t* __restrict__ w,
                   const float* __restrict__ bias, bf16_t* __restrict__ y, int H, int W,
                   int tiles_x, int tiles_y, int tiles, int pool) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* ws = reinterpret_cast<bf16_t*>(smem_raw);  // [tap * 64 + ci][LD]: the weights
  bf16_t* xs = ws + 9 * C * LD;                      // [2][TILE_PIX][LD]: input tiles

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;   // mma fragment row and column pair
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix matrix and row of this lane
  const int per_image = tiles_x * tiles_y;

  // all nine taps' weights, once per block (in the first tile's copy group)
  for (int s = tid; s < 9 * C * (C / 8); s += blockDim.x) {
    const int r = s / (C / 8), c = s % (C / 8) * 8;
    lg::cp_async16(ws + r * LD + c, w + (size_t)r * C + c);
  }
  float bv[C / 8][2];  // this thread's output channels n * 8 + 2 * t4 + {0, 1}
#pragma unroll
  for (int n = 0; n < C / 8; ++n) {
    bv[n][0] = __ldg(bias + n * 8 + 2 * t4);
    bv[n][1] = __ldg(bias + n * 8 + 2 * t4 + 1);
  }

  // the haloed input tile of output tile t; zeros outside the image
  auto stage = [&](int t, bf16_t* buf) {
    const int b = t / per_image, ty = t % per_image / tiles_x, tx = t % tiles_x;
    const int gy0 = ty * MT - 1, gx0 = tx * MT - 1;
    for (int s = tid; s < TILE_PIX * (C / 8); s += blockDim.x) {
      const int p = s / (C / 8), c = s % (C / 8) * 8;
      const int gy = gy0 + p / MH, gx = gx0 + p % MH;
      bf16_t* d = buf + p * LD + c;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        lg::cp_async16(d, x + (((size_t)b * H + gy) * W + gx) * C + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  };

  int t = blockIdx.x, cur = 0;
  stage(t, xs);  // gridDim.x <= tiles
  lg::cp_async_commit();
  for (; t < tiles; t += gridDim.x, cur ^= 1) {
    bf16_t* buf = xs + cur * TILE_PIX * LD;
    if (t + gridDim.x < tiles) stage(t + gridDim.x, xs + (cur ^ 1) * TILE_PIX * LD);
    lg::cp_async_commit();
    lg::cp_async_wait<1>();  // the weights and tile t have landed
    __syncthreads();

    // acc[m][n]: tile row 2 * warp + m, channels n * 8.., fp32 over 9 x 64
    float acc[2][C / 8][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < C / 8; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int k16 = 0; k16 < C / 16; ++k16) {
        unsigned a[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)  // 16 pixels of a row, shifted by the tap
          lg::ldsm_x4(a[m], buf + ((2 * warp + m + dy) * MH + mr + (mi & 1) * 8 + dx) * LD +
                                k16 * 16 + (mi >> 1) * 8);
        const bf16_t* wk = ws + (tap * C + k16 * 16 + mr + (mi & 1) * 8) * LD + (mi >> 1) * 8;
#pragma unroll
        for (int np = 0; np < C / 16; ++np) {
          unsigned r[4];
          lg::ldsm_x4_trans(r, wk + np * 16);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            lg::mma_bf16(acc[m][2 * np], a[m], r[0], r[1]);
            lg::mma_bf16(acc[m][2 * np + 1], a[m], r[2], r[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with buf: it becomes the output stage

    // fp32 bias, ReLU, [the pool max,] one cast, into the stage [pixel][LD]
    if (pool) {
#pragma unroll
      for (int n = 0; n < C / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // fragment rows g and g + 8
          float v[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float top = fmaxf(acc[0][n][2 * i + j] + bv[n][j], 0.f);
            const float bot = fmaxf(acc[1][n][2 * i + j] + bv[n][j], 0.f);
            v[j] = fmaxf(top, bot);
            v[j] = fmaxf(v[j], __shfl_xor_sync(0xffffffffu, v[j], 4));  // the column pair
          }
          if (!(g & 1))
            *reinterpret_cast<__nv_bfloat162*>(buf + (warp * MT / 2 + (g + 8 * i) / 2) * LD +
                                               n * 8 + 2 * t4) = __floats2bfloat162_rn(v[0], v[1]);
        }
    } else {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < C / 8; ++n)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            *reinterpret_cast<__nv_bfloat162*>(buf + ((2 * warp + m) * MT + g + 8 * i) * LD +
                                               n * 8 + 2 * t4) =
                __floats2bfloat162_rn(fmaxf(acc[m][n][2 * i] + bv[n][0], 0.f),
                                      fmaxf(acc[m][n][2 * i + 1] + bv[n][1], 0.f));
    }
    __syncwarp();

    // this warp's output pixels, 16 B stores, masked at the image's edge
    const int b = t / per_image, ty = t % per_image / tiles_x, tx = t % tiles_x;
    const int side = pool ? MT / 2 : MT, rows = pool ? 1 : 2;
    const int Ho = pool ? H / 2 : H, Wo = pool ? W / 2 : W;
    for (int s = lane; s < rows * side * (C / 8); s += 32) {
      const int p = s / (C / 8), c = s % (C / 8) * 8;
      const int row = rows * warp + p / side;  // output row within the tile
      const int oy = ty * side + row, ox = tx * side + p % side;
      if (oy < Ho && ox < Wo)
        *reinterpret_cast<uint4*>(y + (((size_t)b * Ho + oy) * Wo + ox) * C + c) =
            *reinterpret_cast<const uint4*>(buf + (row * side + p % side) * LD + c);
    }
    __syncthreads();  // buf is free for the tile after next
  }
}

int launch_mma(const void* x, const void* w, const void* bias, void* y, int B, int H, int W,
               int pool, cudaStream_t stream) {
  // x and w are read 16 B at a time
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  static int resident = 0;  // blocks the card runs at once, found once
  if (!resident) {
    cudaError_t err = cudaFuncSetAttribute(conv3x3_mma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(MMA_SMEM));
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv3x3_mma_kernel,
                                                          MWARPS * 32, MMA_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * max(per_sm, 1);
  }
  const int tiles_x = (W + MT - 1) / MT, tiles_y = (H + MT - 1) / MT;
  const int tiles = B * tiles_x * tiles_y;
  conv3x3_mma_kernel<<<min(tiles, resident), MWARPS * 32, MMA_SMEM, stream>>>(
      static_cast<const bf16_t*>(x), static_cast<const bf16_t*>(w),
      static_cast<const float*>(bias), static_cast<bf16_t*>(y), H, W, tiles_x, tiles_y, tiles,
      pool);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O>
int generic(const void* x, const void* w, const void* bias, void* y, int B,
            int H, int W, int Cin, int Cout, int pool, int relu, cudaStream_t s) {
  return (relu ? launch<T, O, true, true> : launch<T, O, true, false>)(
      x, w, bias, y, B, H, W, Cin, Cout, pool, s);
}

template <typename T>
int dispatch(const void* x, const void* w, const void* bias, void* y, int B,
             int H, int W, int Cin, int Cout, int pool, int relu, int bf16_out,
             cudaStream_t s) {
  const bool same = bf16_out == (sizeof(T) == 2);
  if (Cin == C && Cout == C && relu && same) {  // the model's 64 -> 64 convs
    if constexpr (sizeof(T) == 2)
      return launch_mma(x, w, bias, y, B, H, W, pool, s);
    else
      return launch<T, T, false, true>(x, w, bias, y, B, H, W, Cin, Cout, pool, s);
  }
  if (bf16_out)
    return generic<T, __nv_bfloat16>(x, w, bias, y, B, H, W, Cin, Cout, pool, relu, s);
  return generic<T, float>(x, w, bias, y, B, H, W, Cin, Cout, pool, relu, s);
}

}  // namespace

// x: (B, H, W, Cin) input type; w: (3, 3, Cin, Cout) HWIO input type; bias:
// (Cout,) fp32; Cin and Cout multiples of 8. y: (B, H, W, Cout) or, with
// pool (H and W even), (B, H/2, W/2, Cout), in the output type (bf16 when
// bf16_out, else fp32).
extern "C" int lg_conv3x3(const void* x, const void* w, const void* bias,
                          void* y, int B, int H, int W, int Cin, int Cout,
                          int pool, int relu, int bf16, int bf16_out,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(x, w, bias, y, B, H, W, Cin, Cout, pool, relu, bf16_out, s);
  return dispatch<float>(x, w, bias, y, B, H, W, Cin, Cout, pool, relu, bf16_out, s);
}
