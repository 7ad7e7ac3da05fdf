// SuperPoint's conv2 pair in one launch: conv2a (+bias, ReLU, rounded to the
// input type) -> conv2b (+bias [+ReLU]) -> 2x2 max-pool, NHWC, 64 channels.
//
// Replaces the TPU kernel lightglue_tpu/kernels/conv_chain.py:conv2_chain
// (wrapper :140, pallas_call :180, body _chain_kernel :51-134), which keeps
// the conv2a strip in VMEM and feeds conv2b from it. Its contract: conv2a's
// output is relu(conv + ba), set to 0 outside the image (conv2b's SAME
// padding, :105-110), then rounded to x's type; conv2b accumulates it in
// fp32 against wb, adds bb, applies ReLU when asked, and the 2x2 pool
// follows; the result is cast to the output type. The paired/offset column
// packings are the MXU's and are not kept.
//
// Bound on the H100: at 2x240x320 the pair is ~29 GFLOP against ~20 MB of
// input and output, so the tensor cores bound it (~0.03 ms at the bf16
// peak); the intermediate never needs to reach device memory. Design: one
// block per 8x16 conv2b output tile (4x8 pooled). It first computes conv2a
// over the 10x18 tile that conv2b reads (the tile plus its halo), from a
// 12x20 input tile staged 16 channels at a time with the taps' weights, and
// keeps the result, rounded and zeroed outside the image, in shared memory
// (46 KB). Then conv2b runs over that tile with conv3x3.cu's thread layout
// (2x4 pixels x 4 channels per thread) and the bias/ReLU/pool epilogue in
// registers. Adjacent tiles recompute their shared conv2a halo (180 of 128
// pixels, +41 % of conv2a's work) instead of sending it through device
// memory. Products on the fp32 FMA units, as the other first versions.

#include "common.cuh"

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

template <typename T>
__device__ void stage_weights(float* ws, const T* w, int c0) {
  for (int i = threadIdx.x; i < 9 * CI * C; i += THREADS) {
    const int co = i % C;
    const int ci = (i / C) % CI;
    const int tap = i / (C * CI);
    ws[i] = lg::to_f(w[((size_t)tap * C + c0 + ci) * C + co]);
  }
}

template <typename T, typename O, bool RELU>
__global__ void __launch_bounds__(THREADS)
chain_kernel(const T* __restrict__ x, const T* __restrict__ wa,
             const float* __restrict__ ba, const T* __restrict__ wb,
             const float* __restrict__ bb, O* __restrict__ y, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [XH * XW][CI] input tile
  float* ws = xs + XH * XW * CI;    // [tap][CI][C] weights (16-byte aligned)
  float* as = ws + 9 * CI * C;      // [APX][C] conv2a tile, rounded to T

  const int tid = threadIdx.x;
  const int cg = tid % 16;  // channels 4cg .. 4cg+3
  const int pg = tid / 16;  // pixel group
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const T* xb = x + (size_t)b * H * W * C;

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
        v = lg::to_f(xb[((size_t)gy * W + gx) * C + c0 + ci]);
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
  // bias, ReLU, 0 outside the image (conv2b's padding), rounded to T
#pragma unroll
  for (int i = 0; i < APT; ++i) {
    const int p = pg + 16 * i;
    if (p >= APX) continue;
    const int gy = y0 - 1 + p / AW;
    const int gx = x0 - 1 + p % AW;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const float v = lg::round_to<T>(fmaxf(acc[i][o] + ba[4 * cg + o], 0.f));
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

template <typename T, typename O, bool RELU>
int launch(const void* x, const void* wa, const void* ba, const void* wb,
           const void* bb, void* y, int B, int H, int W, cudaStream_t stream) {
  static bool opted_in = false;  // above 48 KB: opt in once per instantiation
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        chain_kernel<T, O, RELU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  chain_kernel<T, O, RELU><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wa), static_cast<const float*>(ba),
      static_cast<const T*>(wb), static_cast<const float*>(bb), static_cast<O*>(y), H, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O>
int with_relu(const void* x, const void* wa, const void* ba, const void* wb,
              const void* bb, void* y, int B, int H, int W, int relu, cudaStream_t s) {
  return (relu ? launch<T, O, true> : launch<T, O, false>)(x, wa, ba, wb, bb, y, B, H, W, s);
}

template <typename T>
int dispatch(const void* x, const void* wa, const void* ba, const void* wb,
             const void* bb, void* y, int B, int H, int W, int relu, int bf16_out,
             cudaStream_t s) {
  return (bf16_out ? with_relu<T, __nv_bfloat16> : with_relu<T, float>)(
      x, wa, ba, wb, bb, y, B, H, W, relu, s);
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
  if (bf16) return dispatch<__nv_bfloat16>(x, wa, ba, wb, bb, y, B, H, W, relu, bf16_out, s);
  return dispatch<float>(x, wa, ba, wb, bb, y, B, H, W, relu, bf16_out, s);
}
