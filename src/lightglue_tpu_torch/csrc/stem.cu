// SuperPoint's conv1a: the fp32 tap stem, SAME 3x3 conv from 1 channel to
// 64, + bias, ReLU, one cast, NHWC out.
//
// Counterpart of lightglue_tpu/models/superpoint.py:_relu_conv1a_shift
// (:56), which is not a Pallas function: XLA fuses its nine shifted
// broadcast products into one loop. Run as plain PyTorch it is ~20 launches
// over a (B, H, W, 64) fp32 accumulator; this kernel is that one loop.
//
// Contract, bit for bit with kernels/stem.py:relu_conv1a_shift_plain: the
// image is read in its dtype (bf16 or fp32) and widened to fp32, zero
// padding as F.pad; acc starts at 0 and takes each tap's product, rounded,
// then the add, rounded (__fmul_rn / __fadd_rn: nvcc would contract a*b+c
// into an FMA), in tap order di-major, dj-minor; then + bias, ReLU and one
// round-to-nearest-even cast to the image's dtype.
//
// Bound on the H100: the output, 2x480x640x64 = 78.6 MB of bf16 (157 MB of
// fp32), written once: 0.0235 ms (0.047) at 3.35 TB/s. The arithmetic is
// 18 fp32 instructions per output element that may not fuse, ~0.022 ms
// of issue at 2x480x640, so the kernel is near both limits at once. The
// design (scripts/tune_torch_superpoint.py times TILE_H and PIX): a block
// stages its 16x64 pixels' (18x66) haloed image tile in shared memory
// once; each thread owns 8 channels, keeps their 9 taps' weights and
// biases in registers, takes PIX = 2 adjacent pixels a step (12 image
// values for 18 taps) and writes each pixel's 8 channels as one 16-byte
// store (two at fp32): a warp's store covers four whole pixels.

#include "common.cuh"

namespace {

using namespace lg;

constexpr int C = 64;          // conv1a's output channels
constexpr int GROUP = 8;       // channels per thread: one 16-byte bf16 store
constexpr int TILE_H = 16;     // pixels of a block: TILE_H x TILE_W
constexpr int TILE_W = 64;
constexpr int PIX = 2;         // adjacent pixels of a row per thread and step
constexpr int THREADS = 256;
constexpr int STEP = THREADS / (C / GROUP);  // pixel runs per step of the block

__device__ __forceinline__ void store8(float* y, const float (&v)[GROUP]) {
  reinterpret_cast<float4*>(y)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(y)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* y, const float (&v)[GROUP]) {
  uint4 packed;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int k = 0; k < GROUP / 2; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(y) = packed;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
stem_kernel(const T* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, T* __restrict__ y, int H, int W) {
  __shared__ float xs[TILE_H + 2][TILE_W + 2];
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE_H, x0 = blockIdx.x * TILE_W;
  const T* xb = x + (size_t)b * H * W;
  for (int e = threadIdx.x; e < (TILE_H + 2) * (TILE_W + 2); e += THREADS) {
    const int i = e / (TILE_W + 2), j = e % (TILE_W + 2);
    const int gy = y0 - 1 + i, gx = x0 - 1 + j;
    xs[i][j] = ((unsigned)gy < (unsigned)H && (unsigned)gx < (unsigned)W)
                   ? to_f(xb[(size_t)gy * W + gx])
                   : 0.f;
  }
  const int c0 = GROUP * (threadIdx.x % (C / GROUP));
  float wr[9][GROUP], br[GROUP];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int k = 0; k < GROUP; ++k) wr[t][k] = __ldg(w + t * C + c0 + k);  // HWIO (3,3,1,C)
#pragma unroll
  for (int k = 0; k < GROUP; ++k) br[k] = __ldg(bias + c0 + k);
  __syncthreads();

  for (int p = threadIdx.x / (C / GROUP); p < TILE_H * TILE_W / PIX; p += STEP) {
    const int i = p / (TILE_W / PIX), j = p % (TILE_W / PIX) * PIX;
    const int gy = y0 + i, gx = x0 + j;
    if (gy >= H || gx >= W) continue;  // W % 8 == 0: whole runs only
    float xv[3][PIX + 2];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < PIX + 2; ++c) xv[r][c] = xs[i + r][j + c];
#pragma unroll
    for (int q = 0; q < PIX; ++q) {
      float out[GROUP];
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t)
          acc = __fadd_rn(acc, __fmul_rn(xv[t / 3][q + t % 3], wr[t][k]));
        out[k] = fmaxf(__fadd_rn(acc, br[k]), 0.f);
      }
      store8(y + ((size_t)(b * H + gy) * W + gx + q) * C + c0, out);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* y, int B, int H,
           int W, cudaStream_t stream) {
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  stem_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<T*>(y), H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, H, W) bf16 or fp32 (bf16 set), H % 8 == 0, W % 8 == 0; w: (3, 3,
// 1, 64) fp32; bias: (64,) fp32; y: (B, H, W, 64) in x's dtype.
extern "C" int lg_relu_conv1a_shift(const void* x, const void* w, const void* bias,
                                    void* y, int B, int H, int W, int bf16,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(x, w, bias, y, B, H, W, s);
  return launch<float>(x, w, bias, y, B, H, W, s);
}
