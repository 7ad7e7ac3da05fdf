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
// One templated kernel: the fixed instantiation (C_in = C_out = 64, ReLU,
// output type = input type) is the model's, with its channel counts as
// compile-time constants; the generic one takes C_in and C_out at run time
// and tiles C_out over 64-channel blocks.
//
// Bound on the H100: at 2x480x640 the three 64-channel convs are ~68 GFLOP
// against ~0.2 GB of activations, so the tensor cores bound them (~0.07 ms
// at the bf16 peak); the C >= 128 shapes are further above the ridge. This
// first version is a direct conv on the fp32 FMA units: one block per 8x16
// output tile and 64 output channels, the haloed input tile and the taps'
// weights staged in shared memory 16 input channels at a time (under the
// 48 KB static limit, so several blocks share an SM; a chunk past C_in is
// zero-filled), 8 pixels x 4 output channels of fp32 accumulators per
// thread, and the bias/ReLU/pool epilogue in registers. Moving the inner
// product onto wgmma is later work.

#include "common.cuh"

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
  if (Cin == C && Cout == C && relu && same)  // the model's 64 -> 64 convs
    return launch<T, T, false, true>(x, w, bias, y, B, H, W, Cin, Cout, pool, s);
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
