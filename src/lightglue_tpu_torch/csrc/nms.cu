// Fused SuperPoint NMS + border mask + per-8x8-tile top-`cap` candidates.
//
// Replaces the TPU kernel lightglue_tpu/kernels/nms.py:nms_candidates
// (wrapper :199, pallas_call :227, body _nms_cand_kernel :87-194). The TPU
// kernel holds the whole map in VMEM and works with lane/sublane rolls; a
// Hopper block cannot hold a 480x640 map, so each block takes one band of
// 8 rows x 64 cols plus a halo of 5*radius pixels on every side: the keep
// test of a pixel chains five radius-r max-pools (max, suppress, re-admit
// twice), so 5*r = 20 px of context make the band's result exact.
//
// Semantics, held to the reference: sliding maxes use -inf SAME padding
// (outside the image counts as absent), the 4-px border frame becomes -1,
// and each tile emits its top `cap` by repeated max-and-mask, ties going
// to the smallest flat index y*W+x and only the emitted element being
// suppressed. Output is tile-major / round-minor.
//
// Bound on the H100: one read of the fp32 map and two small writes, ~2.5
// MB at 2x480x640, i.e. under 1 us of HBM time; the comparisons (~100 per
// pixel) bound it at a few us on the fp32 units. This first version spends
// most of its time in the shared-memory passes over the haloed band (the
// band's 8x64 core is 13% of its 48x104 region).

#include <math.h>

#include "common.cuh"

namespace {

constexpr int BAND_H = 8;    // band rows == tile rows
constexpr int BAND_W = 64;   // band cols == 8 tiles of 8
constexpr int THREADS = 256; // 8 warps, one per tile of the band

struct Region {
  int rows, cols;          // haloed band size
  int vy0, vy1, vx0, vx1;  // the part of the band inside the image
};

// out[p] = max of in over the (2r+1)^2 window around p, clipped to the part
// of the band inside the image (-inf SAME padding). Positions near the band's
// inner edges come out too small; they lie outside the exact core.
__device__ void max_pool(const float* in, float* tmp, float* out,
                         const Region& g, int radius) {
  const int n = g.rows * g.cols;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / g.cols, c = i % g.cols;
    const int lo = max(c - radius, g.vx0), hi = min(c + radius, g.vx1 - 1);
    float m = -INFINITY;
    for (int cc = lo; cc <= hi; ++cc) m = fmaxf(m, in[r * g.cols + cc]);
    tmp[i] = m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / g.cols, c = i % g.cols;
    const int lo = max(r - radius, g.vy0), hi = min(r + radius, g.vy1 - 1);
    float m = -INFINITY;
    for (int rr = lo; rr <= hi; ++rr) m = fmaxf(m, tmp[rr * g.cols + c]);
    out[i] = m;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
nms_candidates_kernel(const float* __restrict__ scores,
                      float* __restrict__ out_v, int* __restrict__ out_i,
                      int H, int W, int radius, int border, int cap) {
  extern __shared__ float smem[];
  const int halo = 5 * radius;
  Region g;
  g.rows = BAND_H + 2 * halo;
  g.cols = BAND_W + 2 * halo;
  const int n = g.rows * g.cols;
  float* X = smem;       // raw scores, -inf outside the image
  float* M = X + n;      // keep mask (0/1)
  float* U = M + n;      // suppression mask (0/1)
  float* S = U + n;      // suppressed scores
  float* T = S + n;      // row-pass scratch
  float* P = T + n;      // pooled

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * BAND_H;
  const int x0 = blockIdx.x * BAND_W;
  const int ry0 = y0 - halo, rx0 = x0 - halo;  // image coords of region (0, 0)
  g.vy0 = max(0, -ry0);
  g.vy1 = min(g.rows, H - ry0);
  g.vx0 = max(0, -rx0);
  g.vx1 = min(g.cols, W - rx0);
  const float* sb = scores + (size_t)b * H * W;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int gy = ry0 + i / g.cols, gx = rx0 + i % g.cols;
    X[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? sb[(size_t)gy * W + gx]
                                                    : -INFINITY;
  }
  __syncthreads();

  // simple_nms: keep = local max; two rounds re-admit maxima of the map with
  // the kept pixels' neighbourhoods zeroed
  max_pool(X, T, P, g, radius);
  for (int i = threadIdx.x; i < n; i += blockDim.x) M[i] = X[i] == P[i] ? 1.f : 0.f;
  __syncthreads();
  for (int round = 0; round < 2; ++round) {
    max_pool(M, T, P, g, radius);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const bool supp = P[i] > 0.f;
      U[i] = supp ? 1.f : 0.f;
      S[i] = supp ? 0.f : X[i];
    }
    __syncthreads();
    max_pool(S, T, P, g, radius);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      if (S[i] == P[i] && U[i] == 0.f) M[i] = 1.f;
    }
    __syncthreads();
  }

  // one warp per 8x8 tile; each lane holds two of its 64 pixels in registers
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tx = x0 + 8 * warp;  // tile's first column
  if (tx >= W) return;           // W % 8 == 0: whole tiles only
  float v[2];
  int f[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int e = lane + 32 * k;
    const int gy = y0 + e / 8, gx = tx + e % 8;
    const int ri = (halo + e / 8) * g.cols + halo + 8 * warp + e % 8;
    float s = M[ri] > 0.f ? X[ri] : 0.f;
    const bool inside =
        gy >= border && gy < H - border && gx >= border && gx < W - border;
    v[k] = inside ? s : -1.f;
    f[k] = gy * W + gx;
  }
  const int tiles_w = W / 8;
  const size_t base =
      ((size_t)b * (H / 8) * tiles_w + (size_t)(y0 / 8) * tiles_w + tx / 8) * cap;
  for (int r = 0; r < cap; ++r) {
    float bv;
    int bi;
    if (v[0] > v[1] || (v[0] == v[1] && f[0] < f[1])) {
      bv = v[0];
      bi = f[0];
    } else {
      bv = v[1];
      bi = f[1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      out_v[base + r] = bv;
      out_i[base + r] = bi;
    }
    if (f[0] == bi) v[0] = -INFINITY;
    if (f[1] == bi) v[1] = -INFINITY;
  }
}

}  // namespace

// scores: (B, H, W) fp32, H % 8 == 0, W % 8 == 0.
// out_v / out_i: (B, (H/8)*(W/8)*cap) fp32 / int32.
extern "C" int lg_nms_candidates(const void* scores, void* out_v, void* out_i,
                                 int B, int H, int W, int radius, int border,
                                 int cap, void* stream) {
  const int halo = 5 * radius;
  const size_t smem =
      6 * sizeof(float) * (size_t)(BAND_H + 2 * halo) * (BAND_W + 2 * halo);
  static size_t opted_in = 48 * 1024;  // raised once per size, not per launch
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_candidates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  dim3 grid((W + BAND_W - 1) / BAND_W, H / BAND_H, B);
  nms_candidates_kernel<<<grid, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<float*>(out_v),
      static_cast<int*>(out_i), H, W, radius, border, cap);
  return static_cast<int>(cudaGetLastError());
}
