// Fused SuperPoint NMS + border mask + per-8x8-tile top-`cap` candidates.
//
// Replaces the TPU kernel lightglue_tpu/kernels/nms.py:nms_candidates
// (wrapper :199, pallas_call :227, body _nms_cand_kernel :87-194). The TPU
// kernel holds the whole map in VMEM and works with lane/sublane rolls; a
// Hopper block cannot hold a 480x640 map, so each block takes one band of
// 32 rows x 64 cols (4 x 8 tiles) plus a halo of 5*radius pixels on every
// side: the keep test of a pixel chains five radius-r max-pools (max,
// suppress, re-admit twice), so 5*r px of context make the band's result
// exact.
//
// Semantics, held to the reference: sliding maxes use -inf SAME padding
// (outside the image counts as absent), the border frame becomes -1, and
// each tile emits its top `cap` by repeated max-and-mask, ties going to the
// smallest flat index y*W+x and only the emitted element being suppressed.
// Output is tile-major / round-minor.
//
// Bound on the H100: one read of the fp32 map and two small writes, ~2.5
// MB at 2x480x640, i.e. under 1 us of HBM time; the comparisons (~84 per
// pixel) bound it at about 1 us on the fp32 units. What the design does
// about the work it adds to that (scripts/tune_torch_superpoint.py times
// the band and run constants):
// - Each stage runs only over the part of the band its successors read:
//   the pool of X at margin r (halo 4r), the first dilation at 2r, the
//   first re-admission at 3r, the second dilation at 4r, the last pool on
//   the core. The ten passes of the five pools make ~21 outputs per core
//   pixel at r = 4, where ten passes over the whole haloed band make 37.
// - The band lives in two fp32 planes (X, and T for the row pass) and one
//   byte of flags per pixel (KEEP, SUPP); the suppressed scores S = SUPP ?
//   0 : X are formed where the row pass reads them, never stored. 68 KB at
//   r = 4, so three blocks of 8 warps share an SM, and the grid (300 blocks
//   at 2x480x640) is one wave.
// - Each max is separable, a row pass into T then a column pass out of it,
//   and every thread slides a run of RUN outputs in registers: RUN + 2r
//   shared loads for RUN outputs, and doubling windows (window_max) in
//   place of 2r compares per output. The row pass walks a warp down rows
//   of an odd stride, the column pass along a row: no bank conflicts.
// - The band is loaded with every read in flight at once, 16 bytes a load
//   where the halo keeps them aligned (r = 4).
// - The top-k gives each tile 8 lanes, one row each, so a warp runs four
//   tiles' rounds at once with three shuffle steps a round.
// - The radius is a template argument (0..MAX_RADIUS; the path runs 4), so
//   every stride and margin is a constant.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int BAND_H = 32;   // core rows of a block: four rows of tiles
constexpr int BAND_W = 64;   // core cols: eight columns of tiles
constexpr int THREADS = 256;
constexpr int RUN = 16;      // outputs per thread and item of a pass
constexpr int MAX_RADIUS = 6;
constexpr unsigned char KEEP = 1, SUPP = 2;

template <int R>
struct Band {
  static constexpr int rows = BAND_H + 10 * R;
  static constexpr int cols = BAND_W + 10 * R;
  static constexpr int stride = cols | 1;  // odd, so a warp down a column spans all banks
  static constexpr int plane = rows * stride;
  static constexpr int smem = (2 * sizeof(float) + 1) * plane;
};

// w[k] <- max(w[k], w[k + S]) for every k whose window stays in w: one
// doubling step, with constant indices so w stays in registers.
template <int S, int N>
__device__ __forceinline__ void double_step(float (&w)[N]) {
#pragma unroll
  for (int k = 0; k + 2 * S <= N; ++k) w[k] = fmaxf(w[k], w[k + S]);
}

// w[k] <- max of w[k .. k + 2R] for k < RUN, by doubling windows: after the
// step of S, w[k] is the max of a window of 2S; the last step joins two
// overlapping windows of P, the largest power of two <= 2R + 1. At r = 4
// that is 77 fmaxf for a run of 16 instead of 128.
template <int R>
__device__ __forceinline__ void window_max(float (&w)[RUN + 2 * R]) {
  constexpr int L = 2 * R + 1;
  constexpr int P = L >= 16 ? 16 : L >= 8 ? 8 : L >= 4 ? 4 : L >= 2 ? 2 : 1;
  if constexpr (P > 1) double_step<1>(w);
  if constexpr (P > 2) double_step<2>(w);
  if constexpr (P > 4) double_step<4>(w);
  if constexpr (P > 8) double_step<8>(w);
#pragma unroll
  for (int k = 0; k < RUN; ++k) w[k] = fmaxf(w[k], w[k + L - P]);
}

// T[i][j] = max over |d| <= R of src(i, j + d) for band rows [M, rows - M)
// and cols [N, cols - N); src is read at cols [N - R, cols - N + R).
template <int R, int M, int N, typename Src>
__device__ __forceinline__ void row_pass(float* T, Src src) {
  using G = Band<R>;
  constexpr int nr = G::rows - 2 * M, nc = G::cols - 2 * N;
  constexpr int runs = (nc + RUN - 1) / RUN;
  for (int it = threadIdx.x; it < nr * runs; it += THREADS) {
    const int i = M + it % nr;
    const int j0 = N + (it / nr) * RUN;
    float w[RUN + 2 * R];
#pragma unroll
    for (int k = 0; k < RUN + 2 * R; ++k) w[k] = src(i, min(j0 - R + k, G::cols - 1));
    window_max<R>(w);
#pragma unroll
    for (int k = 0; k < RUN; ++k)
      if (j0 + k < G::cols - N) T[i * G::stride + j0 + k] = w[k];
  }
}

// P = max over |d| <= R of T[i + d][j] for band rows [M, rows - M) and cols
// [M, cols - M); epi(i, j, P) consumes each.
template <int R, int M, typename Epi>
__device__ __forceinline__ void col_pass(const float* T, Epi epi) {
  using G = Band<R>;
  constexpr int nr = G::rows - 2 * M, nc = G::cols - 2 * M;
  constexpr int runs = (nr + RUN - 1) / RUN;
  for (int it = threadIdx.x; it < nc * runs; it += THREADS) {
    const int j = M + it % nc;
    const int i0 = M + (it / nc) * RUN;
    float w[RUN + 2 * R];
#pragma unroll
    for (int k = 0; k < RUN + 2 * R; ++k)
      w[k] = T[min(i0 - R + k, G::rows - 1) * G::stride + j];
    window_max<R>(w);
#pragma unroll
    for (int k = 0; k < RUN; ++k)
      if (i0 + k < G::rows - M) epi(i0 + k, j, w[k]);
  }
}

// One round of simple_nms on the band: SUPP = dilation of KEEP (out to
// margin M), then KEEP |= the maxima of S = SUPP ? 0 : X that SUPP does not
// cover (out to margin M + R).
template <int R, int M, typename Inside>
__device__ __forceinline__ void admit_round(const float* X, float* T, unsigned char* F,
                                            Inside inside) {
  using G = Band<R>;
  row_pass<R, M - R, M>(T, [&](int i, int j) {
    return (F[i * G::stride + j] & KEEP) ? 1.f : 0.f;
  });
  __syncthreads();
  col_pass<R, M>(T, [&](int i, int j, float p) {
    const int a = i * G::stride + j;
    F[a] = (F[a] & KEEP) | ((p > 0.f && inside(i, j)) ? SUPP : 0);
  });
  __syncthreads();
  row_pass<R, M, M + R>(T, [&](int i, int j) {
    const int a = i * G::stride + j;
    return (F[a] & SUPP) ? 0.f : X[a];
  });
  __syncthreads();
  col_pass<R, M + R>(T, [&](int i, int j, float p) {
    const int a = i * G::stride + j;
    const unsigned char f = F[a];
    if (!(f & SUPP) && X[a] == p && inside(i, j)) F[a] = f | KEEP;
  });
  __syncthreads();
}

template <int R>
__global__ void __launch_bounds__(THREADS)
nms_candidates_kernel(const float* __restrict__ scores,
                      float* __restrict__ out_v, int* __restrict__ out_i,
                      int H, int W, int border, int cap) {
  using G = Band<R>;
  extern __shared__ float smem[];
  float* X = smem;        // raw scores, -inf outside the image
  float* T = X + G::plane;  // row-pass maxima
  unsigned char* F = reinterpret_cast<unsigned char*>(T + G::plane);  // KEEP | SUPP

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * BAND_H, x0 = blockIdx.x * BAND_W;
  const int ry = y0 - 5 * R, rx = x0 - 5 * R;  // image coords of band (0, 0)
  const float* sb = scores + (size_t)b * H * W;
  auto inside = [&](int i, int j) {
    return (unsigned)(ry + i) < (unsigned)H && (unsigned)(rx + j) < (unsigned)W;
  };

  // every load of the band issued before any store, so a thread's reads
  // from L2 are all in flight at once; 16 bytes a load where the band's
  // first column falls on one (5r % 4 == 0: W % 8 == 0 puts a 4-column
  // group wholly inside or outside the image)
  constexpr int VEC = (5 * R) % 4 == 0 ? 4 : 1;
  constexpr int n = G::rows * G::cols / VEC;  // cols % 4 == 0 when VEC is 4
  constexpr int per_thread = (n + THREADS - 1) / THREADS;
  float ld[per_thread][VEC];
#pragma unroll
  for (int k = 0; k < per_thread; ++k) {
    const int e = threadIdx.x + k * THREADS;
    const int i = e / (G::cols / VEC), j = e % (G::cols / VEC) * VEC;
    const bool in = e < n && inside(i, j);
    const float* src = sb + (size_t)(ry + i) * W + rx + j;
    if constexpr (VEC == 4) {
      const float4 q = in ? __ldg(reinterpret_cast<const float4*>(src))
                          : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      ld[k][0] = q.x, ld[k][1] = q.y, ld[k][2] = q.z, ld[k][3] = q.w;
    } else {
      ld[k][0] = in ? __ldg(src) : -INFINITY;
    }
  }
#pragma unroll
  for (int k = 0; k < per_thread; ++k) {
    const int e = threadIdx.x + k * THREADS;
    const int i = e / (G::cols / VEC), j = e % (G::cols / VEC) * VEC;
    if (e < n)
#pragma unroll
      for (int c = 0; c < VEC; ++c) X[i * G::stride + j + c] = ld[k][c];
  }
  __syncthreads();

  // keep = local max (out to margin R); KEEP and SUPP are 0 outside the
  // image, so the padding never keeps, suppresses or lends a 0 to S
  row_pass<R, 0, R>(T, [&](int i, int j) { return X[i * G::stride + j]; });
  __syncthreads();
  col_pass<R, R>(T, [&](int i, int j, float p) {
    const int a = i * G::stride + j;
    F[a] = (X[a] == p && inside(i, j)) ? KEEP : 0;
  });
  __syncthreads();
  admit_round<R, 2 * R>(X, T, F, inside);
  admit_round<R, 4 * R>(X, T, F, inside);

  // the top `cap` of each 8x8 tile of the core: 8 lanes per tile, one row
  // each, so a warp takes four tiles at once; a round is a max over the
  // lane's 8 pixels, then over the 8 lanes (ties: the smaller flat index)
  const int lane = threadIdx.x % 32, row = lane % 8;
  const int tiles_h = H / 8, tiles_w = W / 8;
  for (int t = threadIdx.x / 8; t < (BAND_H / 8) * (BAND_W / 8); t += THREADS / 8) {
    const int ty = y0 / 8 + t / (BAND_W / 8), tx = x0 / 8 + t % (BAND_W / 8);
    const int gy = 8 * ty + row;
    const int a0 = (gy - ry) * G::stride + 8 * tx - rx;
    float v[8];
    int f[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int gx = 8 * tx + c;
      const bool framed = gy >= border && gy < H - border && gx >= border && gx < W - border;
      v[c] = framed ? ((F[a0 + c] & KEEP) ? X[a0 + c] : 0.f) : -1.f;
      f[c] = gy * W + gx;
    }
    // tiles past the image's edge (H, W % 8 == 0: whole tiles only) run the
    // rounds with the warp, on band values, and write nothing
    const bool live = ty < tiles_h && tx < tiles_w;
    const size_t base = ((size_t)b * tiles_h * tiles_w + (size_t)ty * tiles_w + tx) * cap;
    for (int r = 0; r < cap; ++r) {
      float bv = v[0];
      int bi = f[0];
#pragma unroll
      for (int c = 1; c < 8; ++c)  // f ascends along the row: > keeps the first tie
        if (v[c] > bv) {
          bv = v[c];
          bi = f[c];
        }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (live && row == 0) {
        out_v[base + r] = bv;
        out_i[base + r] = bi;
      }
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (f[c] == bi) v[c] = -INFINITY;
    }
  }
}

template <int R>
int launch(const void* scores, void* out_v, void* out_i, int B, int H, int W,
           int border, int cap, cudaStream_t stream) {
  constexpr int smem = Band<R>::smem;
  static bool opted_in = smem <= 48 * 1024;  // raised once per radius, not per launch
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_candidates_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid((W + BAND_W - 1) / BAND_W, (H + BAND_H - 1) / BAND_H, B);
  nms_candidates_kernel<R><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(scores), static_cast<float*>(out_v),
      static_cast<int*>(out_i), H, W, border, cap);
  return static_cast<int>(cudaGetLastError());
}

template <int R = 0>
int smem_bytes(int radius) {
  if constexpr (R > MAX_RADIUS) {
    return -1;
  } else {
    return radius == R ? Band<R>::smem : smem_bytes<R + 1>(radius);
  }
}

template <int R = 0>
int dispatch(int radius, const void* scores, void* out_v, void* out_i, int B, int H,
             int W, int border, int cap, cudaStream_t stream) {
  if constexpr (R > MAX_RADIUS) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (radius == R) return launch<R>(scores, out_v, out_i, B, H, W, border, cap, stream);
    return dispatch<R + 1>(radius, scores, out_v, out_i, B, H, W, border, cap, stream);
  }
}

}  // namespace

// Dynamic shared memory of one block at this radius, -1 for a radius the
// kernel is not built for; kernels/nms.py:nms_smem_bytes mirrors it.
extern "C" int lg_nms_smem_bytes(int radius) { return smem_bytes(radius); }

// scores: (B, H, W) fp32, H % 8 == 0, W % 8 == 0; 0 <= radius <= MAX_RADIUS.
// out_v / out_i: (B, (H/8)*(W/8)*cap) fp32 / int32.
extern "C" int lg_nms_candidates(const void* scores, void* out_v, void* out_i,
                                 int B, int H, int W, int radius, int border,
                                 int cap, void* stream) {
  return dispatch(radius, scores, out_v, out_i, B, H, W, border, cap,
                  static_cast<cudaStream_t>(stream));
}
