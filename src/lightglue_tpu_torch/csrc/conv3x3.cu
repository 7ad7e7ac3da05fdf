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
// 9 taps x C_in, fp32 bias, ReLU (when asked), the optional 2x2 max-pool in
// fp32, then ONE cast to the output type.
//
// Bound on the H100: at 2x480x640 the three 64-channel convs are ~68 GFLOP
// against ~0.2 GB of activations, so the tensor cores bound them (~0.07 ms
// at the bf16 peak); SuperPoint's C >= 128 shapes (conv3a..convDb, ~34
// GFLOP, 0.034 ms) are further above the ridge. Four kernels:
//
// conv3x3_mma_kernel, the model's bf16 calls (C_in = C_out = 64, ReLU, bf16
// out): an implicit GEMM on the tensor cores: M = a tile's output pixels,
// N = the 64 output channels, K = 9 taps x 64 input channels (36 k16 steps
// of mma.sync m16n8k16, bf16 in, fp32 sums).
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
// conv3x3_igemm_kernel, every other bf16-operand call (any C_in and C_out
// multiples of 8, ReLU on or off, pool on or off, bf16 or fp32 out): the
// same implicit GEMM and warp tile (2 tile rows x 64 channels, the m-tiles
// sharing each B fragment), but the weights do not stay resident (convDb,
// 256 -> 256, has 1.18 MB), so K streams:
// - A block owns `rows` x 16 output pixels x 64 output channels (rows / 2
//   warps). K runs in chunks of 16 input channels: a chunk is the haloed
//   (rows + 2) x 18 input tile's 16 channels and those channels' nine taps
//   of weights for the block's channels, 9 k16 steps; a two-stage cp.async
//   ring copies chunk c + 1 while chunk c computes (one barrier per chunk).
//   A chunk past C_in is zero-filled in both operands (C_in = 24 runs two
//   chunks, the second half zeros), as are weight columns past C_out, whose
//   fragments are never stored.
// - The plan (conv_rows; kernels/conv.py:conv_plan mirrors it): rows the
//   largest of 16, 8 and 4 whose grid has CONV_FILL = 264 blocks, two per
//   SM, so the small maps spread evenly: conv3a/conv3b (2x120x160) run 320
//   blocks of 16 rows, convDa/convDb (2x60x80) 320 of 8 rows. The
//   registers are held to 128 a thread so that two 256-thread blocks (72.6
//   KB of shared memory each) share an SM. scripts/tune_torch_convs.py
//   sweeps CONV_FILL, GSTAGES and that bound: one block an SM (166
//   registers) left a 160-block grid in two waves, and 128-channel tiles
//   (fewer, larger blocks) ran slower at every shape.
// - What bounds it: each block reads all of C_in's weights for its 64
//   channels from L2 (convDb: 295 KB a block, 94 MB over its 320 blocks)
//   beside the ldmatrix traffic (six ldmatrix.x4 per 16 mma in a warp), not
//   device memory.
// - Epilogue in registers: fp32 acc + fp32 bias, ReLU when asked, the pool
//   max across the thread's two rows and the lane 4 apart, one cast, 2-value
//   stores masked per pixel and per 8-channel column.
//
// conv3x3_tf32_wgmma_kernel, the model's fp32 calls (the MIXED and FP32
// rungs: C_in = C_out = 64, ReLU, fp32 out): the same implicit GEMM on
// Hopper's warpgroup MMA in 3xTF32. One TF32 product keeps 10 mantissa bits
// of each operand and misses the fp32 gate of 1e-4
// (tests/test_torch_conv_kernels.py measures it); each operand is split by
// truncation into hi (x with its low 13 bits cleared) and lo = x - hi, and
// hi.lo + lo.hi + hi.hi in fp32 keeps about fp32's precision at three
// wgmma m64n64k8 products (lo.lo dropped, the small terms first).
// - One block per 16x16 output tile of one image (a tile never spans two,
//   so an image's result does not depend on its batch) and all 64
//   channels: two warpgroups, each warp two tile rows of 16 pixels, one m64
//   product each (a warpgroup's product is four tile rows: warp w's 16
//   rows of the accumulator are the 16 pixels of its row).
// - A from registers: a warp's m16n8k8 tf32 A fragment of tap (dy, dx) is
//   read from the haloed tile at that offset and split as it loads, so no
//   im2col copy exists. B, the weights, from shared memory, K-major: wgmma
//   reads a tf32 operand in shared memory K-major only, and HWIO is
//   [tap][ci][co], N-major; so the block splits each chunk's raw weights
//   into hi and lo planes, each [co][k] in 128 B swizzle (three [64][32]
//   halves, four taps' 8 channels a half, a tap's k8 step 32 B along it:
//   hopper.cuh:desc_step_f32). No K-major copy exists in device memory, and
//   the converter, the .pth path and exported programs keep HWIO.
// - fp32 operands: all nine taps' weights (147 KB, and as much again for
//   their lo) and a haloed tile do not stay, so K streams in chunks of 8
//   input channels (one k8 step per tap) through a two-stage cp.async ring
//   of raw fp32 (the tile's 8 channels, a pixel's two 16 B units swapped on
//   every other run of four pixels so an A fragment's loads fall in 32
//   banks, and their 9 x 8 x 64 weights), zeros for the SAME padding and
//   past the image.
// - 107,776 B of shared memory and at most 128 registers a thread: two
//   blocks an SM, one splitting its weights while the other multiplies.
// - Epilogue in registers: fp32 acc + fp32 bias, ReLU, the pool max across
//   the thread's two rows (its two products) and the lane 4 apart, 2-value
//   fp32 stores masked per pixel (any H and W: 360x488 gives a 488-wide
//   conv1b).
// - What bounds it: the tensor cores at three TF32 products per MAC (3 x 68
//   GFLOP per pair at 495 TFLOP/s: 0.41 ms), below the fp32 FMA units'
//   1.01 ms for the same sums.
//
// conv3x3_tf32x3_generic_kernel, every other fp32-operand call (any C_in
// and C_out multiples of 8, ReLU on or off, pool on or off, fp32 or bf16
// out): the model's 3xTF32 design over conv3x3_igemm_kernel's generic tiles.
// - A block owns TF32_ROWS = 12 x 16 output pixels x 64 output channels
//   (six warps of two tile rows each; kernels/conv.py:conv_plan with the
//   fp32 dtype mirrors it): conv3a/conv3b run 400 blocks, convDa/convDb
//   200, two an SM. On an H100 (scripts/tune_torch_ln_gelu_conv.py, ms
//   over the four shapes) 12 rows took 0.76, 10 rows the same, 14 and 16
//   rows 0.88-0.91 (held to 128 registers a thread, they spill: 19 local
//   loads), and the bf16 kernel's rule (16 rows, 8 at convD) 1.07: 16-row blocks
//   leave a second wave a fifth full at conv3a and one block on most SMs at
//   convD, and a block splits the same weights per chunk whatever its
//   rows, which 8-row tiles repeat twice as often.
// - K streams in C_in / 8 chunks of 8 input channels (C_in = 24 runs three)
//   through the same two-stage cp.async ring of raw fp32 chunks; weight
//   columns past C_out are zero-filled in the stage and never stored
//   (C_out = 40 runs one 64-channel tile with 24 dead columns).
// - Every operand split by truncation (mma.cuh:split_tf32_rz, 1.15-1.4x
//   faster than the rounding split in the fp32 attention and linear
//   kernels; 0.84 ms over the four shapes with the rounding split): the
//   weights once per chunk into (hi, lo) pairs at the 68-pair pitch, the
//   activations as each A fragment loads.
// - Epilogue in registers: fp32 acc + fp32 bias, ReLU when asked, the pool
//   max across the thread's two rows and the lane 4 apart, one cast, 2-value
//   stores masked per pixel and per 8-channel column.
// - 100 KB of shared memory and at most 170 registers a thread (it takes
//   168): two blocks an SM. Unbounded (190 registers, one block an SM) it
//   ran 0.95 ms over the four shapes.
// - What bounds it: the tensor cores at three TF32 products per MAC (34
//   GFLOP over SuperPoint's four C >= 128 shapes: 0.206 ms). The FMA kernel
//   it replaces (an 8x16 tile per block, 16 input channels staged at a
//   time, 32 fp32 accumulators a thread) took 1.44 ms over those four shapes
//   on an NVIDIA H100 80GB HBM3 at 700 W, above the fp32 FMA units' 0.51
//   ms; this kernel 0.76 ms there, 27 % of its bound (PERF.md).

#include "hopper.cuh"

namespace {

constexpr int C = 64;  // the model convs' C_in and C_out

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


// ---------------------------------------------------------------------------
// Every other bf16-operand conv on the tensor cores: C_in, C_out multiples of 8
// ---------------------------------------------------------------------------

constexpr int GK = 16;          // input channels per K chunk: one k16 step per tap
constexpr int GPA = GK + 8;     // pixel pitch of a chunk's input tile (48 B: the eight
                                // rows of an ldmatrix fall in different banks)
constexpr int GW = 16;          // output tile width: an m16 fragment is one tile row
constexpr int GN = 64;          // output channels of a tile: one warp's eight n8 fragments
constexpr int GSTAGES = 2;      // K chunks in the cp.async ring
constexpr int CONV_FILL = 264;  // blocks a launch aims for: two per SM of an H100

// A launch's tile: rows x 16 output pixels x 64 output channels, a warp per
// 2 rows; rows the largest of 16, 8 and 4 whose grid has CONV_FILL blocks,
// else 4. kernels/conv.py:conv_plan mirrors it.
inline int conv_rows(int B, int H, int W, int Cout) {
  const long long per_row = (long long)B * ((W + GW - 1) / GW) * ((Cout + GN - 1) / GN);
  for (int rows = 16; rows > 4; rows /= 2)
    if (per_row * ((H + rows - 1) / rows) >= CONV_FILL) return rows;
  return 4;
}

// elements of one ring stage: the haloed input tile's chunk and its weights
__host__ __device__ constexpr int igemm_stage(int rows) {
  return (rows + 2) * (GW + 2) * GPA + 9 * GK * LD;
}

constexpr size_t igemm_smem(int rows) { return sizeof(bf16_t) * GSTAGES * igemm_stage(rows); }

// 128 registers a thread at most, so that two 256-thread blocks share an SM
// (unbounded, the compiler takes 166: one block an SM)
template <typename O, int ROWS>
__global__ void __launch_bounds__(ROWS / 2 * 32, 512 / (ROWS / 2 * 32))
conv3x3_igemm_kernel(const bf16_t* __restrict__ x, const bf16_t* __restrict__ w,
                     const float* __restrict__ bias, O* __restrict__ y, int B, int H, int W,
                     int Cin, int Cout, int pool, int relu) {
  constexpr int THREADS = ROWS / 2 * 32;
  constexpr int HW = GW + 2;              // haloed tile width
  constexpr int APIX = (ROWS + 2) * HW;   // haloed tile pixels
  constexpr int STAGE = igemm_stage(ROWS);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // GSTAGES x {[APIX][GPA] input chunk, [9 * GK][LD] its taps' weights}
  bf16_t* sm = reinterpret_cast<bf16_t*>(smem_raw);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;  // tile rows 2 warp + {0, 1}
  const int g = lane / 4, t4 = lane % 4;   // mma fragment row and column pair
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix matrix and row of this lane
  const int x0 = blockIdx.x * GW, y0 = blockIdx.y * ROWS;
  const int b = blockIdx.z % B, n0 = blockIdx.z / B * GN;
  const int chunks = (Cin + GK - 1) / GK;

  // chunk c into its ring stage: channels c * GK.. of the haloed tile and
  // their nine taps' weights for the block's channels; zeros outside the
  // image and past C_in or C_out
  auto stage = [&](int c) {
    bf16_t* as = sm + c % GSTAGES * STAGE;
    bf16_t* ws = as + APIX * GPA;
    const int c0 = c * GK;
    for (int s = tid; s < APIX * (GK / 8); s += THREADS) {
      const int p = s / (GK / 8), k8 = s % (GK / 8) * 8;
      const int gy = y0 - 1 + p / HW, gx = x0 - 1 + p % HW;
      bf16_t* d = as + p * GPA + k8;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + k8 < Cin)
        lg::cp_async16(d, x + (((size_t)b * H + gy) * W + gx) * Cin + c0 + k8);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
    for (int s = tid; s < 9 * GK * (GN / 8); s += THREADS) {
      const int r = s / (GN / 8), n8 = s % (GN / 8) * 8;  // r = tap * GK + channel in chunk
      const int ci = c0 + r % GK, co = n0 + n8;
      bf16_t* d = ws + r * LD + n8;
      if (ci < Cin && co < Cout)
        lg::cp_async16(d, w + ((size_t)(r / GK) * Cin + ci) * Cout + co);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  };

  // acc[m][n]: tile row 2 * warp + m, channels n0 + n * 8.., fp32 over 9 x C_in
  float acc[2][GN / 8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < GN / 8; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;

#pragma unroll
  for (int s = 0; s < GSTAGES - 1; ++s) {
    if (s < chunks) stage(s);
    lg::cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    lg::cp_async_wait<GSTAGES - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();                   // everyone's, and chunk c - 1's stage is read
    if (c + GSTAGES - 1 < chunks) stage(c + GSTAGES - 1);
    lg::cp_async_commit();
    const bf16_t* as = sm + c % GSTAGES * STAGE;
    const bf16_t* ws = as + APIX * GPA;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      unsigned a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)  // 16 pixels of a row, shifted by the tap
        lg::ldsm_x4(a[m], as + ((2 * warp + m + dy) * HW + mr + (mi & 1) * 8 + dx) * GPA +
                              (mi >> 1) * 8);
      const bf16_t* wk = ws + (tap * GK + mr + (mi & 1) * 8) * LD + (mi >> 1) * 8;
#pragma unroll
      for (int np = 0; np < GN / 16; ++np) {
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

  // fp32 bias, [ReLU,] [the pool max,] one cast. C_out % 8 == 0: an n8
  // fragment column is all inside C_out or all past it (then never stored)
  float bv[GN / 8][2];
#pragma unroll
  for (int n = 0; n < GN / 8; ++n) {
    const int co = n0 + n * 8 + 2 * t4;
    bv[n][0] = co < Cout ? __ldg(bias + co) : 0.f;
    bv[n][1] = co < Cout ? __ldg(bias + co + 1) : 0.f;
  }
  auto act = [&](float v) { return relu ? fmaxf(v, 0.f) : v; };
  if (pool) {
    const int Ho = H / 2, Wo = W / 2, oy = y0 / 2 + warp;
#pragma unroll
    for (int n = 0; n < GN / 8; ++n) {
      if (n0 + n * 8 >= Cout) break;  // the same for the whole warp
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // fragment rows g and g + 8
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          v[j] = fmaxf(act(acc[0][n][2 * i + j] + bv[n][j]), act(acc[1][n][2 * i + j] + bv[n][j]));
          v[j] = fmaxf(v[j], __shfl_xor_sync(0xffffffffu, v[j], 4));  // the column pair
        }
        const int ox = x0 / 2 + (g + 8 * i) / 2;
        if (!(g & 1) && oy < Ho && ox < Wo)
          lg::store2(y + (((size_t)b * Ho + oy) * Wo + ox) * Cout + n0 + n * 8 + 2 * t4, v[0],
                     v[1]);
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int gy = y0 + 2 * warp + m;
#pragma unroll
      for (int n = 0; n < GN / 8; ++n) {
        if (n0 + n * 8 >= Cout) break;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int gx = x0 + g + 8 * i;
          if (gy < H && gx < W)
            lg::store2(y + (((size_t)b * H + gy) * W + gx) * Cout + n0 + n * 8 + 2 * t4,
                       act(acc[m][n][2 * i] + bv[n][0]), act(acc[m][n][2 * i + 1] + bv[n][1]));
        }
      }
    }
  }
}

template <typename O, int ROWS>
int launch_igemm_tile(const void* x, const void* w, const void* bias, void* y, int B, int H,
                      int W, int Cin, int Cout, int pool, int relu, cudaStream_t stream) {
  constexpr size_t smem = igemm_smem(ROWS);
  // above 48 KB: opt in once per instantiation
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      conv3x3_igemm_kernel<O, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  dim3 grid((W + GW - 1) / GW, (H + ROWS - 1) / ROWS, B * ((Cout + GN - 1) / GN));
  conv3x3_igemm_kernel<O, ROWS><<<grid, ROWS / 2 * 32, smem, stream>>>(
      static_cast<const bf16_t*>(x), static_cast<const bf16_t*>(w),
      static_cast<const float*>(bias), static_cast<O*>(y), B, H, W, Cin, Cout, pool, relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename O>
int launch_igemm(const void* x, const void* w, const void* bias, void* y, int B, int H, int W,
                 int Cin, int Cout, int pool, int relu, cudaStream_t s) {
  // x and w are read 16 B at a time
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int rows = conv_rows(B, H, W, Cout);
  auto run = rows == 16 ? launch_igemm_tile<O, 16>
             : rows == 8 ? launch_igemm_tile<O, 8>
                         : launch_igemm_tile<O, 4>;
  return run(x, w, bias, y, B, H, W, Cin, Cout, pool, relu, s);
}

// ---------------------------------------------------------------------------
// The model's fp32 64 -> 64 ReLU conv on Hopper's warpgroup MMA: 3xTF32
// ---------------------------------------------------------------------------

constexpr int XK = 8;          // input channels per K chunk: one k8 step per tap
constexpr int XPA = XK + 4;    // the generic kernel's fp32 pixel pitch (48 B): the eight
                               // pixels of an A fragment column fall in different banks
constexpr int XPN = C + 4;     // the generic kernel's (hi, lo) pair pitch of the split
                               // weights (68 pairs): a half-warp's B pairs in different banks
constexpr int WT = 16;         // the wgmma conv's output tile side (pre-pool)
constexpr int WH = WT + 2;     // its haloed input tile side
constexpr int WTHREADS = 256;  // two warpgroups: tile rows 8 wg .. 8 wg + 7
constexpr int WPIX = WH * WH;
// floats of a raw ring stage: the haloed tile's 8 channels at 8 floats a
// pixel, then their nine taps' weights as copied ([9][8][64])
constexpr int WX = WPIX * XK;
constexpr int WSTAGE = WX + 9 * XK * C;
// floats of a split weight plane (hi or lo): three K-major [64 co][32] halves
// in 128 B swizzle, tap t's 8 channels at floats 8 (t % 4).. of half t / 4
constexpr int WPLANE = 3 * C * 32;
constexpr size_t WGMMA_CONV_SMEM = sizeof(float) * (2 * WPLANE + 2 * WSTAGE) + 1024;  // 107,776 B

// a pixel's two 16 B units (channels 0..3, 4..7) of a chunk's input tile,
// swapped on pixels p with p / 4 odd, so the eight pixels an A fragment
// column reads fall in 32 different banks: the float offset of channel ch
__device__ __forceinline__ int conv_px(int p, int ch) {
  return p * XK + ((ch / 4) ^ ((p >> 2) & 1)) * 4 + ch % 4;
}

// One block per 16x16 output tile and all 64 channels: two warpgroups, each
// warp two tile rows of 16 pixels (one m64 product each, rows 2 warp and 2
// warp + 1: a pool window's rows in one thread, its columns in lanes 4
// apart). K streams in chunks of 8 input channels through a two-stage
// cp.async ring of raw fp32 (the chunk's haloed tile and its nine taps'
// weights); the block splits each chunk's weights once into K-major hi and
// lo planes in wgmma's 128 B-swizzled layout (the B operand: B[ci][co] at
// row co), and each warp splits its A fragments in registers as they load
// from the haloed tile at the tap's offset (the register-A operand: rows
// are pixels, k the chunk's channels): per tap A_hi.B_lo, A_lo.B_hi,
// A_hi.B_hi on wgmma m64n64k8, fp32 sums. 128 registers a thread at most,
// so that two blocks (and their 107 KB of shared memory) share an SM.
__global__ void __launch_bounds__(WTHREADS, 2)
conv3x3_tf32_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ bias, float* __restrict__ y, int H, int W,
                          int pool) {
  extern __shared__ __align__(1024) unsigned char conv_raw[];
  float* const wh = reinterpret_cast<float*>(lg::align1024(conv_raw));  // hi plane
  float* const wl = wh + WPLANE;                                         // lo plane
  float* const raw = wl + WPLANE;                                        // [2][WSTAGE]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;  // tile rows 2 warp + {0, 1}
  const int g = lane / 4, t4 = lane % 4;  // fragment row and column
  const int x0 = blockIdx.x * WT, y0 = blockIdx.y * WT, b = blockIdx.z;
  constexpr int chunks = C / XK;

  // chunk c's raw stage: channels c * XK.. of the haloed tile (zeros outside
  // the image) and their nine taps' weights
  auto stage = [&](int c) {
    float* xs = raw + c % 2 * WSTAGE;
    float* wr = xs + WX;
    const int c0 = c * XK;
    for (int s = tid; s < WPIX * 2; s += WTHREADS) {
      const int p = s / 2, u = s % 2;
      const int gy = y0 - 1 + p / WH, gx = x0 - 1 + p % WH;
      float* d = xs + conv_px(p, 4 * u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        lg::cp_async16(d, x + (((size_t)b * H + gy) * W + gx) * C + c0 + 4 * u);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int s = tid; s < 9 * XK * (C / 4); s += WTHREADS) {
      const int r = s / (C / 4), n4 = s % (C / 4) * 4;  // r = tap * XK + channel in chunk
      lg::cp_async16(wr + r * C + n4, w + ((size_t)(r / XK) * C + c0 + r % XK) * C + n4);
    }
  };

  // acc[m]: tile row 2 * warp + m, the m64n64 accumulator (pixel g + 8 (e /
  // 2) % 2, channel 8 (e / 4) + 2 t4 + e % 2), fp32 over 9 x 64
  float acc[2][32];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[m][e] = 0.f;

  stage(0);
  lg::cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    lg::cp_async_wait<0>();  // this thread's copies of chunk c have landed
    __syncthreads();         // everyone's, and chunk c - 1's planes and stage are read
    if (c + 1 < chunks) stage(c + 1);
    lg::cp_async_commit();
    const float* xs = raw + c % 2 * WSTAGE;
    {  // the chunk's weights split into the planes: item (tap, 4-channel group, co)
      const float* wr = xs + WX;
      for (int s = tid; s < 9 * 2 * C; s += WTHREADS) {
        const int co = s % C, kg = s / C % 2, tap = s / (2 * C);
        unsigned h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) lg::split_tf32_rz(wr[(tap * XK + 4 * kg + e) * C + co], h[e], l[e]);
        const int unit = 2 * (tap % 4) + kg;  // 16 B unit of row co in half tap / 4
        const int at = tap / 4 * C * 32 + co * 32 + ((unit ^ (co % 8)) * 4);
        *reinterpret_cast<uint4*>(wh + at) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(wl + at) = make_uint4(l[0], l[1], l[2], l[3]);
      }
    }
    lg::fence_proxy_async();  // the planes, written by threads, visible to wgmma
    __syncthreads();
    const uint64_t dh = lg::opaque(lg::kmajor_desc(wh, 0));
    const uint64_t dl = lg::opaque(lg::kmajor_desc(wl, 0));
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {  // 16 pixels of a row, shifted by the tap
        const int p = (2 * warp + m + dy) * WH + dx + g;  // pixel g; pixel g + 8 is p + 8
        lg::split_tf32_rz(xs[conv_px(p, t4)], ah[m][0], al[m][0]);
        lg::split_tf32_rz(xs[conv_px(p + 8, t4)], ah[m][1], al[m][1]);
        lg::split_tf32_rz(xs[conv_px(p, t4 + 4)], ah[m][2], al[m][2]);
        lg::split_tf32_rz(xs[conv_px(p + 8, t4 + 4)], ah[m][3], al[m][3]);
      }
      const uint64_t bh = lg::desc_step_f32(dh, C, tap), bl = lg::desc_step_f32(dl, C, tap);
#pragma unroll
      for (int m = 0; m < 2; ++m) lg::fence_operand(acc[m]);
      lg::wgmma_fence();
#pragma unroll
      for (int m = 0; m < 2; ++m) lg::wgmma_tf32_m64n64_rs(acc[m], ah[m], bl, 1);
#pragma unroll
      for (int m = 0; m < 2; ++m) lg::wgmma_tf32_m64n64_rs(acc[m], al[m], bh, 1);
#pragma unroll
      for (int m = 0; m < 2; ++m) lg::wgmma_tf32_m64n64_rs(acc[m], ah[m], bh, 1);
      lg::wgmma_commit();
      lg::wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        lg::fence_operand(acc[m]);
        lg::fence_operand(ah[m]);
        lg::fence_operand(al[m]);
      }
    }
  }

  // fp32 bias, ReLU, [the pool max,] fp32 out, 2-value stores masked per pixel
  float bv[C / 8][2];
#pragma unroll
  for (int n = 0; n < C / 8; ++n) {
    bv[n][0] = __ldg(bias + n * 8 + 2 * t4);
    bv[n][1] = __ldg(bias + n * 8 + 2 * t4 + 1);
  }
  if (pool) {
    const int Ho = H / 2, Wo = W / 2, oy = y0 / 2 + warp;
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // pixels g and g + 8
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          v[j] = fmaxf(fmaxf(acc[0][4 * n + 2 * i + j] + bv[n][j], 0.f),
                       fmaxf(acc[1][4 * n + 2 * i + j] + bv[n][j], 0.f));
          v[j] = fmaxf(v[j], __shfl_xor_sync(0xffffffffu, v[j], 4));  // the column pair
        }
        const int ox = x0 / 2 + (g + 8 * i) / 2;
        if (!(g & 1) && oy < Ho && ox < Wo)
          lg::store2(y + (((size_t)b * Ho + oy) * Wo + ox) * C + n * 8 + 2 * t4, v[0], v[1]);
      }
  } else {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int gy = y0 + 2 * warp + m;
#pragma unroll
      for (int n = 0; n < C / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int gx = x0 + g + 8 * i;
          if (gy < H && gx < W)
            lg::store2(y + (((size_t)b * H + gy) * W + gx) * C + n * 8 + 2 * t4,
                       fmaxf(acc[m][4 * n + 2 * i] + bv[n][0], 0.f),
                       fmaxf(acc[m][4 * n + 2 * i + 1] + bv[n][1], 0.f));
        }
    }
  }
}

int launch_tf32_wgmma(const void* x, const void* w, const void* bias, void* y, int B, int H,
                      int W, int pool, cudaStream_t stream) {
  // x and w are read 16 B at a time
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  // above 48 KB: opt in once
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      conv3x3_tf32_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(WGMMA_CONV_SMEM));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  dim3 grid((W + WT - 1) / WT, (H + WT - 1) / WT, B);
  conv3x3_tf32_wgmma_kernel<<<grid, WTHREADS, WGMMA_CONV_SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), H, W, pool);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Every other fp32-operand conv in 3xTF32: C_in, C_out multiples of 8
// ---------------------------------------------------------------------------

constexpr int TF32_ROWS = 12;  // output rows of a generic 3xTF32 tile: 6 warps
constexpr int TF32_THREADS = TF32_ROWS / 2 * 32;
// floats of one raw ring stage of the generic 3xTF32 conv: the haloed
// (TF32_ROWS + 2) x 18 tile's 8 channels, their taps' weights
constexpr int TF32_STAGE = (TF32_ROWS + 2) * (GW + 2) * XPA + 9 * XK * GN;
constexpr size_t TF32_GENERIC_SMEM =
    sizeof(float) * 2 * TF32_STAGE + sizeof(float2) * 9 * XK * XPN;  // 100,224 B

// two blocks an SM: 170 registers a thread at most
template <typename O>
__global__ void __launch_bounds__(TF32_THREADS, 2)
conv3x3_tf32x3_generic_kernel(const float* __restrict__ x, const float* __restrict__ w,
                              const float* __restrict__ bias, O* __restrict__ y, int B, int H,
                              int W, int Cin, int Cout, int pool, int relu) {
  constexpr int ROWS = TF32_ROWS, THREADS = TF32_THREADS, STAGE = TF32_STAGE;
  constexpr int HW = GW + 2;             // haloed tile width
  constexpr int APIX = (ROWS + 2) * HW;  // haloed tile pixels
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [2] x {[APIX][XPA] input chunk, [9 * XK][GN] its taps' weights}, as copied
  float* raw = reinterpret_cast<float*>(smem_raw);
  // [9 * XK][XPN] (hi, lo) of the chunk's weights, split once for all warps
  float2* ws = reinterpret_cast<float2*>(raw + 2 * STAGE);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;  // tile rows 2 warp + {0, 1}
  const int g = lane / 4, t4 = lane % 4;  // mma fragment row and column
  const int x0 = blockIdx.x * GW, y0 = blockIdx.y * ROWS;
  const int b = blockIdx.z % B, n0 = blockIdx.z / B * GN;
  const int chunks = Cin / XK;

  // chunk c's raw stage: channels c * XK.. of the haloed tile (zeros outside
  // the image) and their nine taps' weights for the block's channels (zeros
  // past C_out)
  auto stage = [&](int c) {
    float* xs = raw + c % 2 * STAGE;
    float* wr = xs + APIX * XPA;
    const int c0 = c * XK;
    for (int s = tid; s < APIX * (XK / 4); s += THREADS) {
      const int p = s / (XK / 4), k4 = s % (XK / 4) * 4;
      const int gy = y0 - 1 + p / HW, gx = x0 - 1 + p % HW;
      float* d = xs + p * XPA + k4;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        lg::cp_async16(d, x + (((size_t)b * H + gy) * W + gx) * Cin + c0 + k4);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int s = tid; s < 9 * XK * (GN / 4); s += THREADS) {
      const int r = s / (GN / 4), n4 = s % (GN / 4) * 4;  // r = tap * XK + channel in chunk
      float* d = wr + r * GN + n4;
      if (n0 + n4 < Cout)
        lg::cp_async16(d, w + ((size_t)(r / XK) * Cin + c0 + r % XK) * Cout + n0 + n4);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  // acc[m][n]: tile row 2 * warp + m, channels n0 + n * 8.., fp32 over 9 x C_in
  float acc[2][GN / 8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < GN / 8; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;

  stage(0);
  lg::cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    lg::cp_async_wait<0>();  // this thread's copies of chunk c have landed
    __syncthreads();         // everyone's, and chunk c - 1 is no longer read
    if (c + 1 < chunks) stage(c + 1);
    lg::cp_async_commit();
    const float* xs = raw + c % 2 * STAGE;
    {  // split the chunk's weights into (hi, lo) pairs
      const float4* wr = reinterpret_cast<const float4*>(xs + APIX * XPA);
      for (int s = tid; s < 9 * XK * (GN / 4); s += THREADS) {
        const float4 v = wr[s];
        unsigned h[4], l[4];
        lg::split_tf32_rz(v.x, h[0], l[0]);
        lg::split_tf32_rz(v.y, h[1], l[1]);
        lg::split_tf32_rz(v.z, h[2], l[2]);
        lg::split_tf32_rz(v.w, h[3], l[3]);
        uint4* d = reinterpret_cast<uint4*>(ws + s / (GN / 4) * XPN + s % (GN / 4) * 4);
        d[0] = make_uint4(h[0], l[0], h[1], l[1]);
        d[1] = make_uint4(h[2], l[2], h[3], l[3]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {  // 16 pixels of a row, shifted by the tap
        const float* px = xs + ((2 * warp + m + dy) * HW + dx + g) * XPA + t4;
        lg::split_tf32_rz(px[0], ah[m][0], al[m][0]);            // pixel g, k t4
        lg::split_tf32_rz(px[8 * XPA], ah[m][1], al[m][1]);      // pixel g + 8
        lg::split_tf32_rz(px[4], ah[m][2], al[m][2]);            // k t4 + 4
        lg::split_tf32_rz(px[8 * XPA + 4], ah[m][3], al[m][3]);
      }
      const float2* wk = ws + (tap * XK + t4) * XPN + g;  // k t4, column g
#pragma unroll
      for (int n = 0; n < GN / 8; ++n) {
        const float2 w0 = wk[n * 8], w1 = wk[4 * XPN + n * 8];  // k t4 and t4 + 4
        const unsigned bh0 = __float_as_uint(w0.x), bl0 = __float_as_uint(w0.y);
        const unsigned bh1 = __float_as_uint(w1.x), bl1 = __float_as_uint(w1.y);
#pragma unroll
        for (int m = 0; m < 2; ++m) lg::mma_3xtf32(acc[m][n], ah[m], al[m], bh0, bl0, bh1, bl1);
      }
    }
  }

  // fp32 bias, [ReLU,] [the pool max,] one cast. C_out % 8 == 0: an n8
  // fragment column is all inside C_out or all past it (then never stored)
  float bv[GN / 8][2];
#pragma unroll
  for (int n = 0; n < GN / 8; ++n) {
    const int co = n0 + n * 8 + 2 * t4;
    bv[n][0] = co < Cout ? __ldg(bias + co) : 0.f;
    bv[n][1] = co < Cout ? __ldg(bias + co + 1) : 0.f;
  }
  auto act = [&](float v) { return relu ? fmaxf(v, 0.f) : v; };
  if (pool) {
    const int Ho = H / 2, Wo = W / 2, oy = y0 / 2 + warp;
#pragma unroll
    for (int n = 0; n < GN / 8; ++n) {
      if (n0 + n * 8 >= Cout) break;  // the same for the whole warp
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // fragment rows g and g + 8
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          v[j] = fmaxf(act(acc[0][n][2 * i + j] + bv[n][j]), act(acc[1][n][2 * i + j] + bv[n][j]));
          v[j] = fmaxf(v[j], __shfl_xor_sync(0xffffffffu, v[j], 4));  // the column pair
        }
        const int ox = x0 / 2 + (g + 8 * i) / 2;
        if (!(g & 1) && oy < Ho && ox < Wo)
          lg::store2(y + (((size_t)b * Ho + oy) * Wo + ox) * Cout + n0 + n * 8 + 2 * t4, v[0],
                     v[1]);
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int gy = y0 + 2 * warp + m;
#pragma unroll
      for (int n = 0; n < GN / 8; ++n) {
        if (n0 + n * 8 >= Cout) break;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int gx = x0 + g + 8 * i;
          if (gy < H && gx < W)
            lg::store2(y + (((size_t)b * H + gy) * W + gx) * Cout + n0 + n * 8 + 2 * t4,
                       act(acc[m][n][2 * i] + bv[n][0]), act(acc[m][n][2 * i + 1] + bv[n][1]));
        }
      }
    }
  }
}

template <typename O>
int launch_tf32x3_generic(const void* x, const void* w, const void* bias, void* y, int B, int H,
                          int W, int Cin, int Cout, int pool, int relu, cudaStream_t stream) {
  // x and w are read 16 B at a time
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  // above 48 KB: opt in once per instantiation
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      conv3x3_tf32x3_generic_kernel<O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(TF32_GENERIC_SMEM));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  dim3 grid((W + GW - 1) / GW, (H + TF32_ROWS - 1) / TF32_ROWS, B * ((Cout + GN - 1) / GN));
  conv3x3_tf32x3_generic_kernel<O><<<grid, TF32_THREADS, TF32_GENERIC_SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<O*>(y), B, H, W, Cin, Cout, pool, relu);
  return static_cast<int>(cudaGetLastError());
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
  const bool model = Cin == C && Cout == C && relu && bf16_out == bf16;  // the 64 -> 64 convs
  if (bf16) {
    if (model) return launch_mma(x, w, bias, y, B, H, W, pool, s);
    return (bf16_out ? launch_igemm<bf16_t> : launch_igemm<float>)(x, w, bias, y, B, H, W, Cin,
                                                                   Cout, pool, relu, s);
  }
  if (model) return launch_tf32_wgmma(x, w, bias, y, B, H, W, pool, s);
  return (bf16_out ? launch_tf32x3_generic<bf16_t> : launch_tf32x3_generic<float>)(
      x, w, bias, y, B, H, W, Cin, Cout, pool, relu, s);
}

// The model's fp32 conv's launch at (B, H, W): out = {tile rows, threads,
// blocks, dynamic shared memory in bytes} (kernels/conv.py:model_conv_plan
// mirrors it)
extern "C" int lg_conv_model_tile(int B, int H, int W, int* out) {
  out[0] = WT;
  out[1] = WTHREADS;
  out[2] = B * ((W + WT - 1) / WT) * ((H + WT - 1) / WT);
  out[3] = static_cast<int>(WGMMA_CONV_SMEM);
  return 0;
}

// A generic launch's tile at (B, H, W, Cout): bf16 operands
// (conv3x3_igemm_kernel at conv_rows' rows) or fp32
// (conv3x3_tf32x3_generic_kernel at TF32_ROWS): out = {rows, threads,
// blocks, dynamic shared memory in bytes}.
extern "C" int lg_conv_tile(int B, int H, int W, int Cout, int fp32, int* out) {
  const int rows = fp32 ? TF32_ROWS : conv_rows(B, H, W, Cout);
  out[0] = rows;
  out[1] = rows / 2 * 32;
  out[2] = B * ((W + GW - 1) / GW) * ((H + rows - 1) / rows) * ((Cout + GN - 1) / GN);
  out[3] = static_cast<int>(fp32 ? TF32_GENERIC_SMEM : igemm_smem(rows));
  return 0;
}
