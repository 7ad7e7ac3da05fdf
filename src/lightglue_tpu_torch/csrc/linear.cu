// Y = [A | A2] . W + b (+ R): the projections of the LightGlue layer stack.
//
// Replaces the matrix products inside the TPU kernel
// lightglue_tpu/kernels/layer_stack.py:transformer_stack (wrapper :801,
// pallas_call :894): _linear (:357-375) for the fused qkv, the out
// projections, ffn1 over cat(x, message) (:386-388, taken here as two A
// operands so the concat is never materialised) and ffn2 with its residual
// add (:399). Rounding follows the reference exactly: the fp32 accumulator
// is cast to T, the bias is added in T, and the residual is added in T
// (JAX _linear's .astype(dt) + b.astype(dt), and xin + _linear(...)).
//
// Bound on the H100: at M = 1024 rows, K <= 512 and N <= 768 a product is
// 0.13-0.54 GFLOP on 1.2-2.6 MB, so it sits near the ridge; per call the
// bytes bound it (0.35-0.78 us at 3.35 TB/s) and the bf16 tensor-core peak
// nearly so (0.14-0.54 us).
//
// The BF16 kernel (linear_mma_kernel) is a pipelined mma.sync GEMM:
// - mma.sync m16n8k16, bf16 in, fp32 accumulators in registers; 4 warps
//   in a 2 x 2 layout over a BM x BN tile, each warp (BM / 2) x (BN / 2).
// - K runs in chunks of 64 staged with 16 B cp.async into a ring of 3
//   buffers, so two chunks' copies are in flight while one is multiplied.
//   A is read with ldmatrix, W (stored K x N, row-major) with
//   ldmatrix.trans, the way flash_attn.cu reads V (mma.cuh). Rows are
//   padded by 8 elements so an ldmatrix's eight rows fall in different banks.
// - ffn1's second operand: a 16 B segment at column c reads A at c < k1
//   and A2 at c - k1 past it (k1 % 8 == 0), so the concat is never
//   materialised; with K1 = 256 every chunk comes from one source.
// - The tile per shape (linear_tile below; kernels/layer_stack.py:
//   linear_plan mirrors it): 64 x 64 where that gives 256 blocks (two per
//   SM, so one block's loads overlap another's products), else 64 x 32,
//   else 32 x 32. At M = 1024 qkv, ffn1 and qk_v take 64 x 32 and the out
//   and ffn2 projections (N = 256) 32 x 32, 256-384 blocks where one 64 x
//   64 tile per block gave 64-192. BM divides 64, so a tile never straddles
//   two pairs. The chunk depth, ring and block target are the fastest of
//   eight variants timed at the main path's shapes (PERF.md, PR 6).
// - The epilogue is the reference's: round acc to T, add the bias in T and
//   round, add the residual in T and round.
// - Operands whose rows do not start on 16 B (any pointer or width off a
//   multiple of 8 elements) are staged by element loads.
// No split-K: every output's sum runs in one order, the same in every run.
//
// The FP32 kernel (linear_kernel, the fp32 rung) stays on the FMA units: a
// 64x64 shared-memory tile with 4x4 fp32 accumulators per thread (one TF32
// mma would miss the 1e-4 gate of the fp32 rung).
//
// Liveness (transformer_stack_adaptive, wrapper :974, pallas_call :1229):
// with an exit register (B,) fp32 and the global layer g, a tile whose pair
// has exit <= g (rows_per_pair % 64 == 0 and BM divides 64, so a tile holds
// one pair) skips the product, the pl.when(live) gate of :734-745. With a
// residual (ffn2) it writes y = R, so a retired pair's activations pass
// through the layer bit for bit; without one its rows are left unwritten
// and never read.

#include "mma.cuh"

namespace {

using namespace lg;  // the tensor-core helpers (mma.cuh)

// ---------------------------------------------------------------------------
// The FP32 kernel: products on the FMA units
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
linear_kernel(const T* __restrict__ a, const T* __restrict__ a2, int k1,
              const T* __restrict__ w, const T* __restrict__ bias,
              const T* __restrict__ res, T* __restrict__ y, int M, int N,
              int K, const float* __restrict__ exit_reg, int layer,
              int rows_per_pair) {
  __shared__ __align__(16) float as[BK][BM];  // A tile, transposed
  __shared__ __align__(16) float bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k2 = K - k1;  // width of the second A operand (0 without one)
  if (exit_reg && !(exit_reg[m0 / rows_per_pair] > static_cast<float>(layer))) {
    if (res) {
      for (int i = tid; i < BM * BN; i += THREADS) {
        const int gm = m0 + i / BN, gn = n0 + i % BN;
        if (gm < M) y[(size_t)gm * N + gn] = res[(size_t)gm * N + gn];
      }
    }
    return;
  }

  float acc[4][4] = {};
  for (int kk = 0; kk < K; kk += BK) {
    // A tile: 64 rows x 16 cols, 4 elements per thread
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = tid + q * THREADS;
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = kk + c;
      float v = 0.f;
      if (gm < M)
        v = gk < k1 ? lg::to_f(a[(size_t)gm * k1 + gk])
                    : lg::to_f(a2[(size_t)gm * k2 + gk - k1]);
      as[c][r] = v;
    }
    // W tile: 16 rows x 64 cols (N % 64 == 0, K % 16 == 0)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = tid + q * THREADS;
      const int r = i / BN, c = i % BN;
      bs[r][c] = lg::to_f(w[(size_t)(kk + r) * N + n0 + c]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      float v = lg::round_to<T>(acc[i][j]);
      v = lg::round_to<T>(v + lg::to_f(bias[gn]));
      if (res) v = lg::round_to<T>(v + lg::to_f(res[(size_t)gm * N + gn]));
      y[(size_t)gm * N + gn] = lg::from_f<T>(v);
    }
  }
}

// ---------------------------------------------------------------------------
// The BF16 kernel: a pipelined mma.sync GEMM
// ---------------------------------------------------------------------------

constexpr int MMA_BK = 64;       // K depth of a staged chunk
constexpr int MMA_STAGES = 3;    // chunk buffers in the ring
constexpr int MMA_THREADS = 128; // 4 warps, 2 x 2 over the tile
constexpr int MIN_BLOCKS = 256;  // blocks a tile plan aims for: about two per SM

template <int TM, int TN>
__global__ void __launch_bounds__(MMA_THREADS)
linear_mma_kernel(const bf16_t* __restrict__ a, const bf16_t* __restrict__ a2, int k1,
                  const bf16_t* __restrict__ w, const bf16_t* __restrict__ bias,
                  const bf16_t* __restrict__ res, bf16_t* __restrict__ y, int M, int N, int K,
                  const float* __restrict__ exit_reg, int layer, int rows_per_pair,
                  int aligned) {
  constexpr int AP = MMA_BK + 8;  // A row pitch in shared memory (144 B)
  constexpr int WP = TN + 8;      // W row pitch
  constexpr int MT = TM / 32;     // m16 tiles per warp
  constexpr int NT = TN / 16;     // n8 tiles per warp
  constexpr int SA = MMA_BK / 8;  // 16 B segments of an A chunk row
  constexpr int SW = TN / 8;      // 16 B segments of a W chunk row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* const as = reinterpret_cast<bf16_t*>(smem_raw);  // slot s: as + s * TM * AP
  bf16_t* const ws = as + MMA_STAGES * TM * AP;             // slot s: ws + s * MMA_BK * WP

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;   // this warp's quarter of the tile
  const int g = lane / 4, t4 = lane % 4;    // mma fragment row and column pair
  const int mi = lane / 8, mr = lane % 8;   // ldmatrix matrix and row of this lane
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int k2 = K - k1;  // width of the second A operand (0 without one)
  if (exit_reg && !(exit_reg[m0 / rows_per_pair] > static_cast<float>(layer))) {
    if (res) {
      for (int i = tid; i < TM * TN; i += MMA_THREADS) {
        const int gm = m0 + i / TN, gn = n0 + i % TN;
        if (gm < M) y[(size_t)gm * N + gn] = res[(size_t)gm * N + gn];
      }
    }
    return;
  }

  // chunk kt of A (TM x 32, from a or a2) and W (32 x TN) into slot kt % 3;
  // rows past M and columns past K are zero
  auto fetch = [&](int kt) {
    const int kc = kt * MMA_BK, slot = kt % MMA_STAGES;
    for (int s = tid; s < TM * SA; s += MMA_THREADS) {
      const int r = s / SA, c = kc + s % SA * 8, gm = m0 + r;
      bf16_t* d = as + slot * TM * AP + r * AP + s % SA * 8;
      if (gm >= M || c >= K) {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      } else if (aligned) {
        cp_async16(d, c < k1 ? a + (size_t)gm * k1 + c : a2 + (size_t)gm * k2 + c - k1);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int col = c + e;
          d[e] = col < k1 ? a[(size_t)gm * k1 + col]
                          : col < K ? a2[(size_t)gm * k2 + col - k1] : __float2bfloat16(0.f);
        }
      }
    }
    for (int s = tid; s < MMA_BK * SW; s += MMA_THREADS) {
      const int r = s / SW, c = s % SW * 8, gk = kc + r;
      bf16_t* d = ws + slot * MMA_BK * WP + r * WP + c;
      if (gk >= K) {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      } else if (aligned) {
        cp_async16(d, w + (size_t)gk * N + n0 + c);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = w[(size_t)gk * N + n0 + c + e];
      }
    }
    cp_async_commit();
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int nk = (K + MMA_BK - 1) / MMA_BK;
#pragma unroll
  for (int kt = 0; kt < MMA_STAGES - 1; ++kt) {
    if (kt < nk)
      fetch(kt);
    else
      cp_async_commit();  // an empty group keeps the wait count uniform
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<MMA_STAGES - 2>();  // chunk kt has landed
    __syncthreads();                  // ... for every thread, and chunk kt - 1 is done
    if (kt + MMA_STAGES - 1 < nk)
      fetch(kt + MMA_STAGES - 1);  // into the slot of chunk kt - 1
    else
      cp_async_commit();
    const bf16_t* at = as + (kt % MMA_STAGES) * TM * AP + wm * (TM / 2) * AP;
    const bf16_t* wt = ws + (kt % MMA_STAGES) * MMA_BK * WP + wn * (TN / 2);
#pragma unroll
    for (int ks = 0; ks < MMA_BK / 16; ++ks) {
      unsigned af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(af[mt], at + (mt * 16 + mr + (mi & 1) * 8) * AP + ks * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned r[4];
        ldsm_x4_trans(r, wt + (ks * 16 + mr + (mi & 1) * 8) * WP + np * 16 + (mi >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], r[0], r[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], r[2], r[3]);
        }
      }
    }
  }

  // epilogue: round acc to T, + bias in T, + residual in T
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gm = m0 + wm * (TM / 2) + mt * 16 + g + 8 * i;
      if (gm >= M) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int gn = n0 + wn * (TN / 2) + nt * 8 + 2 * t4;
        float v0 = round_to<bf16_t>(acc[mt][nt][2 * i]);
        float v1 = round_to<bf16_t>(acc[mt][nt][2 * i + 1]);
        v0 = round_to<bf16_t>(v0 + to_f(bias[gn]));
        v1 = round_to<bf16_t>(v1 + to_f(bias[gn + 1]));
        if (res) {
          v0 = round_to<bf16_t>(v0 + to_f(res[(size_t)gm * N + gn]));
          v1 = round_to<bf16_t>(v1 + to_f(res[(size_t)gm * N + gn + 1]));
        }
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)gm * N + gn) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// The bf16 kernel's tile (rows, columns) for an M x N product: 64 x 64 where
// that gives MIN_BLOCKS blocks, else 64 x 32, else 32 x 32
// (kernels/layer_stack.py:linear_plan mirrors it)
void linear_tile(int M, int N, int* tm, int* tn) {
  const int tiles[3][2] = {{64, 64}, {64, 32}, {32, 32}};
  for (const auto& t : tiles) {
    *tm = t[0], *tn = t[1];
    if ((long long)((M + t[0] - 1) / t[0]) * (N / t[1]) >= MIN_BLOCKS) return;
  }
}

// the ring of one block: MMA_STAGES chunks of A and W
constexpr size_t ring_smem(int TM, int TN) {
  return sizeof(bf16_t) * MMA_STAGES * (TM * (MMA_BK + 8) + MMA_BK * (TN + 8));
}

template <int TM, int TN>
int launch_mma(const void* a, const void* a2, int k1, const void* w, const void* bias,
               const void* res, void* y, int M, int N, int K, const void* exit_reg, int layer,
               int rows_per_pair, int aligned, cudaStream_t stream) {
  constexpr size_t smem = ring_smem(TM, TN);
  static bool opted_in = smem <= 48 * 1024;  // raised once, not per launch
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        linear_mma_kernel<TM, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  dim3 grid(N / TN, (M + TM - 1) / TM);
  linear_mma_kernel<TM, TN><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16_t*>(a), static_cast<const bf16_t*>(a2), k1,
      static_cast<const bf16_t*>(w), static_cast<const bf16_t*>(bias),
      static_cast<const bf16_t*>(res), static_cast<bf16_t*>(y), M, N, K,
      static_cast<const float*>(exit_reg), layer, rows_per_pair, aligned);
  return static_cast<int>(cudaGetLastError());
}

bool on16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// a: (M, k1) T; a2: (M, K - k1) T or null with k1 == K; w: (K, N) T;
// bias: (N,) T; res: (M, N) T or null; y: (M, N) T. N % 64 == 0, K % 16 == 0.
// exit_reg: (B,) fp32 or null; layer: the global layer index; the rows of
// pair b are [b * rows_per_pair, (b + 1) * rows_per_pair). bf16 operands
// run linear_mma_kernel at linear_tile's tile, fp32 operands the FMA kernel.
extern "C" int lg_linear(const void* a, const void* a2, int k1, const void* w,
                         const void* bias, const void* res, void* y, int M,
                         int N, int K, const void* exit_reg, int layer,
                         int rows_per_pair, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) {
    dim3 grid(N / BN, (M + BM - 1) / BM);
    linear_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(a2), k1,
        static_cast<const float*>(w), static_cast<const float*>(bias),
        static_cast<const float*>(res), static_cast<float*>(y), M, N, K,
        static_cast<const float*>(exit_reg), layer, rows_per_pair);
    return static_cast<int>(cudaGetLastError());
  }
  const int aligned = on16(a) && on16(a2) && on16(w) && k1 % 8 == 0 && (K - k1) % 8 == 0;
  int tm, tn;
  linear_tile(M, N, &tm, &tn);
  auto run = tm == 64 ? (tn == 64 ? launch_mma<64, 64> : launch_mma<64, 32>) : launch_mma<32, 32>;
  return run(a, a2, k1, w, bias, res, y, M, N, K, exit_reg, layer, rows_per_pair, aligned, s);
}

// The bf16 kernel's tile at this shape, (rows, columns) into tile[0..1]
// (the wrapper's plan is held against it).
extern "C" int lg_linear_tile(int M, int N, int* tile) {
  linear_tile(M, N, &tile[0], &tile[1]);
  return 0;
}
