// Tensor-core machinery shared by the port's bf16 kernels: flash_attn.cu
// (fused_mha, flash_attention, the ring step), attention.cu (the layer
// stack's attention) and linear.cu (the stack's projections).
//
// - 16-byte cp.async staging into shared memory (stage_rows for the
//   attention operands: rows of one head addressed by batch, head and row
//   strides, zero-filled past the valid rows, element loads where a row
//   does not start on 16 B);
// - ldmatrix (.trans for an operand stored [k][n], as V and the weights)
//   and mma.sync m16n8k16 with bf16 operands and fp32 sums;
// - the attention block layout: WARPS warps, 16-row groups, C warps of a
//   group splitting each 64-key chunk, rows padded to LD elements so the
//   eight row addresses of an ldmatrix fall in different banks; the launch
//   rule that picks the groups per block (kernels/layer_stack.py:
//   fill_row_groups mirrors it);
// - rope_kernel: half-split RoPE on q and k into a bf16 scratch, once per
//   row instead of once in every block that reads a row.
#pragma once

#include "common.cuh"

namespace lg {

using bf16_t = __nv_bfloat16;

constexpr int HD = 64;          // head dim of the attention kernels
constexpr int KC = 64;          // keys per staged chunk
constexpr int WARPS = 4;        // warps of an attention block
constexpr int LD = HD + 8;      // bf16 row pitch in shared memory (144 B)
constexpr int RS = 2 + HD + 8;  // fp32 record per warp row: max, sum p, pv[HD] (+ pad)
constexpr int FILL_BLOCKS = 256;  // blocks a launch aims for: about two per SM

// Rows of (B, H, N, HD) heads, or of a (B, N, H*HD) activation with hs = HD,
// addressed by strides in elements.
struct Operand {
  const void* ptr;
  long long bs, hs, rs;  // batch, head and row strides
};

template <typename T>
__device__ __forceinline__ const T* row_ptr(const Operand& o, int b, int h, int row) {
  return static_cast<const T*>(o.ptr) + b * o.bs + h * o.hs + (long long)row * o.rs;
}

// every row start on 16 B: cp.async can stage it
inline bool aligned16(const Operand& o) {
  return reinterpret_cast<uintptr_t>(o.ptr) % 16 == 0 && o.bs % 8 == 0 && o.hs % 8 == 0 &&
         o.rs % 8 == 0;
}

// dynamic shared memory of an attention block at column split C with
// `stages` K and V chunk buffers: Q, the chunks and, with C > 1, the
// warps' partial row max, sum p and P.V
constexpr size_t mma_smem(int C, int stages) {
  return sizeof(bf16_t) * (size_t)(16 * (WARPS / C) + 2 * KC * stages) * LD +
         (C > 1 ? sizeof(float) * WARPS * 16 * RS : 0);
}

// 16-row groups per block (4, 2 or 1): the most that still give
// FILL_BLOCKS blocks, else 1 (the block's warps then split each chunk's keys
// 4 / groups ways)
inline int fill_row_groups(int B, int H, int Nq) {
  for (int groups = 4; groups > 1; groups /= 2)
    if ((long long)B * H * ((Nq + 16 * groups - 1) / (16 * groups)) >= FILL_BLOCKS) return groups;
  return 1;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n of this thread's copy groups are in flight (n >= 8
// waits for all but 7, which is more than asked and so safe)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix i / 8
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows [0, rows) of a tile of pitch LD from global rows row0 + r; rows at or
// past nrows are zeroed. aligned: 16 B cp.async per thread (the caller
// commits), else element loads (any strides).
__device__ __forceinline__ void stage_rows(bf16_t* dst, const Operand& o, int b, int h, int row0,
                                           int rows, int nrows, bool aligned) {
  for (int s = threadIdx.x; s < rows * (HD / 8); s += blockDim.x) {
    const int r = s / (HD / 8), c = s % (HD / 8) * 8;
    bf16_t* d = dst + r * LD + c;
    if (r >= nrows) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const bf16_t* src = row_ptr<bf16_t>(o, b, h, row0 + r) + c;
    if (aligned) {
      cp_async16(d, src);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = src[e];
    }
  }
}

// RoPE on q and k (bf16, (B, N, H*64) rows) into contiguous scratch
// (2, B, N, H*64): the rotation of common.cuh:rope_pair, once per row, in
// place of once per row in every block that reads it. One thread per 8
// pairs (x[d], x[d + 32]) of one head of one row, 16 B loads where the rows
// allow them; blockIdx.z picks q or k. Static: each including source has
// its own copy.
static __global__ void __launch_bounds__(256)
rope_kernel(Operand q, Operand k, const float* __restrict__ freqs, bf16_t* __restrict__ out,
            int N, int H, int aligned) {
  constexpr int V = 8, G = HD / 2 / V;  // pairs per thread, threads per head row
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * H * G) return;
  const int d0 = i % G * V, h = i / G % H, n = i / G / H, b = blockIdx.y;
  const bf16_t* x = row_ptr<bf16_t>(blockIdx.z ? k : q, b, h, n);
  float x1[V], x2[V];
  if (aligned) {
    const uint4 u1 = *reinterpret_cast<const uint4*>(x + d0);
    const uint4 u2 = *reinterpret_cast<const uint4*>(x + d0 + HD / 2);
    const bf16_t* e1 = reinterpret_cast<const bf16_t*>(&u1);
    const bf16_t* e2 = reinterpret_cast<const bf16_t*>(&u2);
#pragma unroll
    for (int e = 0; e < V; ++e) x1[e] = to_f(e1[e]), x2[e] = to_f(e2[e]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) x1[e] = to_f(x[d0 + e]), x2[e] = to_f(x[d0 + e + HD / 2]);
  }
  uint4 o1, o2;
  bf16_t* y1 = reinterpret_cast<bf16_t*>(&o1);
  bf16_t* y2 = reinterpret_cast<bf16_t*>(&o2);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    rope_pair<bf16_t, HD>(x1[e], x2[e], d0 + e, n, freqs + (size_t)b * 2 * N * HD, N);
    y1[e] = __float2bfloat16(x1[e]);
    y2[e] = __float2bfloat16(x2[e]);
  }
  bf16_t* y = out + (((size_t)blockIdx.z * gridDim.y + b) * N + n) * H * HD + h * HD + d0;
  *reinterpret_cast<uint4*>(y) = o1;
  *reinterpret_cast<uint4*>(y + HD / 2) = o2;
}

// q and k rotated into rot (2, B, N, H*64) with freqs (B, 2, N, 64) fp32
static inline cudaError_t rope_qk(const Operand& q, const Operand& k, const float* freqs, bf16_t* rot,
                           int B, int N, int H, cudaStream_t s) {
  const int threads = N * H * (HD / 16);
  rope_kernel<<<dim3((threads + 255) / 256, B, 2), 256, 0, s>>>(q, k, freqs, rot, N, H,
                                                                aligned16(q) && aligned16(k));
  return cudaGetLastError();
}

}  // namespace lg
