// Tensor-core machinery shared by the port's kernels: the mma.sync kernels
// (conv3x3.cu's bf16 convs and generic fp32 conv, conv_chain.cu's conv2
// pair, linear.cu's W8A8 GEMM) and, for their common pieces, the wgmma
// kernels of hopper.cuh (flash_attn.cu, attention.cu and bidir_cross.cu
// through attention_tile.cuh, linear.cu, conv3x3.cu's model conv). No
// kernel of theirs is left on the FMA units.
//
// - 16-byte cp.async copies into shared memory;
// - ldmatrix (.trans for an operand stored [k][n], as the weights) and
//   mma.sync m16n8k16 with bf16 operands and fp32 sums; mma.sync m16n8k32
//   with s8 operands and s32 sums (linear.cu's W8A8 GEMM); mma.sync m16n8k8
//   with tf32 operands and the 3xTF32 split of an fp32 value by truncation
//   (split_tf32_rz: the generic fp32 conv, the fp32 chain; the split also
//   feeds the wgmma fp32 kernels, hopper.cuh);
// - rows padded to LD elements so the eight row addresses of an ldmatrix
//   fall in different banks; the quad reductions of an accumulator row;
//   packed bf16 rounding (pack_bf16) and 8-element loads and stores;
// - rope_kernel: half-split RoPE on q and k into a scratch of their type,
//   once per row instead of once in every block that reads a row.
#pragma once

#include "common.cuh"

namespace lg {

using bf16_t = __nv_bfloat16;

constexpr int HD = 64;      // head dim of the attention kernels
constexpr int WARPS = 4;    // warps of a four-warp block
constexpr int LD = HD + 8;  // bf16 row pitch in shared memory (144 B)

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

// every row start on 16 B: 16 B loads can read it (rope_kernel)
inline bool aligned16(const Operand& o) {
  return reinterpret_cast<uintptr_t>(o.ptr) % 16 == 0 && o.bs % 8 == 0 && o.hs % 8 == 0 &&
         o.rs % 8 == 0;
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

// d += a (16x32 s8, row) * b (32x8 s8, col), exact s32 sums (the W8A8
// GEMM of linear.cu). Fragments: a0/a2 hold row g, a1/a3 row g + 8, each
// four k values 4 t4..4 t4 + 3 (a2/a3: + 16); b0 holds k 4 t4..4 t4 + 3 of
// column g, b1 the same + 16; d as mma_bf16's (g = lane / 4, t4 = lane % 4).
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 3xTF32 split of x by truncation (CUTLASS's round-toward-zero "fast
// fp32"): hi = x with its low 13 bits cleared, lo = x - hi (exact), passed
// as it is, and hi * hi + hi * lo + lo * hi keeps about fp32's precision;
// mma.sync reads the top 19 bits of a .tf32 operand, so lo loses at most
// its low bits in the product, ~2^-21 of x (the rounding split's ~2^-23),
// for two integer/float instructions where each cvt.rna takes several
// (1.1-1.4x faster by shape in the mma.sync fp32 flash and linear kernels
// that flash_attn.cu's and linear.cu's wgmma kernels replaced)
__device__ __forceinline__ void split_tf32_rz(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a (16x8 tf32, row) * b (8x8 tf32, col), fp32 sums. Fragments (g =
// lane / 4, t4 = lane % 4): a0 (row g, k t4), a1 (g + 8, t4), a2 (g, t4 + 4),
// a3 (g + 8, t4 + 4); b0 (k t4, column g), b1 (k t4 + 4, g); d as
// mma_bf16's: d0, d1 row g, d2, d3 row g + 8, columns 2 t4 and 2 t4 + 1
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32 from split operands (a: ah, al; b: (bh0, bl0), (bh1,
// bl1)): hi*lo + lo*hi + hi*hi, the small terms first, lo*lo dropped
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const unsigned (&ah)[4],
                                           const unsigned (&al)[4], unsigned bh0, unsigned bl0,
                                           unsigned bh1, unsigned bl1) {
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bh0, bh1);
}

// two fp32 values rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// two adjacent outputs in the output type: bf16 rounded to nearest even, or fp32
__device__ __forceinline__ void store2(bf16_t* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}
__device__ __forceinline__ void store2(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// eight consecutive elements as fp32, 16 B loads where aligned; and back
__device__ __forceinline__ void load8(const bf16_t* p, float (&x)[8], bool aligned) {
  if (aligned) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const bf16_t* e = reinterpret_cast<const bf16_t*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = to_f(p[i]);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&x)[8], bool aligned) {
  if (aligned) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z,
    x[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = p[i];
  }
}
__device__ __forceinline__ void store8(bf16_t* p, const float (&x)[8]) {  // 16 B aligned
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                                            pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
}
__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {  // 16 B aligned
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

// RoPE on q and k (T = bf16 or fp32, (B, N, H*64) rows) into contiguous
// scratch (2, B, N, H*64) of T: the rotation of common.cuh:rope_pair, once
// per row, in place of once per row in every block that reads it. One
// thread per 8 pairs (x[d], x[d + 32]) of one head of one row, 16 B loads
// where the rows allow them; blockIdx.z picks q or k. Static: each
// including source has its own copy.
template <typename T>
static __global__ void __launch_bounds__(256)
rope_kernel(Operand q, Operand k, const float* __restrict__ freqs, T* __restrict__ out, int N,
            int H, int aligned) {
  constexpr int V = 8, G = HD / 2 / V;  // pairs per thread, threads per head row
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * H * G) return;
  const int d0 = i % G * V, h = i / G % H, n = i / G / H, b = blockIdx.y;
  const T* x = row_ptr<T>(blockIdx.z ? k : q, b, h, n);
  float x1[V], x2[V];
  load8(x + d0, x1, aligned);
  load8(x + d0 + HD / 2, x2, aligned);
#pragma unroll
  for (int e = 0; e < V; ++e)
    rope_pair<T, HD>(x1[e], x2[e], d0 + e, n, freqs + (size_t)b * 2 * N * HD, N);
  T* y = out + (((size_t)blockIdx.z * gridDim.y + b) * N + n) * H * HD + h * HD + d0;
  store8(y, x1);
  store8(y + HD / 2, x2);
}

// q and k rotated into rot (2, B, N, H*64) of their type T with freqs (B,
// 2, N, 64) fp32
template <typename T>
static inline cudaError_t rope_qk(const Operand& q, const Operand& k, const float* freqs, T* rot,
                                  int B, int N, int H, cudaStream_t s) {
  const int threads = N * H * (HD / 16);
  rope_kernel<T><<<dim3((threads + 255) / 256, B, 2), 256, 0, s>>>(
      q, k, freqs, rot, N, H, aligned16(q) && aligned16(k));
  return cudaGetLastError();
}

}  // namespace lg
