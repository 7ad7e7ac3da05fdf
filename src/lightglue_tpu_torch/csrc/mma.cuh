// Tensor-core machinery shared by the port's kernels, each with a bf16
// kernel and, in 3xTF32, an fp32 one: flash_attn.cu (fused_mha,
// flash_attention, the ring step), attention.cu (the layer stack's
// attention), linear.cu (the stack's projections), bidir_cross.cu (both
// cross directions), conv3x3.cu (SuperPoint's 64 -> 64 convs and the
// generic conv) and conv_chain.cu (the conv2 pair in one launch). No
// kernel of theirs is left on the FMA units.
//
// - 16-byte cp.async staging into shared memory (stage_rows for the
//   attention operands: rows of one head addressed by batch, head and row
//   strides, zero-filled past the valid rows, element loads where a row
//   does not start on 16 B; bf16 rows at pitch LD, fp32 rows at FP);
// - ldmatrix (.trans for an operand stored [k][n], as V and the weights)
//   and mma.sync m16n8k16 with bf16 operands and fp32 sums; mma.sync
//   m16n8k32 with s8 operands and s32 sums (linear.cu's W8A8 GEMM);
//   mma.sync m16n8k8 with tf32 operands and the 3xTF32 split of an fp32
//   value by truncation (split_tf32_rz: the generic fp32 conv, the fp32
//   chain, bidir_cross.cu's fp32 kernel; the split also feeds the wgmma
//   fp32 kernels of flash_attn.cu, linear.cu, attention.cu and conv3x3.cu's
//   model conv, hopper.cuh);
// - the 3xTF32 attention block of bidir_cross.cu's fp32 kernel: Q split
//   once into fragments (tf32_q_frags), S over a chunk (tf32_scores), P.V
//   from the S accumulator (tf32_pv), the split warps' meeting in shared
//   memory (meet_max, meet_sums);
// - the attention block layout: WARPS warps, 16-row groups, C warps of a
//   group splitting each 64-key chunk, rows padded to LD elements so the
//   eight row addresses of an ldmatrix fall in different banks; the launch
//   rule that picks the groups per block from one pair's shape
//   (kernels/layer_stack.py:fill_row_groups mirrors it);
// - rope_kernel: half-split RoPE on q and k into a scratch of their type,
//   once per row instead of once in every block that reads a row.
#pragma once

#include "common.cuh"

namespace lg {

using bf16_t = __nv_bfloat16;

constexpr int HD = 64;          // head dim of the attention kernels
constexpr int KC = 64;          // keys per staged chunk
constexpr int WARPS = 4;        // warps of an attention block
constexpr int LD = HD + 8;      // bf16 row pitch in shared memory (144 B)
constexpr int RS = 2 + HD + 8;  // fp32 record per warp row: max, sum p, pv[HD] (+ pad)
// fp32 row pitch in shared memory (68 floats, 272 B): the 32-bit tf32
// fragment loads of a warp fall in 32 different banks, both a K fragment's
// (key g, dim t4: 4 g + t4) and a V fragment's (key 2 t4, dim g: 8 t4 + g)
constexpr int FP = HD + 4;
constexpr int TF32_STAGES = 2;  // K and V chunk buffers of an fp32 attention block
constexpr int FILL_BLOCKS = 256;  // blocks one pair's launch aims for: about two per SM

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

// dynamic shared memory of an attention block of G 16-row groups (G * C
// warps; 0: WARPS / C) at column split C with `stages` K and V chunk
// buffers: Q, the chunks and, with C > 1, the warps' partial row max, sum p
// and P.V
constexpr size_t mma_smem(int C, int stages, int G = 0) {
  const int groups = G ? G : WARPS / C;
  return sizeof(bf16_t) * (size_t)(16 * groups + 2 * KC * stages) * LD +
         (C > 1 ? sizeof(float) * groups * C * 16 * RS : 0);
}

// the same for the fp32 (3xTF32) attention block of G 16-row groups (G * C
// warps; 0: WARPS / C): fp32 Q and chunks at pitch FP
// (kernels/layer_stack.py:tf32_smem mirrors it for bidir_cross.cu's fp32 plan)
constexpr size_t tf32_smem(int C, int stages, int G = 0) {
  const int groups = G ? G : WARPS / C;
  return sizeof(float) * (size_t)(16 * groups + 2 * KC * stages) * FP +
         (C > 1 ? sizeof(float) * groups * C * 16 * RS : 0);
}

// 16-row groups per block (4, 2 or 1) of a WARPS-warp block: the most that
// still give one pair (H heads, Nq rows) `target` blocks, else 1; the
// block's warps split each chunk's keys 4 / groups ways. Nq2: the rows of a
// second direction in the same grid (bidir_cross.cu), 0 for one. The split
// warps' row max, sum p and P.V meet in shared memory, which orders a row's
// fp32 sums: the rule reads the pair's shape and never the batch, so a row
// sums in one order whatever batch its pair runs in (the batch only adds
// blocks), and a pair's result is its own.
inline int fill_row_groups(int H, int Nq, int Nq2 = 0, int target = FILL_BLOCKS) {
  for (int groups = 4; groups > 1; groups /= 2) {
    const int rows = 16 * groups;
    if ((long long)H * ((Nq + rows - 1) / rows + (Nq2 + rows - 1) / rows) >= target)
      return groups;
  }
  return 1;
}

// A block of the attention kernels at batch B: G 16-row groups of C warps.
// C is one pair's split (fill_row_groups at `target`, whose groups make one
// pair's block of WARPS warps); where the batch's launch still gives `grow`
// blocks, a block takes two or four times those groups (at most 16 warps):
// more rows share each staged K and V chunk, and no row's arithmetic
// changes (a group's C warps meet among themselves). With grow == target
// one pair's launch keeps its four-warp blocks
// (kernels/layer_stack.py:batch_row_groups mirrors it).
inline void batch_plan(int B, int H, int Nq, int Nq2, int target, int grow, int& G, int& C) {
  const int G0 = fill_row_groups(H, Nq, Nq2, target);
  C = WARPS / G0;
  G = G0;
  for (int g = 4; g > G0; g /= 2) {
    const int rows = 16 * g;
    if ((long long)B * H * ((Nq + rows - 1) / rows + (Nq2 + rows - 1) / rows) >= grow) {
      G = g;
      return;
    }
  }
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

// ---------------------------------------------------------------------------
// The 3xTF32 attention block (bidir_cross.cu:bidir_tf32_kernel): a
// warp owns 16 query rows; g = lane / 4, t4 = lane % 4 as in mma_tf32
// ---------------------------------------------------------------------------

// Q's 16 rows at qs (pitch FP) split once into HD / 8 (hi, lo) A fragments
// kept in registers (a0 row g, dim t4; a1 row g + 8; a2, a3 dim t4 + 4)
__device__ __forceinline__ void tf32_q_frags(const float* qs, int g, int t4,
                                             unsigned (&qh)[HD / 8][4],
                                             unsigned (&ql)[HD / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const float* qr = qs + g * FP + kk * 8 + t4;
    split_tf32_rz(qr[0], qh[kk][0], ql[kk][0]);
    split_tf32_rz(qr[8 * FP], qh[kk][1], ql[kk][1]);
    split_tf32_rz(qr[4], qh[kk][2], ql[kk][2]);
    split_tf32_rz(qr[8 * FP + 4], qh[kk][3], ql[kk][3]);
  }
}

// s = Q.K^T (unscaled) over NT 8-key n-tiles of keys at kb (pitch FP), each
// K element split as its B fragment loads (b0 key g, dim t4; b1 dim t4 + 4)
template <int NT>
__device__ __forceinline__ void tf32_scores(float (&s)[NT][4], const unsigned (&qh)[HD / 8][4],
                                            const unsigned (&ql)[HD / 8][4], const float* kb,
                                            int g, int t4) {
  kb += g * FP + t4;
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* kr = kb + n * 8 * FP + kk * 8;
      unsigned bh0, bl0, bh1, bl1;
      split_tf32_rz(kr[0], bh0, bl0);
      split_tf32_rz(kr[4], bh1, bl1);
      mma_3xtf32(s[n], qh[kk], ql[kk], bh0, bl0, bh1, bl1);
    }
  }
}

// pv += P.V over the same NT n-tiles, one 8-key k step each, with P (fp32:
// its cast to the fp32 V type is the identity) taken from the S accumulator
// into the A operand without a shuffle: n-tile kk holds keys 2 t4 and
// 2 t4 + 1 of rows g and g + 8, and the order of keys within a k step does
// not change the sum, so k slot t4 takes key 2 t4 and slot t4 + 4 key
// 2 t4 + 1 (a0, a2 = d0, d1; a1, a3 = d2, d3), and V's B fragment is read
// at keys 2 t4 and 2 t4 + 1, dim g, of the keys at vb (pitch FP)
template <int NT>
__device__ __forceinline__ void tf32_pv(float (&pv)[HD / 8][4], const float (&p)[NT][4],
                                        const float* vb, int g, int t4) {
  vb += 2 * t4 * FP + g;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    unsigned ah[4], al[4];
    split_tf32_rz(p[kk][0], ah[0], al[0]);
    split_tf32_rz(p[kk][2], ah[1], al[1]);
    split_tf32_rz(p[kk][1], ah[2], al[2]);
    split_tf32_rz(p[kk][3], ah[3], al[3]);
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      const float* vr = vb + kk * 8 * FP + dn * 8;
      unsigned bh0, bl0, bh1, bl1;
      split_tf32_rz(vr[0], bh0, bl0);
      split_tf32_rz(vr[FP], bh1, bl1);
      mma_3xtf32(pv[dn], ah, al, bh0, bl0, bh1, bl1);
    }
  }
}

// With C > 1 warps of a 16-row group splitting each chunk's keys: this
// warp's partial row max of rows g and g + 8 (after quad_max) becomes the
// group's, through red ([WARPS][16][RS])
template <int C>
__device__ __forceinline__ void meet_max(float (&mx)[2], float* red, int warp, int g, int t4) {
  if constexpr (C > 1) {
    if (t4 == 0) {
      red[(warp * 16 + g) * RS] = mx[0];
      red[(warp * 16 + g + 8) * RS] = mx[1];
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < C; ++w) {
      mx[0] = fmaxf(mx[0], red[((warp / C * C + w) * 16 + g) * RS]);
      mx[1] = fmaxf(mx[1], red[((warp / C * C + w) * 16 + g + 8) * RS]);
    }
    __syncthreads();
  }
}

// the same for sum p (after quad_sum) and P.V: the C warps of a row group
// add their parts in one order, so only the order of fp32 sums changes
template <int C>
__device__ __forceinline__ void meet_sums(float (&ps)[2], float (&pv)[HD / 8][4], float* red,
                                          int warp, int g, int t4) {
  if constexpr (C > 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* rec = red + (warp * 16 + g + 8 * i) * RS;
      if (t4 == 0) rec[1] = ps[i];
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<float2*>(rec + 2 + n * 8 + 2 * t4) =
            make_float2(pv[n][2 * i], pv[n][2 * i + 1]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ps[i] = 0.f;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) pv[n][2 * i] = pv[n][2 * i + 1] = 0.f;
#pragma unroll
      for (int w = 0; w < C; ++w) {
        const float* rec = red + ((warp / C * C + w) * 16 + g + 8 * i) * RS;
        ps[i] += rec[1];
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          const float2 x = *reinterpret_cast<const float2*>(rec + 2 + n * 8 + 2 * t4);
          pv[n][2 * i] += x.x;
          pv[n][2 * i + 1] += x.y;
        }
      }
    }
    __syncthreads();
  }
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

// fp32 rows [0, rows) of a tile of pitch FP from global rows row0 + r, as
// the bf16 stage_rows (4 floats per 16 B copy)
__device__ __forceinline__ void stage_rows(float* dst, const Operand& o, int b, int h, int row0,
                                           int rows, int nrows, bool aligned) {
  for (int s = threadIdx.x; s < rows * (HD / 4); s += blockDim.x) {
    const int r = s / (HD / 4), c = s % (HD / 4) * 4;
    float* d = dst + r * FP + c;
    if (r >= nrows) {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float* src = row_ptr<float>(o, b, h, row0 + r) + c;
    if (aligned) {
      cp_async16(d, src);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = src[e];
    }
  }
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
