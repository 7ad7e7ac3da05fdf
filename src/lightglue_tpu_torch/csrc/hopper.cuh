// Hopper's asynchronous machinery, shared by the warp-specialised kernels
// (attention_tile.cuh's tile bodies, which attention.cu's
// attention_wgmma_kernel and attention_tf32_wgmma_kernel and bidir_cross.cu's
// bidir_wgmma_kernel and bidir_tf32_wgmma_kernel run;
// linear.cu:linear_wgmma_kernel and linear_tf32_wgmma_kernel,
// flash_attn.cu:flash_wgmma_kernel and flash_tf32_wgmma_kernel) and, for
// its wgmma pieces alone, conv3x3.cu:conv3x3_tf32_wgmma_kernel:
//
// - TMA: a tensor map (CUtensorMap) encoded on the host per launch by
//   libcuda's cuTensorMapEncodeTiled, looked up through the runtime
//   so the library links against the runtime alone; passed to the kernel
//   as a __grid_constant__ parameter, so a CUDA graph captures it by value.
//   One thread asks for a whole box (up to 64 x 64 elements here) to be
//   copied into shared memory, swizzled as wgmma reads it (or as it lies,
//   for a tile the consumer reads itself), and the copy completes on an
//   mbarrier. Rows and columns past the
//   tensor's extent arrive as zeros, and count toward the barrier's bytes
//   like the rest of the box.
// - mbarrier: a ring's "full" barriers (the producer's expect_tx, completed
//   by the TMA bytes) and "empty" ones (one arrival per consumer warp once
//   its products have read the slot). Waits poll try_wait.parity; a wait
//   that lasts past WAIT_TRAP_CYCLES (seconds) traps, so a fault in a ring's
//   bookkeeping surfaces as a launch error instead of a hung card.
// - wgmma: warpgroup products m64nNk16, bf16 in, fp32 sums in registers,
//   with B (and A, or A from registers) read from shared memory through a
//   64-bit matrix descriptor: the tile's address, its layout (the swizzle
//   the TMA box was written with) and two strides. For a K-major operand
//   (the reduction dimension contiguous: Q, K, a linear's activations) in
//   128 B swizzle, SBO is the stride of eight rows (1024 B) and a step of 16
//   along K moves the address by 32 B inside the swizzle atom; for an
//   MN-major one (V, a linear's weight: the output dimension contiguous) in
//   128 B or 64 B swizzle, SBO (and LBO, which only a second atom along MN
//   would read: the bf16 tiles here are one atom wide) is the stride of
//   eight K rows, and a step of 16 along K moves the address by 16 rows.
//   Every tile starts on 1024 B.
// - The accumulator of m64nNk16 is, per warp, the m16n8k16 C fragment of
//   its 16 rows repeated over N / 8: d[4 j + e] at row 16 w + g + 8 (e / 2),
//   column 8 j + 2 t4 + (e & 1) (w: warp of the warpgroup, g = lane / 4,
//   t4 = lane % 4). A from registers is the m16n8k16 A fragment of the same
//   rows, so an S accumulator packed to bf16 pairs is P.V's A operand as it
//   stands (FlashAttention-3's register-A form).
// - 3xTF32 on wgmma (the fp32 kernels): m64nNk8 with tf32 operands and fp32
//   sums, whose accumulator is laid out as above. A tf32 operand in shared
//   memory is read K-major only (only 16-bit types may be transposed), so
//   an fp32 operand with its output dimension contiguous (V, a linear's
//   weight) is either copied transposed by the consumer or taken as the
//   register-A operand. An fp32 K-major tile 64 deep is two 128 B atoms
//   along K (32 floats each: four k8 steps), laid out as two [rows][32]
//   halves, each a TMA box of 32 columns in 128 B swizzle; a k8 step moves
//   32 B inside its half (desc_step_f32). Register A is, per warp, the
//   m16n8k8 tf32 A fragment of its 16 rows: a0 (row g, k t4), a1 (g + 8,
//   t4), a2 (g, t4 + 4), a3 (g + 8, t4 + 4). Each operand x is split into
//   hi (x with its low 13 bits cleared, mma.cuh:split_tf32_rz) and lo = x -
//   hi, and a product is hi.lo + lo.hi + hi.hi, the small terms first and
//   lo.lo dropped. In shared memory the raw fp32 tile as TMA wrote it
//   serves as hi, since the tensor core reads an fp32 word of a tf32
//   operand as its truncation (a build that clears the low bits first gives
//   the same bits: scripts/tune_torch_fp32_wgmma.py --variant explicit_hi),
//   and the consumer writes the lo copy beside it in the same layout
//   (tf32_lo_copy), then fences the async proxy before wgmma reads it.
// - setmaxnreg moves registers from the producer warpgroup to the
//   consumers; the kernels split their roles in one if / else that never
//   reconverges, as ptxas needs to honour it.
#pragma once

#include <cuda.h>

#include "mma.cuh"

namespace lg {

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once (null where the
// installed libcuda has none)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a TMA operand TMA can address: base and row strides on 16 B
inline bool tma_aligned(const void* base, long long row_stride_bytes,
                        long long batch_stride_bytes = 0) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && row_stride_bytes % 16 == 0 &&
         batch_stride_bytes % 16 == 0;
}

// A tensor of rank 2, 3 or 4 of `type` (dims innermost first, strides in bytes
// of dims 1..), read in boxes of box[] elements written to shared memory in
// `swizzle_bytes` swizzle (128 or 64; 0: as they lie, row after row).
// Returns a cudaError_t value.
inline int tma_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int rank,
                   const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                   int swizzle_bytes) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                           : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// the tensor-map type of an element type
template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_UINT8;  // int8: its bytes as they are
}

// ---------------------------------------------------------------------------
// device: shared memory
// ---------------------------------------------------------------------------

// the first 1024 B boundary at or past p in shared memory (a 128 B swizzle
// atom; the kernels ask for 1 KB more than their tiles)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// device: mbarriers
// ---------------------------------------------------------------------------

constexpr long long WAIT_TRAP_CYCLES = 1ll << 34;  // ~10 s at the H100's clocks

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// the barriers' initialisation visible to the async proxy (TMA) and to
// every thread (the caller syncs the block after it)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > WAIT_TRAP_CYCLES) __trap();
}

// ---------------------------------------------------------------------------
// device: TMA loads
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// the box at (x, y) of a rank-2 map into dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                         int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// the box at (x, y, z) of a rank-3 map
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                         int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// the box at (x, y, z, w) of a rank-4 map
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                         int y, int z, int w) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y), "r"(z), "r"(w)
      : "memory");
}

// ---------------------------------------------------------------------------
// device: warpgroups
// ---------------------------------------------------------------------------

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// named barrier `id` (1..15) over `threads` threads (a multiple of 32)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// generic-proxy writes to shared memory made visible to the async proxy
// (wgmma, TMA) and the other way round
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// device: thread block clusters
// ---------------------------------------------------------------------------

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// the shared::cluster address of p's counterpart in the cluster's CTA `rank`
__device__ __forceinline__ unsigned dsmem(const void* p, int rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ float ld_dsmem(unsigned a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_dsmem4(unsigned a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// the cluster barrier, split: every thread that has not exited arrives
// (release: its shared-memory writes before it are visible to the cluster)
// and then waits (acquire) for all the others' arrivals
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

// matrix descriptor layouts of the swizzle modes used here
constexpr int SWIZZLE_128B = 1, SWIZZLE_64B = 2;

__device__ __forceinline__ uint64_t gmma_desc(const void* tile, int lbo_bytes, int sbo_bytes,
                                              int layout) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(layout) << 62;
}

// a K-major tile of 64-element (128 B) rows in 128 B swizzle, at the k16
// step kk: 32 B further along each row
__device__ __forceinline__ uint64_t kmajor_desc(const void* tile, int kk) {
  return gmma_desc(static_cast<const char*>(tile) + 32 * kk, 16, 1024, SWIZZLE_128B);
}

// an MN-major tile of `row_bytes` rows (128: 128 B swizzle, 64: 64 B), one
// swizzle atom wide, at the k16 step kk: 16 rows further
__device__ __forceinline__ uint64_t mnmajor_desc(const void* tile, int row_bytes, int kk) {
  const int group = 8 * row_bytes;  // eight K rows
  return gmma_desc(static_cast<const char*>(tile) + 16 * row_bytes * kk, group, group,
                   row_bytes == 128 ? SWIZZLE_128B : SWIZZLE_64B);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of registers an in-flight
// wgmma owns across its wait
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operand(unsigned (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (+)= A (64 x 16, K-major, smem) . B (16 x 32, smem), bf16 in, fp32 sums;
// TB: B MN-major (1) or K-major (0)
template <int TB>
__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], uint64_t da, uint64_t db,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

// d (+)= A (64 x 16, K-major, smem) . B (16 x 64, smem), bf16 in, fp32 sums;
// TB: B MN-major (1) or K-major (0)
template <int TB>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da, uint64_t db,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

// d += A (64 x 16 bf16, registers: the m16n8k16 A fragment of each warp's
// 16 rows) . B (16 x 64, MN-major in smem), fp32 sums
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], const unsigned (&a)[4],
                                        uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// x (a descriptor, an index) kept opaque to the compiler where it is used,
// so what is formed from it there is formed there: not hoisted out of the
// loop around its use, nor shared with an earlier use and kept live (in a
// register, or spilled) through the loops between them. The 48 descriptors
// of an fp32 S piece, hoisted out of the piece loop, spilled.
template <typename T>
__device__ __forceinline__ T opaque(T x) {
  if constexpr (sizeof(T) == 8)
    asm volatile("" : "+l"(x));
  else
    asm volatile("" : "+r"(x));
  return x;
}

// The descriptor of k8 step kk (0..7) of an fp32 K-major tile of `rows`
// rows, 64 deep, in 128 B swizzle as two [rows][32] halves (the second rows *
// 128 B on), from the tile's own (kmajor_desc at step 0): the half of kk /
// 4, 32 B further along its rows per step. The start address field moves
// by the step's bytes (every shared-memory address is below 2^18, so the
// 14-bit field does not carry).
__device__ __forceinline__ uint64_t desc_step_f32(uint64_t tile_desc, int rows, int kk) {
  return tile_desc + static_cast<uint64_t>(((kk / 4) * rows * 128 + 32 * (kk % 4)) >> 4);
}

// the lo copy of `n` raw fp32 values (a multiple of 4, 16 B aligned) into
// lo at the same offsets, so it keeps the tile's swizzle: lo = x - hi, hi =
// x with its low 13 bits cleared (exact), by `threads` threads from `tid`.
// The caller fences the async proxy and syncs the readers before wgmma
// reads it.
__device__ __forceinline__ void tf32_lo_copy(const float* raw, float* lo, int n, int tid,
                                             int threads) {
  for (int i = 4 * tid; i < n; i += 4 * threads) {
    const float4 x = *reinterpret_cast<const float4*>(raw + i);
    unsigned h[4], l[4];
    split_tf32_rz(x.x, h[0], l[0]);
    split_tf32_rz(x.y, h[1], l[1]);
    split_tf32_rz(x.z, h[2], l[2]);
    split_tf32_rz(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(lo + i) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// d (+)= A (64 x 8 tf32, K-major, smem) . B (8 x 32, K-major, smem), fp32 sums
__device__ __forceinline__ void wgmma_tf32_m64n32(float (&d)[16], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A (64 x 8 tf32, registers: the m16n8k8 A fragment of each warp's 16
// rows) . B (8 x 32, K-major in smem), fp32 sums
__device__ __forceinline__ void wgmma_tf32_m64n32_rs(float (&d)[16], const unsigned (&a)[4],
                                                     uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (+)= A (64 x 8 tf32, registers) . B (8 x 64, K-major in smem), fp32 sums
__device__ __forceinline__ void wgmma_tf32_m64n64_rs(float (&d)[32], const unsigned (&a)[4],
                                                     uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

}  // namespace lg
