// Masked multi-head attention of the LightGlue layer stack, one kernel for
// the self block (half-split RoPE on q and k) and for either direction of
// the cross block (no RoPE).
//
// Replaces the attention inside the TPU kernel
// lightglue_tpu/kernels/layer_stack.py:transformer_stack (wrapper :801,
// pallas_call :894): self-attention :442-472, cross-attention :491-560.
// The TPU kernel shares one similarity matrix between the two cross
// directions to save VMEM; here each direction is its own launch (q=qk0,
// k=qk1, v=v1 and q=qk1, k=qk0, v=v0 with the lengths swapped), which
// computes the same function.
//
// Stats contract (layer_stack.py:267-292): one softmax over the whole row
// (Nk <= 1024). S is scaled after Q.K^T; with `quant` (the BF16 rung) s,
// the row max m, p and the row sum l are each rounded through bf16; padded
// kv columns become -1e30 (unrounded); with lengths or keep masks the row
// max is clamped at -5e29, so an all-masked row (a length 0, a fully pruned
// keep vector) yields exactly 0; o = P.V / (l == 0 ? 1 : l) in fp32 with P
// cast to the operand type, and padded q rows are zeroed; then ONE cast to
// T. RoPE casts the freqs to the operand type and rounds each product and
// the sum (:377-384).
//
// Adaptive operands (transformer_stack_adaptive, wrapper :974, pallas_call
// :1229): under width pruning (B, N) fp32 0/1 keep vectors replace the
// lengths: kv columns with keep < 0.5 become -1e30 and each output row is
// multiplied by its own keep (:457, :468-469, :500, :523, :535, :553-555).
// With an exit register (B,) fp32 and the global layer g, a block whose
// pair has exit <= g returns at once (the pl.when(live) gate, :734-745):
// its output rows are left unwritten, and the stack never reads them. The
// keep masks are a template parameter, so the fixed-depth path runs the
// code it ran without them.
//
// Bound on the H100: per head 4*Nq*Nk*D FLOP against (Nq+2*Nk)*D operands,
// so at N = 1024 the tensor cores bound it (~1.1 us per call at the bf16
// peak, B = 1, H = 4; ~6.5 us in fp32 at three TF32 products a product).
//
// The BF16 kernel (attention_wgmma_kernel) is built in Hopper's shape from
// hopper.cuh's pieces:
// - SPLIT = 8 consumers split each 64-row tile's 64-key chunks, chunk j to
//   consumer j % 8. A consumer is a warpgroup: S = Q.K^T is four wgmma
//   m64n64k16 with Q and K both K-major from shared memory; P.V takes P
//   from registers, the S accumulator rounded to bf16 pairs (wgmma's
//   register-A form, as FlashAttention-3), and V as the MN-major B
//   operand: bf16 in, fp32 sums. Each block has four consumer warpgroups
//   and a producer warpgroup, whose warp r's lane 0 feeds warpgroup r's
//   ring of two slots by TMA (Q once; K in pass 1, V or K and V in pass
//   2; 64 x 64 boxes in 128 B swizzle) behind full / empty mbarriers;
//   setmaxnreg moves the producer's registers to the consumers.
// - Two forms of the same split (Split): a cluster of two blocks a tile,
//   one consumer a warpgroup, meeting through distributed shared memory,
//   while the launch's blocks fit the card's SMs (one pair at N <= 1024: a
//   tile's eight consumers on two SMs); else one block a tile whose
//   warpgroups run two consumers each, one after the other. Both add the
//   same values in one order (a consumer's chunks in order; partials of
//   consumers c and c + 4, then the four in order), so a pair's rows are
//   the same at any batch, which only picks the form and adds blocks.
// - Two passes over the row: pass 1 reduces the row max, pass 2 forms p,
//   sums it and accumulates P.V. At bf16 stats (quant) pass 1 keeps each
//   chunk's rounded s in shared memory (STORE), and pass 2 reads it back
//   and streams V alone: s is rounded by the contract there, so that is
//   exact and saves pass 2's Q.K^T and K; at fp32 stats (MIXED) pass 2
//   recomputes S with the same instructions (bit for bit the same).
// - The 64-row tile: one K and V chunk read serves 64 query rows.
// - At bf16 stats s and p round to bf16 in pairs, one packed conversion
//   (cvt.rn.bf16x2) for two values, and p's packed word is P.V's operand:
//   the same bits as one conversion a value, which ran on a slow pipe.
// - Where it differs from flash_attn.cu, because the stack's contract does:
//   1. acc is never rounded: pv / l in fp32, then the keep multiply or the
//      row zeroing, then one cast to T (the flash kernel rounds acc once
//      per tile, which here would round twice);
//   2. the max clamp: m = max(quant(rowmax), -5e29) when masked or keep
//      masked (the flash kernel skips tiles past kv_len instead; scattered
//      keep columns cannot be skipped, and without the clamp an all-dead
//      row gives m = quant(-1e30) = -1.000256e30 and exp(+2.6e26) = inf);
//   3. s is rounded and dead columns are set to exactly -1e30; under KEEP
//      the column mask applies in every chunk; with lengths only the
//      chunk that holds kv_len does, and chunks wholly past kv_len are not
//      loaded or computed (their p is exactly 0 at the clamped m, so that
//      is exact); rows and keys past Nq and Nk arrive from TMA as zeros;
//   4. keep masks and liveness as above;
//   5. Q, K and V are column slices of one (B, N, H*64) projection (row
//      stride 3E for self qkv, 2E for cross [qk | v]): their tensor maps
//      address them at those strides, which TMA needs on 16 B (the
//      wrapper raises on an operand it cannot address).
// - RoPE runs once, in mma.cuh's rope_kernel, over q and k into a scratch
//   of their type (lg_rope_qk, which the wrapper launches first); the
//   kernel then reads rotated rows. Rotating K in every block that reads it
//   cost more than the attention at N = 2048 (measured in flash_attn.cu).
// - The output type TO is bf16 (the BF16 and INT8 rungs) or fp32 (MIXED:
//   bf16 operands, fp32 stats, o.astype(fp32) with no rounding, :472/:559).
// - dir1 (the cross block's direction 1 at MIXED): the reference takes that
//   direction as the column softmax of the shared S and sums p after its
//   cast to the operand type (p1.astype(attn_dtype), then a ones-vector
//   product, :543-549), where direction 0 and self-attention sum fp32 p
//   (:464, :509). With dir1 the row sum takes round_to<bf16>(p), as
//   bidir_cross.cu's direction 1 does. At bf16 stats p is already bf16 and
//   the two rules agree.
//
// The FP32 kernel (attention_tf32_wgmma_kernel: fp32 operands and out, with
// fp32 or bf16 stats) runs the same two passes and the same contract on
// Hopper's warpgroup MMA in 3xTF32: one TF32 product keeps about three
// decimal digits and misses the fp32 rung's 1e-4 gate, so every product is
// hi.lo + lo.hi + hi.hi of operands split by truncation (hi: x with its low
// 13 bits cleared, lo = x - hi; lo.lo dropped, the small terms first) on
// wgmma m64nNk8, from hopper.cuh's 3xTF32 pieces, as flash_attn.cu's
// flash_tf32_wgmma_kernel runs them. wgmma reads a tf32 operand in shared
// memory K-major only, which sets the layouts:
// - S = Q.K^T: Q (64 rows) and K (a 32-key piece) both K-major as TMA
//   writes them (32-float boxes in 128 B swizzle: two halves along the head
//   dim; the raw tiles serve as hi, since the tensor core reads a raw fp32
//   word as its truncation), beside their lo copies, which the consumers
//   write (Q's once, each K piece's as it lands): 24 m64n32k8 products a
//   piece, the 48 descriptors kept opaque so the compiler does not hoist
//   them out of the piece loop and spill.
// - P.V: P comes from the S accumulator as the register-A operand, split in
//   registers; the accumulator holds keys 2 t4 and 2 t4 + 1 of an 8-key step
//   where the tf32 A fragment takes t4 and t4 + 4, and the order of keys
//   within a step does not change the sum: slot t4 takes key 2 t4, slot
//   t4 + 4 key 2 t4 + 1. V, stored keys x dims, arrives as it lies and the
//   consumer writes it transposed, dims x keys in that slot order, as hi and
//   lo copies in 128 B swizzle: the K-major B operand of m64n64k8.
// - fp32 tiles are twice bf16's bytes and each needs a lo copy, so a ring
//   slot holds a 32-key piece of K (and of V in pass 2), one slot a
//   warpgroup beside its K lo and V^T hi / lo buffers, over which its P.V
//   partial goes once pass 2 is done (TfSmem, ~195 KB a block). Pass 2
//   always recomputes S, bit for bit pass 1's (a stored fp32 s would not
//   fit), so with bf16 stats (quant) s, m, p and l round as the bf16
//   kernel's do.
// - The split: chunk j of a row to consumer j % split, split 8 where one
//   pair's 64-row tiles, two blocks each, fit the card's SMs (tf32_split:
//   one pair of 1024 at H = 4 gives 128 blocks), else 4. A block has no room
//   for a second consumer's partial, so a split of 8 is always a cluster of
//   two blocks, one consumer a warpgroup, and a split of 4 one block: the
//   form follows one pair's shape, never the batch, which only adds blocks,
//   and a row's sums run in one order at any batch (q_c = p_c + p_{c + 4},
//   then q_0 .. q_3 in order, as the bf16 kernel's).
// - The bf16 kernel's items 1-5 above hold on the accumulator layout (the
//   clamp, -1e30 dead columns and -inf pad columns, chunks past kv_len
//   skipped, keep masks and liveness, TMA maps at the strides of qkv and
//   [qk | v]); dir1 needs nothing: p's cast to the fp32 V type is the
//   identity.
// RoPE runs first, in rope_kernel<float>, into an fp32 scratch. Its shared
// memory is TfSmem (kernels/layer_stack.py:attention_plan mirrors it and
// the split, lg_attention_plan).
//
// Both kernels are thin shells over attention_tile.cuh's tile bodies
// (attention_tile, attention_tf32_tile), which bidir_cross.cu's kernels run
// too: a kernel here finds its tile, its lengths or keep vectors and the
// clamp (Tile) and runs the body.

#include "attention_tile.cuh"

namespace {

using namespace lg;  // Operand, the tile bodies and their launch helpers (attention_tile.cuh)

// The stack's tile of a block: q rows of Nq and k / v rows of Nk in the
// given maps, lengths (B,) or keep vectors (B, N) (KEEP), the clamp where
// either masks
template <bool KEEP, typename TO>
__device__ __forceinline__ Tile<TO> stack_tile(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                               const CUtensorMap* vmap, const int* len_q,
                                               const int* len_kv, const float* keep_q,
                                               const float* keep_kv, TO* out, int b, int h,
                                               int i0, int Nq, int Nk, int H) {
  Tile<TO> t;
  t.qmap = qmap, t.kmap = kmap, t.vmap = vmap;
  t.ob = out + (size_t)b * Nq * H * D + h * D;
  t.b = b, t.h = h, t.i0 = i0, t.Nq = Nq, t.Nk = Nk, t.H = H;
  t.lq = (!KEEP && len_q) ? len_q[b] : Nq;
  // keys that can be live: every key under KEEP, the valid prefix with lengths
  t.live_k = (!KEEP && len_kv) ? max(min(len_kv[b], Nk), 0) : Nk;
  t.clamp = KEEP || len_q != nullptr;
  t.kq = KEEP ? keep_q + (size_t)b * Nq : nullptr;
  t.kk = KEEP ? keep_kv + (size_t)b * Nk : nullptr;
  return t;
}

// The BF16 kernel: a 64-row tile of one head per block or cluster of two
// (attention_tile.cuh:attention_tile, bf16 stats where s is kept)
template <bool KEEP, typename TO, bool STORE, int CLUSTER>
__global__ void __launch_bounds__((WGS + 1) * 128, 1)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const int* __restrict__ len_q,
                       const int* __restrict__ len_kv, const float* __restrict__ keep_q,
                       const float* __restrict__ keep_kv, const float* __restrict__ exit_reg,
                       int layer, TO* __restrict__ out, int Nq, int Nk, int H, float scale,
                       int quant, int dir1) {
  const int b = blockIdx.z, h = blockIdx.y;
  if (exit_reg && !(exit_reg[b] > static_cast<float>(layer))) return;  // the whole cluster
  const Tile<TO> t = stack_tile<KEEP>(&qmap, &kmap, &vmap, len_q, len_kv, keep_q, keep_kv, out,
                                      b, h, blockIdx.x / CLUSTER * 64, Nq, Nk, H);
  attention_tile<KEEP, TO, STORE, STORE, CLUSTER>(t, scale, quant, dir1);
}

// The FP32 kernel: the same tile in 3xTF32 (attention_tile.cuh:
// attention_tf32_tile), a cluster of two blocks at a split of 8
template <bool KEEP, int CLUSTER>
__global__ void __launch_bounds__((WGS + 1) * 128, 1)
attention_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const int* __restrict__ len_q, const int* __restrict__ len_kv,
                            const float* __restrict__ keep_q, const float* __restrict__ keep_kv,
                            const float* __restrict__ exit_reg, int layer,
                            float* __restrict__ out, int Nq, int Nk, int H, float scale,
                            int quant) {
  const int b = blockIdx.z, h = blockIdx.y;
  if (exit_reg && !(exit_reg[b] > static_cast<float>(layer))) return;  // the whole cluster
  const Tile<float> t = stack_tile<KEEP>(&qmap, &kmap, &vmap, len_q, len_kv, keep_q, keep_kv,
                                         out, b, h, blockIdx.x / CLUSTER * 64, Nq, Nk, H);
  attention_tf32_tile<KEEP, CLUSTER>(t, scale, quant);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The FP32 kernel in one form: Q in 32-float boxes of 64 rows and K in
// 32-float boxes of 32 keys (128 B swizzle), V in 64-float boxes of 32 keys
// as they lie
template <bool KEEP, int CLUSTER>
int launch_tf32(Operand q, Operand k, Operand v, const void* len_q, const void* len_kv,
                const void* keep_q, const void* keep_kv, const void* exit_reg, int layer,
                void* out, int B, int Nq, int Nk, int H, float scale, int quant,
                cudaStream_t stream) {
  constexpr size_t smem = TfSmem::BYTES;
  auto kernel = attention_tf32_wgmma_kernel<KEEP, CLUSTER>;
  static const cudaError_t opt_in =  // above 48 KB: opt in once
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap qm, km, vm;
  const int errs[3] = {head_map(&qm, q, B, Nq, H, F32, 32, 64, 128),
                       head_map(&km, k, B, Nk, H, F32, 32, PIECE_KEYS, 128),
                       head_map(&vm, v, B, Nk, H, F32, D, PIECE_KEYS, 0)};
  for (const int err : errs)
    if (err) return err;
  return launch_tiles(kernel, CLUSTER, smem, B, tiles_of(Nq), H, stream, qm, km, vm,
                      static_cast<const int*>(len_q), static_cast<const int*>(len_kv),
                      static_cast<const float*>(keep_q), static_cast<const float*>(keep_kv),
                      static_cast<const float*>(exit_reg), layer, static_cast<float*>(out), Nq, Nk,
                      H, scale, quant);
}

// tf32_split's form: a cluster of two blocks a tile at a split of 8, one
// block at 4
template <bool KEEP>
int launch_fp32(Operand q, Operand k, Operand v, const void* len_q, const void* len_kv,
                const void* keep_q, const void* keep_kv, const void* exit_reg, int layer,
                void* out, int B, int Nq, int Nk, int H, float scale, int quant, cudaStream_t s) {
  auto run = tf32_split(H, tiles_of(Nq)) == 8 ? launch_tf32<KEEP, 2> : launch_tf32<KEEP, 1>;
  return run(q, k, v, len_q, len_kv, keep_q, keep_kv, exit_reg, layer, out, B, Nq, Nk, H, scale,
             quant, s);
}

template <bool KEEP, typename TO, bool STORE, int CLUSTER>
int launch_wgmma(Operand q, Operand k, Operand v, const void* len_q, const void* len_kv,
                 const void* keep_q, const void* keep_kv, const void* exit_reg, int layer,
                 void* out, int B, int Nq, int Nk, int H, float scale, int quant, int dir1,
                 cudaStream_t stream) {
  constexpr size_t smem = Smem<STORE, CLUSTER>::BYTES;
  auto kernel = attention_wgmma_kernel<KEEP, TO, STORE, CLUSTER>;
  static const cudaError_t opt_in =  // above 48 KB: opt in once
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  if (STORE && Nk > STORED_KEYS)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr CUtensorMapDataType BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qm, km, vm;
  const int errs[3] = {head_map(&qm, q, B, Nq, H, BF, D, 64, 128),
                       head_map(&km, k, B, Nk, H, BF, D, 64, 128),
                       head_map(&vm, v, B, Nk, H, BF, D, 64, 128)};
  for (const int err : errs)
    if (err) return err;
  return launch_tiles(kernel, CLUSTER, smem, B, tiles_of(Nq), H, stream, qm, km, vm,
                      static_cast<const int*>(len_q), static_cast<const int*>(len_kv),
                      static_cast<const float*>(keep_q), static_cast<const float*>(keep_kv),
                      static_cast<const float*>(exit_reg), layer, static_cast<TO*>(out), Nq, Nk,
                      H, scale, quant, dir1);
}

// bf16 stats (quant) keep pass 1's s, fp32 stats recompute it; clusters of
// two blocks while their blocks fit the SMs (use_cluster), else one block a
// tile: the same sums either way
template <bool KEEP, typename TO>
int launch_bf16(Operand q, Operand k, Operand v, const void* len_q, const void* len_kv,
                const void* keep_q, const void* keep_kv, const void* exit_reg, int layer,
                void* out, int B, int Nq, int Nk, int H, float scale, int quant, int dir1,
                cudaStream_t stream) {
  const bool cl = use_cluster(B, H, tiles_of(Nq));
  auto run = quant ? (cl ? launch_wgmma<KEEP, TO, true, 2> : launch_wgmma<KEEP, TO, true, 1>)
                   : (cl ? launch_wgmma<KEEP, TO, false, 2> : launch_wgmma<KEEP, TO, false, 1>);
  return run(q, k, v, len_q, len_kv, keep_q, keep_kv, exit_reg, layer, out, B, Nq, Nk, H, scale,
             quant, dir1, stream);
}

// operand modes of lg_attention (kernels/layer_stack.py:attention mirrors them)
enum Mode { FP32 = 0, BF16 = 1, BF16_F32_OUT = 2 };

}  // namespace

// q: rows of Nq, k/v: rows of Nk; head h of a row at columns [h*64, h*64+64),
// addressed by (batch, row) strides in elements; with RoPE the caller has
// rotated q and k first (lg_rope_qk) and passes the rotated rows.
// len_q/len_kv: (B,) int32, both null for the unmasked variant.
// keep_q/keep_kv: (B, Nq)/(B, Nk) fp32 0/1 keep masks, both null or both set
// (then the lengths are ignored). exit_reg: (B,) fp32 or null; layer: the
// global layer index. out: (B, Nq, H*64). mode: FP32 (fp32 operands and out,
// attention_tf32_wgmma_kernel in tf32_split's form), BF16 (bf16 operands and
// out) or BF16_F32_OUT (bf16 operands, fp32 out), the last two
// attention_wgmma_kernel; each a block or a cluster of two per 64 rows of a
// head, its operands read by TMA (on 16 B: base, row and batch strides;
// else cudaErrorInvalidValue) (kernels/layer_stack.py:attention_plan mirrors
// both). dir1: the row sum
// takes p rounded to the operand type (the cross block's direction 1).
extern "C" int lg_attention(const void* q, long long q_bs, long long q_rs,
                            const void* k, long long k_bs, long long k_rs,
                            const void* v, long long v_bs, long long v_rs,
                            const void* len_q, const void* len_kv, const void* keep_q,
                            const void* keep_kv, const void* exit_reg,
                            int layer, void* out, int B, int Nq, int Nk,
                            int H, float scale, int quant, int mode, int dir1,
                            void* stream) {
  const Operand oq{q, q_bs, D, q_rs}, ok{k, k_bs, D, k_rs}, ov{v, v_bs, D, v_rs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool keep = keep_q != nullptr;
  if (mode == FP32)
    return (keep ? launch_fp32<true> : launch_fp32<false>)(
        oq, ok, ov, len_q, len_kv, keep_q, keep_kv, exit_reg, layer, out, B, Nq, Nk, H, scale,
        quant, s);
  if (mode != BF16 && mode != BF16_F32_OUT) return static_cast<int>(cudaErrorInvalidValue);
  auto run = mode == BF16 ? (keep ? launch_bf16<true, bf16_t> : launch_bf16<false, bf16_t>)
                          : (keep ? launch_bf16<true, float> : launch_bf16<false, float>);
  return run(oq, ok, ov, len_q, len_kv, keep_q, keep_kv, exit_reg, layer, out, B, Nq, Nk, H,
             scale, quant, dir1, s);
}

// The self-attention's RoPE pre-pass: q and k ((B, N, H*64) rows of the
// mode's operand type, addressed by (batch, row) strides) rotated with freqs
// (B, 2, N, 64) fp32 into rot (2, B, N, H*64) of that type, which
// lg_attention then reads as q and k.
extern "C" int lg_rope_qk(const void* q, long long q_bs, long long q_rs, const void* k,
                          long long k_bs, long long k_rs, const void* freqs, void* rot, int B,
                          int N, int H, int mode, void* stream) {
  const Operand oq{q, q_bs, D, q_rs}, ok{k, k_bs, D, k_rs};
  const float* f = static_cast<const float*>(freqs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(mode == FP32 ? rope_qk(oq, ok, f, static_cast<float*>(rot), B, N, H, s)
                                       : rope_qk(oq, ok, f, static_cast<bf16_t*>(rot), B, N, H, s));
}

// lg_attention's block at this shape in this mode: out = {16-row groups (4:
// a 64-row tile), consumer warpgroups splitting each row's chunks, dynamic
// shared memory in bytes} (the wrapper's attention_plan is held against
// it), and the blocks of the launch. The bf16 kernel splits SPLIT ways at
// every shape and batch, a cluster of two blocks a tile where use_cluster
// says so; its shared memory holds pass 1's s at bf16 stats (quant). The
// fp32 kernel splits tf32_split ways, a cluster of two blocks a tile at a
// split of 8.
extern "C" int lg_attention_plan(int B, int H, int Nq, int mode, int quant, int* out) {
  const bool f32 = mode == FP32;
  const int split = f32 ? tf32_split(H, tiles_of(Nq)) : SPLIT;
  const bool cluster = f32 ? split == 8 : use_cluster(B, H, tiles_of(Nq));
  out[0] = 4;
  out[1] = split;
  out[2] = static_cast<int>(f32 ? TfSmem::BYTES : wgmma_smem(quant, cluster));
  out[3] = (cluster ? 2 : 1) * ((Nq + 63) / 64) * H * B;
  return 0;
}
