// The per-layer adaptive decision of the LightGlue layer stack: early exit
// (depth) and token pruning (width), for every live pair after one layer.
//
// Replaces the decision block inside the TPU kernel
// lightglue_tpu/kernels/layer_stack.py:transformer_stack_adaptive (wrapper
// :974, pallas_call :1229; decision :569-732). For each pair b whose exit
// register is above the global layer g (live):
//
// - token logits lgt = x . w_tok (operands in the heads' type TW: x is
//   rounded to it, x.astype(attn_dtype) at :601; fp32 sum), compared in
//   logit space against thr = logit(th) - b_tok with
//   th = clip(0.8 + 0.1 exp(-4 g / L), 0, 1); the host passes logit(th);
// - depth: cnt = confident valid tokens of both images, valid = keep >= 0.5
//   under width, row < len when masked, every row otherwise; total =
//   max(valid0 + valid1, 1); cnt / total > depth_confidence writes
//   exit[b] = g + 1 (width-only passes 2.0, which is never reached);
// - width: upd = (x . w_match > logit(1 - wc) - b_match) | (lgt <= thr);
//   keep *= upd unless the pair stopped at this step;
// - at g == L - 1 the pair only gets exit[b] = L.
//
// x is in the activation type TX: fp32 or bf16 with heads of the same type
// (FP32, BF16, INT8), or fp32 with bf16 heads (MIXED, :600-602, :664-666).
//
// The TPU kernel's `fired` test and lane-oriented keep-row refresh only
// save VMEM work and are not carried over.
//
// Bound on the H100: the two matrix-vector products read x0 and x1 once
// (1 MB at 1x1024x1024 bf16, 2 MB with MIXED's fp32 rows: ~0.3-0.6 us at
// 3.35 TB/s), so the launch and the latency of one row load set the time.
// Design: the rows of every pair spread over the card, one launch per
// layer. A block takes a slice of one pair's N0 + N1 rows (decide_rows:
// 8, 16 or 32 rows, aiming for DECIDE_FILL blocks; kernels/layer_stack.py:
// decide_plan mirrors it), copies them into shared memory with 16 B loads
// and gives each row to a warp, which takes the dot products in the order
// the one-block design took them (lane-strided, then warp_sum), so a logit
// at a threshold decides as it did. The stop decision joins the counts of BOTH
// images and the keep update waits on it, so the blocks of a pair meet in a
// per-pair scratch in global memory: each block writes its rows' update
// flags and adds its confident and valid counts with atomics, then takes a
// ticket (__threadfence, atomicAdd). The pair's last block reads the totals
// back (atomicExch, which leaves the counters zeroed for the next launch
// and for a replayed CUDA graph), decides, writes exit and applies the
// keep updates from the flags. The scratch is the caller's, zeroed once.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int DECIDE_FILL = 256;  // blocks a launch aims for: about two per SM
constexpr int MAX_BLOCK_SMEM = 48 * 1024;

// rows of one pair a block takes: the largest of 32, 16 and 8 whose grid
// has DECIDE_FILL blocks, else 8 (a row per warp)
inline int decide_rows(int B, int rows) {
  for (int r = 32; r > WARPS; r /= 2)
    if ((long long)B * ((rows + r - 1) / r) >= DECIDE_FILL) return r;
  return WARPS;
}

// x in the heads' type (x.astype(attn_dtype)): a rounding only where the
// two types differ (MIXED), none where they agree
template <typename TW, typename TX>
__device__ __forceinline__ float as_head(TX x) {
  if constexpr (std::is_same<TX, TW>::value)
    return lg::to_f(x);
  else
    return lg::round_to<TW>(lg::to_f(x));
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (blocks per pair, B); counters: (B, 4) int32 {confident, valid,
// ticket, -}, zero at entry and at exit; flags: B x (N0 + N1) bytes
template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
adaptive_decide_kernel(const TX* __restrict__ x0, const TX* __restrict__ x1,
                       int N0, int N1, int E, int R, const TW* __restrict__ w_tok,
                       const float* __restrict__ b_tok, float tok_c,
                       const TW* __restrict__ w_match,
                       const float* __restrict__ b_match, float match_c,
                       const int* __restrict__ len0,
                       const int* __restrict__ len1, float* keep0,
                       float* keep1, float* exit_reg, int layer, int n_layers,
                       float depth_confidence, int* counters, unsigned char* flags) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TX* xs = reinterpret_cast<TX*>(smem_raw);  // [R][E]: the block's rows
  __shared__ int cnt_s[WARPS], tot_s[WARPS];
  __shared__ int last_s, stop_s;

  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (!(exit_reg[b] > static_cast<float>(layer))) return;  // dead: nothing
  if (layer == n_layers - 1) {  // forced exit, nothing else computed
    if (blockIdx.x == 0 && tid == 0) exit_reg[b] = static_cast<float>(n_layers);
    return;
  }
  const bool width = keep0 != nullptr;
  const float thr = tok_c - b_tok[0];
  const float mthr = width ? match_c - b_match[0] : 0.f;
  const int l0 = len0 ? len0[b] : N0;
  const int l1 = len1 ? len1[b] : N1;
  const int rows = N0 + N1;
  const int r0 = blockIdx.x * R, nr = min(R, rows - r0);
  unsigned char* pair_flags = flags + (size_t)b * rows;

  // the block's rows, 16 B a thread
  const int vec = E * static_cast<int>(sizeof(TX)) / 16;
  for (int s = tid; s < nr * vec; s += THREADS) {
    const int i = s / vec, r = r0 + i;
    const TX* src = r >= N0 ? x1 + ((size_t)b * N1 + r - N0) * E : x0 + ((size_t)b * N0 + r) * E;
    reinterpret_cast<uint4*>(xs + (size_t)i * E)[s % vec] =
        __ldg(reinterpret_cast<const uint4*>(src) + s % vec);
  }
  __syncthreads();

  int cnt = 0, tot = 0;  // lane 0 of each warp counts its rows
  for (int i = warp; i < nr; i += WARPS) {
    const TX* xr = xs + (size_t)i * E;
    float dt = 0.f, dm = 0.f;
#pragma unroll 4
    for (int c = lane; c < E; c += 32) {
      const float xv = as_head<TW>(xr[c]);
      dt = fmaf(xv, lg::to_f(w_tok[c]), dt);
      dm = fmaf(xv, width ? lg::to_f(w_match[c]) : 0.f, dm);
    }
    const float t = lg::warp_sum(dt);
    const float m = lg::warp_sum(dm);
    if (lane != 0) continue;
    const int r = r0 + i;
    const bool second = r >= N0;
    const int row = second ? r - N0 : r;
    bool valid;
    if (width)
      valid = (second ? keep1[(size_t)b * N1 + row] : keep0[(size_t)b * N0 + row]) >= 0.5f;
    else
      valid = row < (second ? l1 : l0);
    cnt += (valid && t >= thr) ? 1 : 0;
    tot += valid ? 1 : 0;
    if (width) pair_flags[r] = (m > mthr) || (t <= thr);
  }
  if (width) __threadfence();  // this thread's flags, before the block's ticket
  cnt = warp_sum_int(cnt);
  tot = warp_sum_int(tot);
  if (lane == 0) {
    cnt_s[warp] = cnt;
    tot_s[warp] = tot;
  }
  __syncthreads();
  int* ctr = counters + 4 * b;
  if (tid == 0) {
    int c = 0, t = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) c += cnt_s[w], t += tot_s[w];
    atomicAdd(ctr, c);
    atomicAdd(ctr + 1, t);
    __threadfence();
    last_s = atomicAdd(ctr + 2, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last_s) return;

  // the pair's last block: every block's counts and flags have landed
  __threadfence();
  if (tid == 0) {
    const int c = atomicExch(ctr, 0), t = atomicExch(ctr + 1, 0);
    atomicExch(ctr + 2, 0);
    const float ratio = static_cast<float>(c) / fmaxf(static_cast<float>(t), 1.f);
    const int stop = ratio > depth_confidence;
    if (stop) exit_reg[b] = static_cast<float>(layer + 1);
    stop_s = stop;
  }
  __syncthreads();
  if (!width || stop_s) return;  // a pair that stops here prunes nothing
  for (int r = tid; r < rows; r += THREADS) {
    if (__ldcg(pair_flags + r)) continue;
    if (r < N0)
      keep0[(size_t)b * N0 + r] = 0.f;
    else
      keep1[(size_t)b * N1 + r - N0] = 0.f;
  }
}

inline size_t decide_smem(int R, int E, int x_bytes) { return (size_t)R * E * x_bytes; }

template <typename TX, typename TW>
int launch(const void* x0, const void* x1, int B, int N0, int N1, int E,
           const void* w_tok, const void* b_tok, float tok_c,
           const void* w_match, const void* b_match, float match_c,
           const void* len0, const void* len1, void* keep0, void* keep1,
           void* exit_reg, int layer, int n_layers, float depth_confidence,
           void* counters, void* flags, cudaStream_t stream) {
  // rows are copied 16 B at a time
  if ((E * sizeof(TX)) % 16 || reinterpret_cast<uintptr_t>(x0) % 16 ||
      reinterpret_cast<uintptr_t>(x1) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int R = decide_rows(B, N0 + N1);
  const size_t smem = decide_smem(R, E, sizeof(TX));
  if (smem > MAX_BLOCK_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N0 + N1 + R - 1) / R, B);
  adaptive_decide_kernel<TX, TW><<<grid, THREADS, smem, stream>>>(
      static_cast<const TX*>(x0), static_cast<const TX*>(x1), N0, N1, E, R,
      static_cast<const TW*>(w_tok), static_cast<const float*>(b_tok), tok_c,
      static_cast<const TW*>(w_match), static_cast<const float*>(b_match),
      match_c, static_cast<const int*>(len0), static_cast<const int*>(len1),
      static_cast<float*>(keep0), static_cast<float*>(keep1),
      static_cast<float*>(exit_reg), layer, n_layers, depth_confidence,
      static_cast<int*>(counters), static_cast<unsigned char*>(flags));
  return static_cast<int>(cudaGetLastError());
}

// operand modes (kernels/layer_stack.py:adaptive_decide mirrors them)
enum Mode { FP32 = 0, BF16 = 1, F32_X_BF16_HEADS = 2 };

}  // namespace

// x0: (B, N0, E), x1: (B, N1, E), 16 B aligned, E * sizeof(x) a multiple
// of 16; w_tok, w_match: (E,) (w_match null without width); mode: FP32 (all
// fp32), BF16 (all bf16) or F32_X_BF16_HEADS (fp32 x, bf16 heads); b_tok,
// b_match: this layer's fp32 bias (one value); tok_c = logit(th) and
// match_c = logit(1 - wc) from the host; len0/len1: (B,) int32 or null
// (unmasked); keep0/keep1: (B, N0)/(B, N1) fp32 0/1, both null without
// width, updated in place; exit_reg: (B,) fp32, updated in place. layer is
// the GLOBAL layer index, n_layers the stack's depth. counters: (B, 4)
// int32, zero, and left zero; flags: at least B * (N0 + N1) bytes. Launches
// sharing the scratch run one after another (one stream).
extern "C" int lg_adaptive_decide(const void* x0, const void* x1, int B,
                                  int N0, int N1, int E, const void* w_tok,
                                  const void* b_tok, float tok_c,
                                  const void* w_match, const void* b_match,
                                  float match_c, const void* len0,
                                  const void* len1, void* keep0, void* keep1,
                                  void* exit_reg, int layer, int n_layers,
                                  float depth_confidence, int mode, void* counters,
                                  void* flags, void* stream) {
  using bf16 = __nv_bfloat16;
  auto run = mode == FP32 ? launch<float, float>
             : mode == BF16 ? launch<bf16, bf16>
             : mode == F32_X_BF16_HEADS ? launch<float, bf16> : nullptr;
  if (!run) return static_cast<int>(cudaErrorInvalidValue);
  return run(x0, x1, B, N0, N1, E, w_tok, b_tok, tok_c, w_match, b_match, match_c, len0, len1,
             keep0, keep1, exit_reg, layer, n_layers, depth_confidence, counters, flags,
             static_cast<cudaStream_t>(stream));
}

// The decision's launch at (B, N0, N1, E) with rows of x_bytes a value
// (decide_rows): out = {rows per block, threads, blocks, dynamic shared
// memory in bytes}; returns cudaErrorInvalidValue where the rows do not fit.
extern "C" int lg_decide_plan(int B, int N0, int N1, int E, int x_bytes, int* out) {
  const int R = decide_rows(B, N0 + N1);
  out[0] = R;
  out[1] = THREADS;
  out[2] = B * ((N0 + N1 + R - 1) / R);
  out[3] = static_cast<int>(decide_smem(R, E, x_bytes));
  return out[3] > MAX_BLOCK_SMEM ? static_cast<int>(cudaErrorInvalidValue) : 0;
}
