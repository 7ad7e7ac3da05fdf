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
// (1 MB at 1x1024x1024 bf16, ~0.3 us at 3.35 TB/s). Design: one block per
// pair, a warp per row (four rows in flight), because the stop decision
// joins the counts of BOTH images and the keep update waits on it: the
// block reduces the counts, decides, then applies the per-row update flags
// it kept in shared memory. One block per pair leaves all SMs but one idle
// at B = 1; splitting the rows over blocks is later work.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 2048;  // N0 + N1 under the N <= 1024 gate
constexpr int IN_FLIGHT = 4;    // rows a warp reduces at once

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

template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
adaptive_decide_kernel(const TX* __restrict__ x0, const TX* __restrict__ x1,
                       int N0, int N1, int E, const TW* __restrict__ w_tok,
                       const float* __restrict__ b_tok, float tok_c,
                       const TW* __restrict__ w_match,
                       const float* __restrict__ b_match, float match_c,
                       const int* __restrict__ len0,
                       const int* __restrict__ len1, float* keep0,
                       float* keep1, float* exit_reg, int layer, int n_layers,
                       float depth_confidence) {
  __shared__ unsigned char upd_s[MAX_ROWS];
  __shared__ int cnt_s[WARPS], tot_s[WARPS];
  __shared__ int stop_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (!(exit_reg[b] > static_cast<float>(layer))) return;  // dead: nothing
  if (layer == n_layers - 1) {  // forced exit, nothing else computed
    if (tid == 0) exit_reg[b] = static_cast<float>(n_layers);
    return;
  }
  const bool width = keep0 != nullptr;
  const float thr = tok_c - b_tok[0];
  const float mthr = width ? match_c - b_match[0] : 0.f;
  const int l0 = len0 ? len0[b] : N0;
  const int l1 = len1 ? len1[b] : N1;

  const int rows = N0 + N1;
  int cnt = 0, tot = 0;  // lane 0 of each warp accumulates its rows
  for (int r0 = warp * IN_FLIGHT; r0 < rows; r0 += WARPS * IN_FLIGHT) {
    const TX* xr[IN_FLIGHT];
#pragma unroll
    for (int k = 0; k < IN_FLIGHT; ++k) {
      const int r = min(r0 + k, rows - 1);  // a row past the end is not used
      xr[k] = r >= N0 ? x1 + ((size_t)b * N1 + r - N0) * E
                      : x0 + ((size_t)b * N0 + r) * E;
    }
    float dt[IN_FLIGHT] = {}, dm[IN_FLIGHT] = {};
#pragma unroll 4
    for (int c = lane; c < E; c += 32) {
      const float wt = lg::to_f(w_tok[c]);
      const float wm = width ? lg::to_f(w_match[c]) : 0.f;
#pragma unroll
      for (int k = 0; k < IN_FLIGHT; ++k) {
        const float xv = as_head<TW>(xr[k][c]);
        dt[k] = fmaf(xv, wt, dt[k]);
        dm[k] = fmaf(xv, wm, dm[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < IN_FLIGHT; ++k) {
      const int r = r0 + k;
      const float t = lg::warp_sum(dt[k]);
      const float m = lg::warp_sum(dm[k]);
      if (lane != 0 || r >= rows) continue;
      const bool second = r >= N0;
      const int row = second ? r - N0 : r;
      bool valid;
      if (width)
        valid = (second ? keep1[(size_t)b * N1 + row]
                        : keep0[(size_t)b * N0 + row]) >= 0.5f;
      else
        valid = row < (second ? l1 : l0);
      cnt += (valid && t >= thr) ? 1 : 0;
      tot += valid ? 1 : 0;
      if (width) upd_s[r] = (m > mthr) || (t <= thr);
    }
  }
  cnt = warp_sum_int(cnt);
  tot = warp_sum_int(tot);
  if (lane == 0) {
    cnt_s[warp] = cnt;
    tot_s[warp] = tot;
  }
  __syncthreads();
  if (warp == 0) {
    cnt = warp_sum_int(cnt_s[lane]);
    tot = warp_sum_int(tot_s[lane]);
    if (lane == 0) {
      const float ratio =
          static_cast<float>(cnt) / fmaxf(static_cast<float>(tot), 1.f);
      const int stop = ratio > depth_confidence;
      if (stop) exit_reg[b] = static_cast<float>(layer + 1);
      stop_s = stop;
    }
  }
  __syncthreads();
  if (!width || stop_s) return;  // a pair that stops here prunes nothing
  for (int r = tid; r < rows; r += THREADS) {
    if (upd_s[r]) continue;
    if (r < N0)
      keep0[(size_t)b * N0 + r] = 0.f;
    else
      keep1[(size_t)b * N1 + r - N0] = 0.f;
  }
}

template <typename TX, typename TW>
int launch(const void* x0, const void* x1, int B, int N0, int N1, int E,
           const void* w_tok, const void* b_tok, float tok_c,
           const void* w_match, const void* b_match, float match_c,
           const void* len0, const void* len1, void* keep0, void* keep1,
           void* exit_reg, int layer, int n_layers, float depth_confidence,
           cudaStream_t stream) {
  if (N0 + N1 > MAX_ROWS) return static_cast<int>(cudaErrorInvalidValue);
  adaptive_decide_kernel<TX, TW><<<B, THREADS, 0, stream>>>(
      static_cast<const TX*>(x0), static_cast<const TX*>(x1), N0, N1, E,
      static_cast<const TW*>(w_tok), static_cast<const float*>(b_tok), tok_c,
      static_cast<const TW*>(w_match), static_cast<const float*>(b_match),
      match_c, static_cast<const int*>(len0), static_cast<const int*>(len1),
      static_cast<float*>(keep0), static_cast<float*>(keep1),
      static_cast<float*>(exit_reg), layer, n_layers, depth_confidence);
  return static_cast<int>(cudaGetLastError());
}

// operand modes (kernels/layer_stack.py:adaptive_decide mirrors them)
enum Mode { FP32 = 0, BF16 = 1, F32_X_BF16_HEADS = 2 };

}  // namespace

// x0: (B, N0, E), x1: (B, N1, E); w_tok, w_match: (E,) (w_match null
// without width); mode: FP32 (all fp32), BF16 (all bf16) or
// F32_X_BF16_HEADS (fp32 x, bf16 heads); b_tok, b_match: this layer's fp32 bias (one value);
// tok_c = logit(th) and match_c = logit(1 - wc) from the host; len0/len1:
// (B,) int32 or null (unmasked); keep0/keep1: (B, N0)/(B, N1) fp32 0/1,
// both null without width, updated in place; exit_reg: (B,) fp32, updated in
// place. layer is the GLOBAL layer index, n_layers the stack's depth.
extern "C" int lg_adaptive_decide(const void* x0, const void* x1, int B,
                                  int N0, int N1, int E, const void* w_tok,
                                  const void* b_tok, float tok_c,
                                  const void* w_match, const void* b_match,
                                  float match_c, const void* len0,
                                  const void* len1, void* keep0, void* keep1,
                                  void* exit_reg, int layer, int n_layers,
                                  float depth_confidence, int mode,
                                  void* stream) {
  using bf16 = __nv_bfloat16;
  auto run = mode == FP32 ? launch<float, float>
             : mode == BF16 ? launch<bf16, bf16>
             : mode == F32_X_BF16_HEADS ? launch<float, bf16> : nullptr;
  if (!run) return static_cast<int>(cudaErrorInvalidValue);
  return run(x0, x1, B, N0, N1, E, w_tok, b_tok, tok_c, w_match, b_match, match_c, len0, len1,
             keep0, keep1, exit_reg, layer, n_layers, depth_confidence,
             static_cast<cudaStream_t>(stream));
}
