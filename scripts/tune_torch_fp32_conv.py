"""Time the two staging designs of the fp32 model conv (3xTF32) on one card.

``csrc/conv3x3.cu:conv3x3_tf32x3_kernel`` streams K: the weights do not
stay in shared memory, a two-stage cp.async ring copies 8 input channels of
the haloed 16x16 tile and their 9 x 8 x 64 weights at a time, the weights
are split into (hi, lo) pairs once per chunk, and two blocks share an SM.
fp32 operands double the bf16 kernel's bytes, so the other way to stage
them, all nine taps' weights resident (147 KB) beside ONE input buffer,
only fits an 8x16 output tile: ``RESIDENT`` below is that design, a
persistent block an SM (the weights copied once per block), the tile's
input not overlapped with the previous tile's work, each weight split as
its fragment is loaded (the split pairs of all taps would not fit).

Each design is built into its own library under ``build/tune/``
(``tune_torch_stack_kernels.build``; the resident one replaces the
streaming kernel in a copy of ``conv3x3.cu``), its registers and stack
printed, then at the model's three convs of a 2x480x640 pair (conv1b+pool,
conv2a, conv2b+pool) the port's wrapper runs each: checked against the
plain version at ``chip_smoke.TOL["fp32"]``, timed with
``chip_smoke.cuda_ms`` in the order streaming, resident, resident,
streaming, cuDNN's fp32 conv (TF32 off) beside them. From the root of a
checkout, on a machine with nvcc:

    python3 scripts/tune_torch_fp32_conv.py
"""

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]

import chip_smoke as cs  # noqa: E402
import tune_torch_stack_kernels as tune  # noqa: E402
from lightglue_tpu_torch.kernels import _build  # noqa: E402
from lightglue_tpu_torch.kernels import conv as conv_k  # noqa: E402
from lightglue_tpu_torch.precision import Precision, policy_for, precision_scope  # noqa: E402

RESIDENT = r'''
constexpr int RROWS = 8;       // output tile rows (pre-pool)
constexpr int RCOLS = 16;      // output tile cols
constexpr int RHR = RROWS + 2, RHC = RCOLS + 2;  // haloed tile
constexpr int RPA = C + 4;     // fp32 pixel pitch of the tile (68): an A column in 32 banks
constexpr int RPW = C + 8;     // fp32 weight row pitch (72): a B fragment in 32 banks
constexpr int RTHREADS = 256;  // 8 warps: 4 row pairs x 2 halves of the channels
constexpr size_t RES_SMEM = sizeof(float) * (9 * C * RPW + RHR * RHC * RPA);  // 214,848 B

__global__ void __launch_bounds__(RTHREADS, 1)
conv3x3_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ y, int H, int W,
                      int pool, int tiles_x, int tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);  // [9 * 64][RPW] raw fp32 weights
  float* xs = ws + 9 * C * RPW;                    // [RHR * RHC][RPA] one input tile
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rp = warp / 2, n0 = warp % 2 * 32;  // tile rows 2 rp + {0, 1}, channels n0..
  const int tiles_y = (H + RROWS - 1) / RROWS, per_image = tiles_x * tiles_y;
  for (int s = tid; s < 9 * C * (C / 4); s += RTHREADS) {
    const int r = s / (C / 4), c4 = s % (C / 4) * 4;
    lg::cp_async16(ws + r * RPW + c4, w + (size_t)r * C + c4);
  }
  float bv[4][2];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    bv[n][0] = __ldg(bias + n0 + n * 8 + 2 * t4);
    bv[n][1] = __ldg(bias + n0 + n * 8 + 2 * t4 + 1);
  }
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b = t / per_image, ty = t % per_image / tiles_x, tx = t % tiles_x;
    const int y0 = ty * RROWS, x0 = tx * RCOLS;
    __syncthreads();  // the previous tile is no longer read
    for (int s = tid; s < RHR * RHC * (C / 4); s += RTHREADS) {
      const int p = s / (C / 4), c4 = s % (C / 4) * 4;
      const int gy = y0 - 1 + p / RHC, gx = x0 - 1 + p % RHC;
      float* d = xs + p * RPA + c4;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        lg::cp_async16(d, x + (((size_t)b * H + gy) * W + gx) * C + c4);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    lg::cp_async_commit();
    lg::cp_async_wait<0>();
    __syncthreads();
    float acc[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll 2
      for (int k8 = 0; k8 < C / 8; ++k8) {
        unsigned ah[2][4], al[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float* px = xs + ((2 * rp + m + dy) * RHC + dx + g) * RPA + k8 * 8 + t4;
          lg::split_tf32(px[0], ah[m][0], al[m][0]);
          lg::split_tf32(px[8 * RPA], ah[m][1], al[m][1]);
          lg::split_tf32(px[4], ah[m][2], al[m][2]);
          lg::split_tf32(px[8 * RPA + 4], ah[m][3], al[m][3]);
        }
        const float* wk = ws + (tap * C + k8 * 8 + t4) * RPW + n0 + g;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          unsigned bh0, bl0, bh1, bl1;
          lg::split_tf32(wk[n * 8], bh0, bl0);
          lg::split_tf32(wk[4 * RPW + n * 8], bh1, bl1);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            lg::mma_tf32(acc[m][n], ah[m], bl0, bl1);
            lg::mma_tf32(acc[m][n], al[m], bh0, bh1);
            lg::mma_tf32(acc[m][n], ah[m], bh0, bh1);
          }
        }
      }
    }
    if (pool) {
      const int Ho = H / 2, Wo = W / 2, oy = y0 / 2 + rp;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            v[j] = fmaxf(fmaxf(acc[0][n][2 * i + j] + bv[n][j], 0.f),
                         fmaxf(acc[1][n][2 * i + j] + bv[n][j], 0.f));
            v[j] = fmaxf(v[j], __shfl_xor_sync(0xffffffffu, v[j], 4));
          }
          const int ox = x0 / 2 + (g + 8 * i) / 2;
          if (!(g & 1) && oy < Ho && ox < Wo)
            lg::store2(y + (((size_t)b * Ho + oy) * Wo + ox) * C + n0 + n * 8 + 2 * t4, v[0], v[1]);
        }
    } else {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int gy = y0 + 2 * rp + m;
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int gx = x0 + g + 8 * i;
            if (gy < H && gx < W)
              lg::store2(y + (((size_t)b * H + gy) * W + gx) * C + n0 + n * 8 + 2 * t4,
                         fmaxf(acc[m][n][2 * i] + bv[n][0], 0.f),
                         fmaxf(acc[m][n][2 * i + 1] + bv[n][1], 0.f));
          }
      }
    }
  }
}

int launch_tf32x3(const void* x, const void* w, const void* bias, void* y, int B, int H, int W,
                  int pool, cudaStream_t stream) {
  static int resident = 0;  // blocks the card runs at once
  if (!resident) {
    cudaError_t err = cudaFuncSetAttribute(conv3x3_tf32x3_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(RES_SMEM));
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv3x3_tf32x3_kernel,
                                                          RTHREADS, RES_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * max(per_sm, 1);
  }
  const int tiles_x = (W + RCOLS - 1) / RCOLS;
  const int tiles = B * tiles_x * ((H + RROWS - 1) / RROWS);
  conv3x3_tf32x3_kernel<<<min(tiles, resident), RTHREADS, RES_SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), H, W, pool, tiles_x, tiles);
  return static_cast<int>(cudaGetLastError());
}

'''


def resident(text):
    """conv3x3.cu with the streaming fp32 model conv replaced by RESIDENT."""
    start, end = text.index("constexpr int XK = 8;"), text.index("}  // namespace")
    return text[:start] + RESIDENT + text[end:]


def resource_usage(lib):
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "--dump-resource-usage", str(lib)], check=True,
                         capture_output=True, text=True).stdout
    name = None
    for line in out.splitlines():
        if "Function" in line:
            name = line.split("Function")[1].strip(" :")
        elif name and "REG:" in line and "tf32x3" in name:
            return " ".join(f for f in line.split() if f.split(":")[0] in ("REG", "STACK",
                                                                          "SHARED"))
    return "not found"


def main():
    builds = {"streaming (the source)": tune.build("fp32conv_streaming", "conv3x3.cu", tune.same,
                                                   tune.same),
              "resident weights": tune.build("fp32conv_resident", "conv3x3.cu", tune.same,
                                             resident)}
    for name, (d, proc) in builds.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed for {name}")
        print(f"{name}: {resource_usage(d / 'lib.so')}", flush=True)
    libs = {name: tune.load(d, ["lg_conv3x3"]) for name, (d, _) in builds.items()}

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    with precision_scope(policy_for(Precision.FP32)):
        for label, h, w, pool in (("conv1b+pool", 480, 640, True), ("conv2a", 240, 320, False),
                                  ("conv2b+pool", 240, 320, True)):
            x = torch.rand(2, h, w, 64, generator=gen, device=dev)
            wt = (torch.rand(3, 3, 64, 64, generator=gen, device=dev) * 2 - 1) / 24
            b = (torch.rand(64, generator=gen, device=dev) * 2 - 1) / 24
            lib = cs.cudnn_conv(wt, b, torch.float32, pool, True)
            xc = x.permute(0, 3, 1, 2)
            cases.append((label, x, wt, b, pool, conv_k.conv3x3_plain(x, wt, b, pool),
                          cs.cuda_ms(lambda: lib(xc))))
        print("cuDNN fp32, TF32 off: " + ", ".join(f"{c[0]} {c[6]:.4f}" for c in cases)
              + f"; per pair {sum(c[6] for c in cases):.4f} ms", flush=True)
        for name in (*libs, *list(libs)[::-1]):
            _build._lib = libs[name]
            times = []
            for label, x, wt, b, pool, want, _ in cases:
                cs.compare(f"{name} {label}", conv_k.conv3x3(x, wt, b, pool), want,
                           **cs.TOL["fp32"])
                times.append(cs.cuda_ms(lambda: conv_k.conv3x3(x, wt, b, pool)))
            print(f"{name}: " + ", ".join(f"{c[0]} {t:.4f}" for c, t in zip(cases, times))
                  + f"; per pair {sum(times):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
