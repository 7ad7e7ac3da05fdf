"""Time launch variants of the FP32 rung's 3xTF32 stack attention and
bidirectional kernel on one card, and the fp32 flash kernel beside a parent's.

``csrc/attention.cu:attention_tf32_kernel`` takes ``mma.cuh:fill_row_groups``'
16-row groups per block of four warps, aiming for ``FILL_BLOCKS`` = 256
blocks, but where that is one row group (its four warps splitting each
64-key chunk) and 32-row blocks still number 128, two groups share a block
of eight warps (``tf32_plan``): at the stack's B = 1, H = 4, N = 1024, 128
blocks of 32 rows. The variants: the rule aiming for 128 blocks (two row
groups of two warps, 32 rows) and 64 (four of one, 64 rows); and, on the
rule without its eight-warp blocks ("four warps": 256 blocks of 16 rows),
that design as it is, with the fp32 ``stage_rows`` loop at a compile-time
stride, and with the split warps' record laid over the idle chunk buffers
so that three one-group blocks fit an SM. ``csrc/bidir_cross.cu:
bidir_tf32_kernel`` aims for ``BIDIR_FILL_BLOCKS`` = 128 over both
directions' rows, as the bf16 kernel does; variants 256 and 64. Each
variant is a copy of the source with those lines or that constant changed
(``tune_torch_stack_kernels.build``), its registers and most
frequent SASS opcodes printed; the port's wrappers run it (``_build._lib``
set to its handle): ``attention`` at fp32 on the stack's self call (RoPE)
and cross call at 1024 (18 launches each per pair), the bidirectional
kernel at the pad-to-64 route's 960 x 960 (9 per pair), 960 x 704 and
960 x 64 (mixed buckets). Each output is checked against its plain version
at ``chip_smoke.TOL["fp32"]``, then timed with ``chip_smoke.cuda_ms``,
variants in one order and then the reverse. From the root of a checkout,
on a machine with nvcc:

    python3 scripts/tune_torch_fp32_stack_bidir.py [PARENT]

PARENT, the root of an earlier checkout: its ``flash_attn.cu`` and
``bidir_cross.cu`` (with its own headers; their C entries take the same
arguments) are built and timed beside this checkout's, in the same process
and on the same inputs, through this checkout's wrappers: the flash
kernel's FP32 ``fused_mha`` (self x9, cross x18 per 2048 pair),
``flash_attention`` and the ring step (x576 per ``forward_ring``), and the
bidirectional kernel.
"""

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]

import tune_torch_fp32_flash as flash_tune  # noqa: E402
import tune_torch_stack_kernels as tune  # noqa: E402
from lightglue_tpu_torch.kernels import attention as at  # noqa: E402
from lightglue_tpu_torch.kernels import layer_stack as ls  # noqa: E402
from lightglue_tpu_torch.precision import Precision, policy_for, precision_scope  # noqa: E402

# the rule without its eight-warp blocks: one row group of four warps a block
FOUR_WARPS = [("  if (G == 1 && (long long)B * H * ((Nq + 31) / 32) >= FILL_BLOCKS / 2) G = 2;\n",
               "")]
# the fp32 stage_rows' loop at the attention blocks' compile-time stride
FIXED_STRIDE = [("  for (int s = threadIdx.x; s < rows * (HD / 4); s += blockDim.x) {",
                 "  for (int s = threadIdx.x; s < rows * (HD / 4); s += WARPS * 32) {")]
# the split warps' record over the idle chunk buffers (18.9 KB less shared
# memory a four-warp block) and three one-row-group blocks an SM
THREE_BLOCKS = [
    ("  float* red = kv + TF32_STAGES * 2 * KC * FP;      // C > 1: [G * C][16][RS]",
     "  float* red = kv;  // C > 1: [G * C][16][RS], over the chunk buffers"),
    ("__global__ void __launch_bounds__(G * C * 32, G * C > WARPS ? 1 : 2)\n"
     "attention_tf32_kernel(",
     "__global__ void __launch_bounds__(G * C * 32, G * C > WARPS ? 1 : (C == 4 ? 3 : 2))\n"
     "attention_tf32_kernel("),
    ("  constexpr size_t smem = tf32_smem(C, TF32_STAGES, G);",
     "  constexpr size_t smem = tf32_smem(C, TF32_STAGES, G) -\n"
     "                         (C > 1 ? sizeof(float) * G * C * 16 * RS : 0);")]


def in_mma(pairs):
    """``replaced`` for mma.cuh; common.cuh (the other header) as it is."""
    patch = flash_tune.replaced(pairs)
    return lambda text: patch(text) if "stage_rows" in text else text


# name -> (header patch, attention.cu patch)
STACK = {"the source": (tune.same, tune.same),
         "fill128": (tune.constant("FILL_BLOCKS", 128), tune.same),
         "fill64": (tune.constant("FILL_BLOCKS", 64), tune.same),
         "four warps": (tune.same, flash_tune.replaced(FOUR_WARPS)),
         "four warps, fixed stride": (in_mma(FIXED_STRIDE), flash_tune.replaced(FOUR_WARPS)),
         "four warps, three blocks an SM": (tune.same,
                                            flash_tune.replaced(FOUR_WARPS + THREE_BLOCKS))}
BIDIR = {"fill128 (the source)": 128, "fill256": 256, "fill64": 64}  # BIDIR_FILL_BLOCKS


def main():
    stack = {name: tune.build(f"fp32att_{i}", "attention.cu", *patches)
             for i, (name, patches) in enumerate(STACK.items())}
    bidir = {name: tune.build("fp32bidir_" + name.split()[0], "bidir_cross.cu", tune.same,
                              tune.constant("BIDIR_FILL_BLOCKS", fill))
             for name, fill in BIDIR.items()}
    flash = {"source": tune.build("fp32flash_src", "flash_attn.cu", tune.same, tune.same)}
    if len(sys.argv) > 1:  # the parent's kernels, timed beside
        csrc = Path(sys.argv[1]).resolve() / "src" / "lightglue_tpu_torch" / "csrc"
        flash["parent"] = flash_tune.build_tree("fp32flash_parent", csrc, "flash_attn.cu")
        bidir["parent"] = flash_tune.build_tree("fp32bidir_parent", csrc, "bidir_cross.cu")
    for group, kernels in ((stack, ("attention_tf32_kernel",)),
                           (bidir, ("bidir_tf32_kernel", "bidir_kernel")),
                           (flash, ("flash_tf32_wgmma_kernel", "flash_tf32_kernel"))):
        for name, (d, proc) in group.items():
            if proc.wait():
                raise RuntimeError(f"nvcc failed for {name}")
            print(f"{name}: {flash_tune.resource_usage(d / 'lib.so', kernels)}; "
                  f"{flash_tune.sass_mix(d / 'lib.so', kernels)}", flush=True)
    stack_libs = {n: tune.load(d, ["lg_attention", "lg_rope_qk"]) for n, (d, _) in stack.items()}
    bidir_libs = {n: tune.load(d, ["lg_bidirectional_cross"]) for n, (d, _) in bidir.items()}
    flash_libs = {n: tune.load(d, ["lg_fused_mha", "lg_flash_attention",
                                   "lg_flash_attention_step"]) for n, (d, _) in flash.items()}

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    e, hd, f32 = 256, 64, torch.float32
    qkv = rand(1, 1024, 3 * e)
    ang = rand(1, 1024, hd // 2) * 2
    freqs = torch.cat([torch.stack([torch.cos(ang), torch.sin(ang)], 1)] * 2, -1).contiguous()
    q, kv = rand(1, 1024, e), rand(1, 1024, 2 * e)
    self_args = (qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:], freqs, None, None, 4, f32)
    cross_args = (q, kv[..., :e], kv[..., e:], None, None, None, 4, f32)
    bidir_in = {}
    for n0, n1, w in ((960, 960, 9), (960, 704, 0), (960, 64, 0)):
        a0, a1 = rand(1, n0, 2 * e), rand(1, n1, 2 * e)
        bidir_in[f"{n0}x{n1}" + (f" x{w}" if w else "")] = (
            (a0[..., :e], a1[..., :e], a0[..., e:], a1[..., e:]), max(w, 1))
    fq, fk, fv = (rand(2, 4, 2048, hd) for _ in range(3))
    qkv2, q1, kv1 = rand(2, 2048, 3 * e), rand(1, 2048, e), rand(1, 2048, 2 * e)
    ang2 = rand(2, 2048, hd // 2) * 2
    freqs2 = torch.cat([torch.stack([torch.cos(ang2), torch.sin(ang2)], 1)] * 2, -1).contiguous()
    sq, sk, sv = (rand(1, 4, 512, hd) for _ in range(3))
    carries = (rand(1, 4, 512, 1), 1.0 + rand(1, 4, 512, 1).abs(), rand(1, 4, 512, hd))
    ln = torch.tensor([[2048, 2048]], dtype=torch.int32, device=dev)
    with precision_scope(policy_for(Precision.FP32)):
        flash_tune.timed(stack_libs, [
            (label, lambda a=a: ls.attention(*a), ls.attention_plain(*a), 18)
            for label, a in (("self rope x18", self_args), ("cross x18", cross_args))])
        flash_tune.timed(bidir_libs, [
            (label, lambda a=a: torch.cat(at.bidirectional_cross_attention(*a, num_heads=4), 1),
             torch.cat(at.bidirectional_cross_attention_plain(*a, num_heads=4), 1), w)
            for label, (a, w) in bidir_in.items()])
        fused_self = (qkv2[..., :e], qkv2[..., e:2 * e], qkv2[..., 2 * e:], freqs2)
        fused_cross = (q1, kv1[..., :e], kv1[..., e:])
        step = (sq, sk, sv, *carries, ln, 512, 1024)
        flash_tune.timed(flash_libs, [
            ("fused self x9", lambda: at.fused_mha(*fused_self, num_heads=4),
             at.fused_mha_plain(*fused_self, num_heads=4), 9),
            ("fused cross x18", lambda: at.fused_mha(*fused_cross, num_heads=4),
             at.fused_mha_plain(*fused_cross, num_heads=4), 18),
            ("flash x1", lambda: at.flash_attention(fq, fk, fv),
             at.flash_attention_plain(fq, fk, fv), 1),
            ("step x576", lambda: at.flash_attention_step(*step)[2],
             at.flash_attention_step_plain(*step)[2], 576)])


if __name__ == "__main__":
    main()
