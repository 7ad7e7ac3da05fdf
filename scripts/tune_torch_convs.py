"""Time launch variants of the generic bf16 conv on one CUDA card.

Each variant is a copy of ``csrc/conv3x3.cu`` with a launch constant or
the register bound changed, built into its own library under
``build/tune/`` (``tune_torch_stack_kernels.build``):

- ``CONV_FILL``: the blocks the tile rule aims for (132, one per SM; 264,
  the source's; 528), which sets the tile's rows at SuperPoint's small maps;
- ``GSTAGES``: the K chunks in the cp.async ring (2, the source's, or 3);
- ``free regs``: without the source's ``__launch_bounds__`` minimum of 512 /
  threads blocks an SM, so the compiler may take more than 128 registers a
  thread and two 256-thread blocks no longer share an SM.

Before timing, ``cuobjdump --dump-resource-usage`` prints each variant's
registers and stack per kernel. At SuperPoint's four C >= 128 shapes for a
2x480x640 batch (``chip_smoke.GENERIC_CONVS``), the port's wrapper runs
each variant: its output is checked against the plain version at
``chip_smoke.TOL``, then timed with ``chip_smoke.cuda_ms``, in one order and
then in the reverse one, cuDNN beside it. From the root of a checkout, on a
machine with nvcc:

    python3 scripts/tune_torch_convs.py
"""

import ctypes
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

BOUNDS = "__launch_bounds__(ROWS / 2 * 32, 512 / (ROWS / 2 * 32))"


def patched(fill=264, stages=2, free_regs=False):
    patches = [tune.constant("CONV_FILL", fill), tune.constant("GSTAGES", stages)]

    def patch(text):
        for p in patches:
            text = p(text)
        if free_regs:
            if BOUNDS not in text:
                raise ValueError(f"conv3x3.cu has no {BOUNDS!r}")
            text = text.replace(BOUNDS, "__launch_bounds__(ROWS / 2 * 32)", 1)
        return text
    return patch


VARIANTS = {"fill264 s2": {}, "fill132 s2": dict(fill=132), "fill528 s2": dict(fill=528),
            "fill264 s3": dict(stages=3), "fill264 s2 free regs": dict(free_regs=True)}


def resource_usage(lib):
    """Registers and stack of each conv3x3_igemm_kernel instantiation in lib."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "--dump-resource-usage", str(lib)], check=True,
                         capture_output=True, text=True).stdout
    rows, name = [], None
    for line in out.splitlines():
        if "Function" in line:
            name = line.split("Function")[1].strip(" :")
        elif name and "REG:" in line and "igemm" in name:
            fields = dict(f.split(":", 1) for f in line.split() if ":" in f)
            tmpl = name[name.find("igemm_kernel") + len("igemm_kernel"):][:40]
            rows.append(f"{tmpl} REG {fields.get('REG')} STACK {fields.get('STACK')} "
                        f"SHARED {fields.get('SHARED')}")
    return rows


def main():
    builds = {name: tune.build("conv_" + name.replace(" ", "_"), "conv3x3.cu", tune.same,
                               patched(**v))
              for name, v in VARIANTS.items()}
    for name, (d, proc) in builds.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed for {name}")
        for line in resource_usage(d / "lib.so"):
            print(f"{name}: {line}", flush=True)
    libs = {name: tune.load(d, ["lg_conv3x3", "lg_conv_tile"]) for name, (d, _) in builds.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.float32, uniform=False):
        f = torch.rand if uniform else torch.randn
        return f(*shape, generator=gen, device=dev).to(dtype)

    cases = []
    for label, h, w, cin, cout, pool, relu in cs.GENERIC_CONVS:
        x = rand(2, h, w, cin, uniform=True, dtype=torch.bfloat16)
        wt, b = cs.conv_weights(rand, cin, cout, torch.bfloat16)
        lib = cs.cudnn_conv(wt, b, torch.bfloat16, pool, relu)
        xc = x.permute(0, 3, 1, 2)
        cases.append((label, x, wt, b, pool, relu, conv_k.conv3x3_plain(x, wt, b, pool, relu=relu),
                      cs.cuda_ms(lambda: lib(xc)), (h, w, cout)))
    print(torch.cuda.get_device_name(0), flush=True)
    print("cuDNN: " + ", ".join(f"{c[0]} {c[7]:.4f}" for c in cases)
          + f"; sum {sum(c[7] for c in cases):.4f} ms", flush=True)
    tile = (ctypes.c_int * 4)()
    for names in (list(libs), list(libs)[::-1]):
        for name in names:
            _build._lib = libs[name]
            times = []
            for label, x, wt, b, pool, relu, want, _, (h, w, cout) in cases:
                got = conv_k.conv3x3(x, wt, b, pool, relu=relu)
                cs.compare(f"{name} {label}", got, want, **cs.TOL["bf16"])
                libs[name].lg_conv_tile(2, h, w, cout, tile)
                times.append((cs.cuda_ms(lambda: conv_k.conv3x3(x, wt, b, pool, relu=relu)),
                              f"{tile[0]} rows, {tile[2]} blocks"))
            print(f"{name}: " + ", ".join(f"{t:.4f} ({p})" for t, p in times)
                  + f"; sum {sum(t for t, _ in times):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
