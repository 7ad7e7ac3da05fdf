"""Helpers of the tune scripts that time a kernel's variants on one card
(``tune_torch_w8a8.py``, ``tune_torch_ln_gelu_conv.py``): a variant's text
edits (``replaced``), another checkout's source built with its own headers
(``build_tree``), a kernel's registers and shared memory
(``resource_usage``) and its most frequent SASS opcodes (``sass_mix``), and
cases checked and timed under each variant's library (``timed``).

The script once timed variants of the FP32 rung's mma.sync kernels,
``flash_attn.cu:flash_tf32_kernel`` and ``linear.cu:linear_tf32_kernel``;
their wgmma successors are timed by ``tune_torch_fp32_wgmma.py``.
"""

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]

import chip_smoke as cs  # noqa: E402
import tune_torch_stack_kernels as tune  # noqa: E402
from lightglue_tpu_torch.kernels import _build  # noqa: E402


def replaced(pairs):
    def patch(text):
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant: {old[:60]!r} is not in the source once")
            text = text.replace(old, new)
        return text
    return patch


def build_tree(name, csrc, source):
    """Another checkout's ``source`` with its own headers -> its library."""
    d = tune.OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for f in (*csrc.glob("*.cuh"), csrc / source):
        shutil.copy(f, d / f.name)
    return d, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(d / source),
                                "-o", str(d / "lib.so")])


def resource_usage(lib, kernels):
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "--dump-resource-usage", str(lib)], check=True,
                         capture_output=True, text=True).stdout
    usage, name = [], None
    for line in out.splitlines():
        if "Function" in line:
            name = line.split("Function")[1].strip(" :")
        elif name and "REG:" in line and any(k in name for k in kernels):
            usage.append(" ".join(f for f in line.split()
                                  if f.split(":")[0] in ("REG", "STACK", "SHARED")))
    return "; ".join(usage)


def sass_mix(lib, kernels):
    """The most frequent opcodes of the first matching kernel's SASS."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            if counts:
                break
            name = line.split("Function :")[1].strip()
            name = name if any(k in name for k in kernels) else None
        elif name and "/*" in line and ";" in line:
            words = line.split("*/", 1)[1].split()
            op = words[1] if words[0].startswith("@") else words[0]  # past a predicate
            counts[op.split(".")[0]] = counts.get(op.split(".")[0], 0) + 1
    return " ".join(f"{op} {n}" for op, n in sorted(counts.items(), key=lambda x: -x[1])[:10])


def timed(libs, cases):
    """Each case checked and timed under each library, in order and back."""
    for name in (*libs, *list(libs)[::-1]):
        _build._lib = libs[name]
        times = []
        for label, call, want, weight in cases:
            cs.compare(f"{name} {label}", call(), want, **cs.TOL["fp32"])
            times.append(weight * cs.cuda_ms(call))
        print(f"{name}: " + ", ".join(f"{c[0]} {t:.4f}" for c, t in zip(cases, times))
              + f"; sum {sum(times):.4f} ms", flush=True)
