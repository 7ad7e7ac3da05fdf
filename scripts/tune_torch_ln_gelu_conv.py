"""Time the FFN's LayerNorm + GELU and the generic fp32 conv on one card:
csrc/ln_gelu.cu's ln_gelu_kernel and csrc/conv3x3.cu's
conv3x3_tf32x3_generic_kernel, their variants, and a parent checkout's.

Each variant is a copy of the source with one constant or a few lines
changed, built into its own library under ``build/tune/``
(``tune_torch_stack_kernels.build``), its registers and most frequent SASS
opcodes printed. ``ln_gelu`` variants:

- the source: 32 lanes a row, 16-byte vectors, 128-thread blocks, gamma,
  beta and the row loaded together after the wait for the previous kernel,
  launched as a programmatic dependent (``LN_PDL``);
- ``LN_PDL`` 0: a plain launch;
- gamma and beta loaded before the wait (``BEFORE_WAIT``), while the
  previous kernel may still run;
- 16 lanes a row (two rows a warp, twice the vectors a lane);
- 64- and 256-thread blocks.

The generic fp32 conv's variants: the source (truncating split, 12-row
tiles of six warps, two blocks an SM: 170 registers a thread at most), the
split by rounding (``cvt.rna``, ``mma.cuh:split_tf32``), tiles of 16, 14
and 10 rows (``TF32_ROWS``; 16 rows hold a thread to 128 registers), and
registers unbounded (a launch bound of one block an SM). Each conv
library's local-memory loads and stores per generic instantiation are
counted in its SASS.

PARENT, the root of an earlier checkout whose ``lg_ln_gelu`` and
``lg_conv3x3`` take the same arguments: its ``ln_gelu.cu`` and
``conv3x3.cu`` (with its own headers) are built and timed first and last.
``ln_gelu`` runs at the stack's 1024 x 512 rows in its three modes (FP32,
BF16, INT8's bf16 rows with fp32 gamma and beta) and as the stack runs it,
between ffn1 and ffn2 (the GEMMs of this checkout's library) in bf16 and
fp32; the conv at SuperPoint's four C >= 128 shapes of a 2x480x640 batch
(``chip_smoke.GENERIC_CONVS``), fp32 in and out. Every output is checked
against its plain version at ``chip_smoke.TOL``, then timed with
``chip_smoke.cuda_ms``; libraries in one order and then the reverse. From
the root of a checkout, on a machine with nvcc:

    python3 scripts/tune_torch_ln_gelu_conv.py [PARENT]
"""

import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]

import chip_smoke as cs  # noqa: E402
import tune_torch_fp32_flash as flash_tune  # noqa: E402
import tune_torch_stack_kernels as tune  # noqa: E402
from lightglue_tpu_torch.kernels import _build  # noqa: E402
from lightglue_tpu_torch.kernels import conv as conv_k  # noqa: E402
from lightglue_tpu_torch.kernels import layer_stack as ls  # noqa: E402
from lightglue_tpu_torch.precision import Precision, policy_for, precision_scope  # noqa: E402

WAIT = """  lg::wait_prerequisites();  // the rows, and anything else the previous kernel wrote
  const bool live = row < M && !(exit_reg && !(exit_reg[row / rows_per_pair] >
                                               static_cast<float>(layer)));
  const int width = live ? C : 0;  // lanes past the last row or retired load nothing
"""
GB = """    load_cols(gamma + c, g[j], vec && c < width, width - c);
    load_cols(beta + c, b[j], vec && c < width, width - c);
"""
BEFORE_WAIT = [(WAIT, ""), (GB, GB.replace("width", "C")),
               ("  const T* xr = x + (size_t)row * C;", WAIT + "  const T* xr = x + (size_t)row * C;")]
LN_VARIANTS = {"source": tune.same,
               "no PDL": tune.constant("LN_PDL", 0),
               "gamma/beta before the wait": flash_tune.replaced(BEFORE_WAIT),
               "16 lanes a row": tune.constant("ROW_LANES", 16),
               "64-thread blocks": tune.constant("LN_THREADS", 64),
               "256-thread blocks": tune.constant("LN_THREADS", 256)}
BOUND = "__launch_bounds__(TF32_THREADS, 2)"
CONV_VARIANTS = {"source": tune.same,
                 "split by rounding": lambda t: t.replace("lg::split_tf32_rz(", "lg::split_tf32("),
                 "16 rows": tune.constant("TF32_ROWS", 16),
                 "14 rows": tune.constant("TF32_ROWS", 14),
                 "10 rows": tune.constant("TF32_ROWS", 10),
                 "registers unbounded": flash_tune.replaced(
                     [(BOUND, BOUND.replace("2)", "1)"))])}
LN_MODES = {"fp32": (torch.float32, torch.float32), "bf16": (torch.bfloat16, torch.bfloat16),
            "int8": (torch.bfloat16, torch.float32)}


def local_memory(lib, kernel):
    """(local loads, local stores) in the SASS of each function named with
    ``kernel``: a spill shows as both."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    counts, name = [], None
    for line in sass.splitlines():
        if "Function :" in line:
            name = kernel in line
            if name:
                counts.append([0, 0])
        elif name:
            counts[-1][0] += " LDL" in line
            counts[-1][1] += " STL" in line
    return counts


def built(variants, source, prefix, parent):
    builds = {name: tune.build(f"{prefix}_{i}", source, tune.same, patch)
              for i, (name, patch) in enumerate(variants.items())}
    if parent:
        csrc = Path(parent).resolve() / "src" / "lightglue_tpu_torch" / "csrc"
        builds = {"parent": flash_tune.build_tree(f"{prefix}_parent", csrc, source), **builds}
    return builds


def main():
    parent = sys.argv[1] if len(sys.argv) > 1 else None
    ln_builds = built(LN_VARIANTS, "ln_gelu.cu", "ln", parent)
    conv_builds = built(CONV_VARIANTS, "conv3x3.cu", "gconv", parent)
    _build.lib()  # this checkout's library: the GEMMs around ln_gelu
    libs = {}
    for group, kernels, fn in ((ln_builds, ("ln_gelu_kernel",), "lg_ln_gelu"),
                               (conv_builds, ("conv3x3_tf32x3_generic_kernel", "conv3x3_kernel"),
                                "lg_conv3x3")):
        libs[fn] = {}
        for name, (d, proc) in group.items():
            if proc.wait():
                raise RuntimeError(f"nvcc failed for {fn} {name}")
            print(f"{fn} {name}: {flash_tune.resource_usage(d / 'lib.so', kernels)}; "
                  f"{flash_tune.sass_mix(d / 'lib.so', kernels)}", flush=True)
            if fn == "lg_conv3x3":
                print(f"  local (loads, stores) per instantiation: "
                      f"{local_memory(d / 'lib.so', kernels[0])}; the model conv's "
                      f"{local_memory(d / 'lib.so', 'conv3x3_tf32x3_kernel')}", flush=True)
            libs[fn][name] = tune.load(d, [fn])

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    rand = cs.seeded_rand(dev, 0)
    per_pair = 4 * cs.N_LAYERS
    e, m = 256, cs.BUCKET
    cases = {}
    for tag, (dt, gt) in LN_MODES.items():
        g, b = (1 + 0.3 * rand(2 * e)).to(gt), (0.3 * rand(2 * e)).to(gt)
        h = rand(1, m, 2 * e, dtype=dt)
        cases[tag] = (h, g, b, torch.empty_like(h), ls.ln_gelu_plain(h, g, b))
    gemms = {}
    for tag in ("bf16", "fp32"):
        dt = LN_MODES[tag][0]
        w1, b1 = (rand(2 * e, 2 * e) / math.sqrt(2 * e)).to(dt), (rand(2 * e) / 32).to(dt)
        w2, b2 = (rand(2 * e, e) / math.sqrt(2 * e)).to(dt), (rand(e) / 32).to(dt)
        x, msg = rand(1, m, e, dtype=dt), rand(1, m, e, dtype=dt)
        gemms[tag] = (w1, b1, w2, b2, x, msg)

    def ln(lib, h, g, b, y):
        _build.check(lib.lg_ln_gelu(h.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
                                    h.numel() // h.shape[-1], h.shape[-1], None, 0, 1,
                                    ls._LN_MODES[(h.dtype, g.dtype)],
                                    torch.cuda.current_stream().cuda_stream), "ln_gelu")
        return y

    def triple(lib, tag):
        h, g, b, y, _ = cases[tag]
        w1, b1, w2, b2, x, msg = gemms[tag]
        return ls.linear(ln(lib, ls.linear(x, w1, b1, a2=msg), g, b, y), w2, b2, residual=x)

    ln_libs = libs["lg_ln_gelu"]
    for name in (*ln_libs, *list(ln_libs)[::-1]):
        lib, parts = ln_libs[name], []
        for tag, (h, g, b, y, want) in cases.items():
            cs.compare(f"{name} ln_gelu {tag}", ln(lib, h, g, b, y), want,
                       **cs.TOL["fp32" if tag == "fp32" else "bf16"])
            parts.append(f"{tag} {per_pair * cs.cuda_ms(lambda: ln(lib, h, g, b, y)):.4f}")
        for tag in gemms:
            parts.append(f"ffn triple {tag} {per_pair * cs.cuda_ms(lambda: triple(lib, tag)):.4f}")
        print(f"ln_gelu {name}: ms per match_pair (x{per_pair}): " + ", ".join(parts), flush=True)

    with precision_scope(policy_for(Precision.FP32)):  # the plain versions in true fp32
        convs = []
        for label, h, w, cin, cout, pool, relu in cs.GENERIC_CONVS:
            x = rand(2, h, w, cin, uniform=True)
            wt, b = cs.conv_weights(rand, cin, cout, torch.float32)
            convs.append((label, x, wt, b, pool, relu,
                          conv_k.conv3x3_plain(x, wt, b, pool, relu=relu)))
        conv_libs = libs["lg_conv3x3"]
        for name in (*conv_libs, *list(conv_libs)[::-1]):
            _build._lib = conv_libs[name]
            times = []
            for label, x, wt, b, pool, relu, want in convs:
                cs.compare(f"{name} {label}", conv_k.conv3x3(x, wt, b, pool, relu=relu), want,
                           **cs.TOL["fp32"])
                times.append(cs.cuda_ms(lambda: conv_k.conv3x3(x, wt, b, pool, relu=relu)))
            print(f"conv3x3 fp32 {name}: " + ", ".join(f"{c[0]} {t:.4f}"
                                                       for c, t in zip(convs, times))
                  + f"; the four {sum(times):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
