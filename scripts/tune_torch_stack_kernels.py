"""Time variants of the layer stack's bf16 kernels on one CUDA card.

Each variant is a copy of ``csrc/linear.cu`` (K chunk depth, ring buffers,
the block count its tile rule aims for) or of ``csrc/attention.cu`` (the
block count behind its row-group rule) with one constant changed, built
into its own library under ``build/tune/``. The port's wrappers run it
(``_build._lib`` set to its handle) at the main path's shapes, B = 1,
N = 1024, E = 256, H = 4: each output is checked against the plain version,
then timed with ``chip_smoke.cuda_ms``. Variants run in one order and then
in the reverse one; the per-pair sums weight each shape by its launches in
one ``match_pair``. From the root of a checkout, on a machine with nvcc:

    python3 scripts/tune_torch_stack_kernels.py
"""

import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from lightglue_tpu_torch.kernels import _build  # noqa: E402
from lightglue_tpu_torch.kernels import layer_stack as ls  # noqa: E402

SRC = ROOT / "src" / "lightglue_tpu_torch" / "csrc"
OUT = ROOT / "build" / "tune"
# name -> (K chunk depth, ring buffers, blocks the tile rule aims for)
LINEAR = {"bk32 s3 mb128": (32, 3, 128), "bk64 s3 mb128": (64, 3, 128),
          "bk32 s6 mb128": (32, 6, 128), "bk64 s4 mb128": (64, 4, 128),
          "bk32 s3 mb256": (32, 3, 256), "bk64 s3 mb256": (64, 3, 256),
          "bk32 s16 mb128": (32, 16, 128), "bk64 s8 mb128": (64, 8, 128)}
ATTENTION = {"fill256": 256, "fill128": 128, "fill64": 64}  # mma.cuh:FILL_BLOCKS


def build(name, source, header_patch, source_patch):
    """Patched copies of the headers and one source -> its library (a process)."""
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for h in ("common.cuh", "mma.cuh"):
        (d / h).write_text(header_patch((SRC / h).read_text()))
    (d / source).write_text(source_patch((SRC / source).read_text()))
    return d, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(d / source),
                                "-o", str(d / "lib.so")])


def constant(name, value):
    return lambda text: re.sub(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                               text)


def load(d, names):
    handle = ctypes.CDLL(str(d / "lib.so"))
    for n in names:
        fn = getattr(handle, n)
        fn.argtypes, fn.restype = _build._SIGNATURES[n], ctypes.c_int
    return handle


def same(text):
    return text


def main():
    builds = {}
    for name, (bk, stages, blocks) in LINEAR.items():
        patch = (constant("MMA_BK", bk), constant("MMA_STAGES", stages),
                 constant("MIN_BLOCKS", blocks))
        builds[name] = build("lin_" + name.replace(" ", "_"), "linear.cu", same,
                             lambda t, p=patch: p[2](p[1](p[0](t))))
    for name, fill in ATTENTION.items():
        builds[name] = build("att_" + name, "attention.cu", constant("FILL_BLOCKS", fill), same)
    for name, (_, proc) in builds.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed for {name}")

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=bf16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    e, m = 256, 1024
    print(torch.cuda.get_device_name(0), flush=True)
    # label, K1, K2, N, residual, launches per match_pair (chip_smoke.py's cases)
    shapes = [("qkv", e, 0, 3 * e, False, 18), ("out", e, 0, e, False, 36),
              ("ffn1", e, e, 2 * e, False, 36), ("ffn2", 2 * e, 0, e, True, 36),
              ("qk_v", e, 0, 2 * e, False, 18)]
    cases = []
    for label, k1, k2, n, res, weight in shapes:
        w = (rand(k1 + k2, n, dtype=torch.float32) / math.sqrt(k1 + k2)).to(bf16)
        b = (rand(n, dtype=torch.float32) / math.sqrt(k1 + k2)).to(bf16)
        cases.append((label, rand(1, m, k1), rand(1, m, k2) if k2 else None, w, b,
                      rand(1, m, n) if res else None, weight))
    for label, a, a2, w, b, r, _ in cases:
        a_cat = a if a2 is None else torch.cat([a, a2], -1)
        print(f"addmm {label}: {cs.cuda_ms(lambda: torch.addmm(b, a_cat[0], w)):.4f} ms")
    libs = {name: load(d, ["lg_linear"]) for name, (d, _) in builds.items() if name in LINEAR}
    for names in (list(libs), list(libs)[::-1]):
        for name in names:
            _build._lib = libs[name]
            total, parts = 0.0, []
            for label, a, a2, w, b, r, weight in cases:
                got, want = ls.linear(a, w, b, a2=a2, residual=r), ls.linear_plain(a, w, b, a2, r)
                cs.compare(f"{name} {label}", got, want, **cs.TOL["bf16"])
                ms = cs.cuda_ms(lambda: ls.linear(a, w, b, a2=a2, residual=r))
                total += weight * ms
                parts.append(f"{label} {ms:.4f}")
            print(f"linear {name}: per pair {total:.3f} ms | " + ", ".join(parts), flush=True)

    qkv = rand(1, m, 3 * e)
    ang = torch.rand(1, m, 32, generator=gen, device=dev) * 4
    emb = torch.stack([torch.cos(ang), torch.sin(ang)], 1)
    freqs = torch.cat([emb, emb], -1).contiguous()
    kv = rand(1, m, 2 * e)
    calls = (("self rope", (qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:], freqs)),
             ("cross", (rand(1, m, e), kv[..., :e], kv[..., e:], None)))
    libs = {name: load(d, ["lg_attention", "lg_rope_qk"]) for name, (d, _) in builds.items()
            if name in ATTENTION}
    for names in (list(libs), list(libs)[::-1]):
        for name in names:
            _build._lib = libs[name]
            parts = []
            for label, args in calls:
                got = ls.attention(*args, None, None, 4, bf16)
                want = ls.attention_plain(*args, None, None, 4, bf16)
                share = float((got != want).float().mean())
                ms = cs.cuda_ms(lambda: ls.attention(*args, None, None, 4, bf16))
                parts.append(f"{label} {ms:.4f} ms (differs in {share:.5f})")
            print(f"attention {name}: " + ", ".join(parts), flush=True)


if __name__ == "__main__":
    main()
