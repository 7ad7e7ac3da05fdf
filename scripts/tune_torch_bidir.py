"""Time variants of the bidirectional kernel's launch on one CUDA card.

Each variant is a copy of ``csrc/bidir_cross.cu`` whose
``BIDIR_FILL_BLOCKS`` (the blocks its row-group rule aims for) is changed,
built into its own library under ``build/tune/``
(``tune_torch_stack_kernels.build``). The port's wrapper runs it at the
pad-to-64 path's shape, B = 1, 960 x 960, E = 256, H = 4: each output is
checked against the plain version, then timed with ``chip_smoke.cuda_ms``,
in one order and then in the reverse one. From the root of a checkout, on a
machine with nvcc:

    python3 scripts/tune_torch_bidir.py
"""

import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]

import chip_smoke as cs  # noqa: E402
import tune_torch_stack_kernels as tune  # noqa: E402
from lightglue_tpu_torch.kernels import _build  # noqa: E402
from lightglue_tpu_torch.kernels import attention as at  # noqa: E402

FILL = {"fill256": 256, "fill128": 128, "fill64": 64}  # bidir_cross.cu:BIDIR_FILL_BLOCKS


def main():
    builds = {name: tune.build("bidir_" + name, "bidir_cross.cu", tune.same,
                               tune.constant("BIDIR_FILL_BLOCKS", fill))
              for name, fill in FILL.items()}
    for name, (_, proc) in builds.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed for {name}")
    libs = {name: tune.load(d, ["lg_bidirectional_cross", "lg_bidir_plan"])
            for name, (d, _) in builds.items()}

    dev, bf16, e, n = torch.device("cuda"), torch.bfloat16, 256, cs.PAD64
    gen = torch.Generator(device=dev).manual_seed(0)
    a0, a1 = (torch.randn(1, n, 2 * e, generator=gen, device=dev).to(bf16) for _ in range(2))
    args = (a0[..., :e], a1[..., :e], a0[..., e:], a1[..., e:])  # [qk | v] slices
    kw = dict(num_heads=4, stat_dtype=bf16)
    want = at.bidirectional_cross_attention_plain(*args, **kw)
    print(torch.cuda.get_device_name(0), flush=True)
    for names in (list(libs), list(libs)[::-1]):
        for name in names:
            _build._lib = libs[name]
            got = at.bidirectional_cross_attention(*args, **kw)
            share = max(float((g != w).float().mean()) for g, w in zip(got, want))
            for i in (0, 1):
                cs.compare(f"{name} o{i}", got[i], want[i], **cs.TOL["bf16"])
            ms = cs.cuda_ms(lambda: at.bidirectional_cross_attention(*args, **kw))
            plan = (ctypes.c_int * 2)()
            libs[name].lg_bidir_plan(1, 4, n, n, plan)  # one pair
            groups = plan[0]
            print(f"bidirectional {name}: {groups} row groups, {ms:.4f} ms per call, "
                  f"{cs.N_LAYERS * ms:.3f} per pad-to-64 pair (differs in {share:.5f})", flush=True)


if __name__ == "__main__":
    main()
