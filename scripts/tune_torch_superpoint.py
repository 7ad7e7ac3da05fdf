"""Time variants of the SuperPoint side's two kernels on one CUDA card.

Each variant is a copy of ``csrc/nms.cu`` or ``csrc/stem.cu`` with one or
two launch constants changed, built into its own library under
``build/tune/`` (``tune_torch_stack_kernels.build``):

- ``nms.cu``: ``BAND_H`` (core rows of a block) and ``RUN`` (outputs a
  thread slides in registers per item of a pass), at the path's 2x480x640
  map, radius 4, cap 4;
- ``stem.cu``: ``TILE_H`` (rows of a block's 64-column tile) and ``PIX``
  (adjacent pixels per thread and step), at 2x480x640 in bf16 and fp32;
- ``nms.cu`` cut short: the kernel as it is, returning after one more phase
  each time (``CUTS``: the launch alone, the band's load, the pool of X,
  each re-admission round; the full kernel adds the top-k). The time up to
  each cut says where the kernel's time goes; a cut variant writes nothing,
  so only the full kernel is checked.

The port's wrappers run each variant: its output is checked against the
plain version exactly, then timed with ``chip_smoke.cuda_ms``, in one order
and then in the reverse one. From the root of a checkout, on a machine with
nvcc:

    python3 scripts/tune_torch_superpoint.py
"""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]

import chip_smoke as cs  # noqa: E402
import tune_torch_stack_kernels as tune  # noqa: E402
from lightglue_tpu_torch.kernels import _build  # noqa: E402
from lightglue_tpu_torch.kernels import nms as nms_k  # noqa: E402
from lightglue_tpu_torch.kernels import stem as stem_k  # noqa: E402

NMS = {f"band{h}_run{r}": (h, r) for h in (16, 32, 64) for r in (8, 16)}
STEM = {f"tile{h}_pix{p}": (h, p) for h in (4, 8, 16) for p in (1, 2, 4)}
# cut name -> the line of nms_candidates_kernel the block returns before
CUTS = {"launch": "  // every load of the band issued",
        "+ load": "  // keep = local max (out to margin R)",
        "+ pool of X": "  admit_round<R, 2 * R>(X, T, F, inside);",
        "+ round 1": "  admit_round<R, 4 * R>(X, T, F, inside);",
        "+ round 2": "  // the top `cap` of each 8x8 tile"}


def cut_before(line):
    def patch(text):
        if line not in text:
            raise ValueError(f"nms.cu has no line {line!r} to cut at")
        return text.replace(line, "  if (cap > 0) return;  // cut\n" + line, 1)
    return patch


def patched(**consts):
    def patch(text):
        for name, value in consts.items():
            text = tune.constant(name, value)(text)
        return text
    return patch


def main():
    builds = {("nms", name): tune.build("nms_" + name, "nms.cu", tune.same,
                                        patched(BAND_H=h, RUN=r))
              for name, (h, r) in NMS.items()}
    builds.update({("stem", name): tune.build("stem_" + name, "stem.cu", tune.same,
                                              patched(TILE_H=h, PIX=p))
                   for name, (h, p) in STEM.items()})
    builds.update({("cut", name): tune.build(f"nms_cut{i}", "nms.cu", tune.same, cut_before(line))
                   for i, (name, line) in enumerate(CUTS.items())})
    for key, (_, proc) in builds.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed for {key}")
    libs = {key: tune.load(d, ["lg_relu_conv1a_shift"] if key[0] == "stem"
                           else ["lg_nms_candidates"])
            for key, (d, _) in builds.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    raw = cs.nms_map(gen, dev, 2, 480, 640)
    want_nms = nms_k.nms_candidates_plain(raw)
    images = {dt: torch.rand(2, 480, 640, 1, generator=gen, device=dev).to(dt)
              for dt in (torch.bfloat16, torch.float32)}
    w = (torch.rand(3, 3, 1, 64, generator=gen, device=dev) * 2 - 1) / 3
    b = (torch.rand(64, generator=gen, device=dev) * 2 - 1) / 4
    want_stem = {dt: stem_k.relu_conv1a_shift_plain(x, w, b) for dt, x in images.items()}
    print(torch.cuda.get_device_name(0), flush=True)
    for keys in (list(libs), list(libs)[::-1]):
        for key in keys:
            _build._lib = libs[key]
            if key[0] == "cut":
                ms = cs.cuda_ms(lambda: nms_k.nms_candidates(raw))
                print(f"nms up to the cut, {key[1]}: {ms:.4f} ms per 2x480x640 map", flush=True)
                continue
            if key[0] == "nms":
                got = nms_k.nms_candidates(raw)
                for g, x in zip(got, want_nms):
                    cs.compare(f"nms {key[1]}", g, x, 0, 0, exact=True)
                ms = cs.cuda_ms(lambda: nms_k.nms_candidates(raw))
                print(f"nms {key[1]}: {ms:.4f} ms per 2x480x640 map", flush=True)
                continue
            times = []
            for dt, x in images.items():
                cs.compare(f"stem {key[1]} {dt}", stem_k.relu_conv1a_shift(x, w, b),
                           want_stem[dt], 0, 0, exact=True)
                times.append(cs.cuda_ms(lambda: stem_k.relu_conv1a_shift(x, w, b)))
            print(f"stem {key[1]}: {times[0]:.4f} ms bf16, {times[1]:.4f} ms fp32 per "
                  "2x480x640 pair", flush=True)


if __name__ == "__main__":
    main()
