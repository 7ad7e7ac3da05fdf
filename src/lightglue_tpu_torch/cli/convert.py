"""One-shot checkpoint converter: upstream .pth weights -> the .npz tree the
port's session and demo load (counterpart of ``lightglue_tpu/cli/convert.py``,
with its flags and its archive format).

The reference downloads ``superpoint_v1.pth`` and
``superpoint_lightglue_v0-1_arxiv.pth`` from the cvg/LightGlue GitHub release
at model construction (reference lightglue.py:305-306,336-341,
superpoint.py:132-133). This CLI converts those files, obtained out of band,
into one .npz archive ({superpoint, lightglue} trees). It reads them on the
CPU and needs no card.

Usage:
  python -m lightglue_tpu_torch.cli.convert \\
      --superpoint superpoint_v1.pth \\
      --lightglue superpoint_lightglue_v0-1_arxiv.pth \\
      --out weights.npz
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--superpoint", default=None, help="superpoint_v1.pth")
    p.add_argument("--lightglue", default=None, help="superpoint_lightglue_*.pth")
    p.add_argument("--out", required=True, help="output .npz path")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from lightglue_tpu_torch.runtime import weights

    if not args.superpoint and not args.lightglue:
        raise SystemExit("provide --superpoint and/or --lightglue")
    tree = {}
    if args.superpoint:
        sd = weights.load_torch_checkpoint(args.superpoint)
        tree["superpoint"] = weights.superpoint_from_state_dict(sd)
        print(f"converted SuperPoint: {len(sd)} tensors")
    if args.lightglue:
        sd = weights.load_torch_checkpoint(args.lightglue)
        tree["lightglue"] = weights.lightglue_from_state_dict(sd)
        print(f"converted LightGlue: {len(sd)} tensors")
    weights.save_npz(tree, args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
