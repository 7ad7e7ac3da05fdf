"""Derive the 9-layer stack gates of the MIXED, INT8 and W8A8 rungs from
measured error growth, as scripts/derive_bf16_bound.py derives the BF16 one.

Two implementations of the same stack with the same rounding points and
fp32 sums in another order drift apart layer by layer: a sum that lands on
the other side of a bf16 (or, under W8A8, an int8) rounding boundary flips
that rounding, and the flip travels on. This measures that drift between the
PyTorch port's plain stack (``transformer_stack_plain``, on the CPU) and the
JAX ``transformer_stack`` (Pallas interpret mode) on the same weights and
inputs: max |port - JAX| after 1..9 layers of one 9-layer random tree, at
1x128x128, unmasked, for two input seeds. The envelope is the largest of
those up to 9 layers (the drift does not grow monotonically), and
``chip_smoke.py`` gates its 9-layer comparisons of a rung's kernels against
their plain versions at twice it, the rule of golden/bf16_layer_err_r05.txt.

Run: python scripts/derive_rung_stack_envelope.py  (CPU only, ~2 minutes)
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from lightglue_tpu import quant as jax_quant  # noqa: E402
from lightglue_tpu.config import LightGlueConfig  # noqa: E402
from lightglue_tpu.kernels import layer_stack as jax_stack  # noqa: E402
from lightglue_tpu.runtime import weights as jax_weights  # noqa: E402
from lightglue_tpu_torch import quant  # noqa: E402
from lightglue_tpu_torch.kernels import layer_stack  # noqa: E402
from lightglue_tpu_torch.runtime import weights  # noqa: E402

N_LAYERS, N, E = 9, 128, 256
# rung: (activation dtypes (JAX, torch), LGTPU_W8A8)
RUNGS = {"mixed": ((jnp.float32, torch.float32), False),
         "int8": ((jnp.bfloat16, torch.bfloat16), False),
         "w8a8": ((jnp.bfloat16, torch.bfloat16), True)}


def inputs(seed, wr):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        d = rng.standard_normal((1, N, E), dtype=np.float32)
        ang = rng.uniform(-1, 1, (1, N, 2)).astype(np.float32) @ wr
        emb = np.stack([np.cos(ang), np.sin(ang)], axis=1)
        out += [d, np.concatenate([emb, emb], axis=-1).astype(np.float32)]
    return out


def first(tree, n):
    return {k: first(v, n) if isinstance(v, dict) else v[:n] for k, v in tree.items()}


def main():
    tree = jax_weights.init_lightglue(0, LightGlueConfig(n_layers=N_LAYERS))
    qtree = quant.quantize_lightglue(tree)
    for rung, ((jdt, tdt), w8a8) in RUNGS.items():
        os.environ["LGTPU_W8A8"] = "1" if w8a8 else "0"
        jax.clear_caches()  # JAX reads the switch when it traces the stack
        if rung == "mixed":
            jlayers = jax_weights.to_jax(tree, jnp.float32)["layers"]
            tlayers = weights.params_from_numpy(tree, "cpu", torch.float32)["layers"]
        else:
            jlayers = jax_weights.to_jax(jax_quant.quantize_lightglue(tree))["layers"]
            tlayers = weights.params_from_numpy(qtree)["layers"]
        stat = jdt, tdt
        print(f"{rung}: layers  max|port - JAX|  max|JAX|  (1x{N}x{N}, seeds 1 and 2)")
        envelope = 0.0
        for depth in range(1, N_LAYERS + 1):
            errs, refs = [], []
            for seed in (1, 2):
                d0, f0, d1, f1 = inputs(seed, tree["posenc"]["wr"])
                want = jax_stack.transformer_stack(
                    jax.tree.map(lambda a: a[:depth], jlayers), jnp.asarray(d0, jdt),
                    jnp.asarray(d1, jdt), jnp.asarray(f0), jnp.asarray(f1), None, None,
                    num_heads=4, head_dim=64, stat_dtype=stat[0], attn_dtype=jnp.bfloat16)
                got = layer_stack.transformer_stack_plain(
                    first(tlayers, depth), torch.from_numpy(d0).to(tdt),
                    torch.from_numpy(d1).to(tdt), torch.from_numpy(f0), torch.from_numpy(f1),
                    None, None, num_heads=4, head_dim=64, stat_dtype=stat[1],
                    attn_dtype=torch.bfloat16)
                for g, w in zip(got, want):
                    w = np.asarray(w, np.float32)
                    errs.append(float(np.abs(g.float().numpy() - w).max()))
                    refs.append(float(np.abs(w).max()))
            envelope = max(envelope, *errs)
            print(f"  {depth:5d}  {max(errs):.4f}  {max(refs):.3f}")
        print(f"{rung}: envelope up to {N_LAYERS} layers {envelope:.4f}; gate (2x envelope) "
              f"{2 * envelope:.4f}")


if __name__ == "__main__":
    main()
