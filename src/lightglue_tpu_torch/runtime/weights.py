"""Parameter trees: random initialization, npz IO and conversion to tensors.

``init_superpoint`` / ``init_lightglue`` draw the same
``np.random.default_rng(seed)`` stream as ``lightglue_tpu/runtime/weights.py``
(:71-127, :321-336), so one seed gives equal numpy trees in both packages;
``save_npz`` / ``load_npz`` read and write the JAX package's archives.
``params_from_numpy`` turns such a numpy tree into the port's tensors and is
the one place where the port's layouts differ from the JAX package's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from lightglue_tpu_torch.config import LightGlueConfig, SuperPointConfig


def _linear_init(rng: np.random.Generator, fan_in: int, fan_out: int):
    bound = 1.0 / np.sqrt(fan_in)
    return {
        "w": rng.uniform(-bound, bound, (fan_in, fan_out)).astype(np.float32),
        "b": rng.uniform(-bound, bound, (fan_out,)).astype(np.float32),
    }


def _stack(trees):
    """Stack a list of equally-shaped dict trees leaf by leaf on a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees, axis=0)


def init_lightglue(
    seed: int = 0, config: LightGlueConfig = LightGlueConfig()
) -> Dict:
    """Random LightGlue parameter tree (numpy, fp32), JAX layout."""
    rng = np.random.default_rng(seed)
    e = config.descriptor_dim
    hd = config.head_dim

    def qkv_init():
        parts = [_linear_init(rng, e, e) for _ in range(3)]
        return {
            "w": np.stack([p["w"] for p in parts]),  # (3, E, E)
            "b": np.stack([p["b"] for p in parts]),  # (3, E)
        }

    def layer_params():
        return {
            "self_attn": {
                "qkv": qkv_init(),
                "out": _linear_init(rng, e, e),
                "ffn1": _linear_init(rng, 2 * e, 2 * e),
                "ln_g": np.ones(2 * e, np.float32),
                "ln_b": np.zeros(2 * e, np.float32),
                "ffn2": _linear_init(rng, 2 * e, e),
            },
            "cross_attn": {
                "qk": _linear_init(rng, e, e),
                "v": _linear_init(rng, e, e),
                "out": _linear_init(rng, e, e),
                "ffn1": _linear_init(rng, 2 * e, 2 * e),
                "ln_g": np.ones(2 * e, np.float32),
                "ln_b": np.zeros(2 * e, np.float32),
                "ffn2": _linear_init(rng, 2 * e, e),
            },
        }

    params = {
        "posenc": {"wr": rng.standard_normal((2, hd // 2)).astype(np.float32)},
        "layers": _stack([layer_params() for _ in range(config.n_layers)]),
        "assign": _stack(
            [
                {
                    "proj": _linear_init(rng, e, e),
                    "match": _linear_init(rng, e, 1),
                }
                for _ in range(config.n_layers)
            ]
        ),
    }
    if config.n_layers > 1:
        params["token"] = _stack(
            [_linear_init(rng, e, 1) for _ in range(config.n_layers - 1)]
        )
    if config.input_dim != config.descriptor_dim:
        params["input_proj"] = _linear_init(rng, config.input_dim, e)
    return params


_SP_CONVS = (
    # name, in, out, kernel
    ("conv1a", 1, 64, 3),
    ("conv1b", 64, 64, 3),
    ("conv2a", 64, 64, 3),
    ("conv2b", 64, 64, 3),
    ("conv3a", 64, 128, 3),
    ("conv3b", 128, 128, 3),
    ("conv4a", 128, 128, 3),
    ("conv4b", 128, 128, 3),
    ("convPa", 128, 256, 3),
    ("convPb", 256, 65, 1),
    ("convDa", 128, 256, 3),
    ("convDb", 256, 256, 1),
)
# convs that run through F.conv2d and so take OIHW; conv1a (the tap stem)
# and the 64-channel kernel convs keep HWIO
_OIHW_CONVS = ("conv3a", "conv3b", "conv4a", "conv4b", "convPa", "convPb",
               "convDa", "convDb")


def init_superpoint(
    seed: int = 0, config: SuperPointConfig = SuperPointConfig()
) -> Dict:
    """Random SuperPoint parameter tree (numpy, fp32), HWIO conv weights."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, cin, cout, ks in _SP_CONVS:
        fan_in = cin * ks * ks
        bound = 1.0 / np.sqrt(fan_in)
        params[name] = {
            "w": rng.uniform(-bound, bound, (ks, ks, cin, cout)).astype(np.float32),
            "b": rng.uniform(-bound, bound, (cout,)).astype(np.float32),
        }
    return params


def save_npz(params, path: str) -> None:
    """Flatten a tree into an .npz archive (keys joined by '/')."""
    flat = {}

    def walk(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = np.asarray(tree)

    walk("", params)
    np.savez(path, **flat)


def load_npz(path: str) -> Dict:
    with np.load(path) as data:
        tree: Dict = {}
        for key in data.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree


def _to_tensor(a, device, dtype):
    t = torch.as_tensor(np.ascontiguousarray(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device="cpu", dtype=None) -> Dict:
    """JAX-layout numpy tree -> the port's tensor tree on ``device``.

    Floating leaves are cast to ``dtype`` when one is given, except an int8
    linear's ``scale``: ``w_q`` stays int8 and ``scale`` fp32. Layout
    changes:

    - LightGlue ``layers.self_attn.qkv``: w or w_q (L, 3, E, E) -> (L, E, 3E)
      and b (L, 3, E) -> (L, 3E), columns [q | k | v] (one projection
      launch); an int8 scale (L, 3, 1, E) -> (L, 3E);
    - LightGlue ``layers.cross_attn``: ``qk`` and ``v`` fuse into ``qk_v``,
      w or w_q (L, E, 2E) and b (L, 2E), columns [qk | v]; an int8 scale
      (L, 1, E) each -> (L, 2E);
    - every other int8 linear's scale takes its bias's shape ((L, 1, N) ->
      (L, N)): one fp32 scale per output channel;
    - every int8 linear of ``layers`` also takes ``w_t``, its ``w_q`` K-major
      ((L, K, N) -> (L, N, K), contiguous): the operand of the W8A8 GEMM
      (``csrc/linear.cu:linear_s8_kernel``), laid out once here; ``w_q``
      stays the (K, N) weight of every other reader. It adds the int8
      weights' bytes again: 1,245,184 a layer at E = 256;
    - SuperPoint convs run by ``F.conv2d`` (conv3a..convDb): HWIO -> OIHW.
      conv1a and conv1b..conv2b keep HWIO (the tap stem and conv3x3 kernel).
    """

    def leaf(key, v, node):
        if key == "scale" and "w_q" in node:
            return _to_tensor(np.asarray(v).reshape(np.shape(node["b"])), device, None)
        return _to_tensor(v, device, dtype)

    def conv(node):
        return {k: conv(v) if isinstance(v, dict) else leaf(k, v, node)
                for k, v in node.items()}

    out = conv(tree)
    if "layers" in tree:
        sa = tree["layers"]["self_attn"]
        ca = tree["layers"]["cross_attn"]
        wk = "w" if "w" in sa["qkv"] else "w_q"
        w = np.asarray(sa["qkv"][wk])
        nl, _, e, _ = w.shape
        qkv = {wk: _to_tensor(w.transpose(0, 2, 1, 3).reshape(nl, e, 3 * e), device, dtype),
               "b": _to_tensor(np.asarray(sa["qkv"]["b"]).reshape(nl, 3 * e), device, dtype)}
        qk_v = {wk: _to_tensor(np.concatenate([ca["qk"][wk], ca["v"][wk]], axis=-1),
                               device, dtype),
                "b": _to_tensor(np.concatenate([ca["qk"]["b"], ca["v"]["b"]], axis=-1),
                                device, dtype)}
        if wk == "w_q":
            qkv["scale"] = _to_tensor(np.asarray(sa["qkv"]["scale"]).reshape(nl, 3 * e),
                                      device, None)
            qk_v["scale"] = _to_tensor(
                np.concatenate([ca["qk"]["scale"], ca["v"]["scale"]], axis=-1).reshape(nl, -1),
                device, None)
        out["layers"]["self_attn"]["qkv"] = qkv
        out["layers"]["cross_attn"]["qk_v"] = qk_v
        del out["layers"]["cross_attn"]["qk"], out["layers"]["cross_attn"]["v"]
        for block in out["layers"].values():
            for node in block.values():
                if isinstance(node, dict) and "w_q" in node:
                    node["w_t"] = node["w_q"].transpose(-1, -2).contiguous()
    for name in _OIHW_CONVS:
        if name in tree:
            out[name]["w"] = _to_tensor(
                np.asarray(tree[name]["w"]).transpose(3, 2, 0, 1), device, dtype
            )
    return out
