"""Parameter trees: random initialization, npz IO and conversion to tensors.

``init_superpoint`` / ``init_lightglue`` draw the same
``np.random.default_rng(seed)`` stream as ``lightglue_tpu/runtime/weights.py``
(:71-127, :321-336), so one seed gives equal numpy trees in both packages;
``save_npz`` / ``load_npz`` read and write the JAX package's archives.
``load_torch_checkpoint`` with ``lightglue_from_state_dict`` /
``superpoint_from_state_dict`` turn the upstream ``.pth`` checkpoints into
the same numpy trees (JAX :139-438), and ``whiten_superpoint_descriptors``
adapts random SuperPoint weights on calibration images.
``params_from_numpy`` turns such a numpy tree into the port's tensors and is
the one place where the port's layouts differ from the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

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


# ---------------------------------------------------------------------------
# upstream .pth checkpoints (torch layouts) -> numpy trees, JAX layout
# ---------------------------------------------------------------------------


def _t(sd: Mapping[str, np.ndarray], key: str) -> np.ndarray:
    """torch Linear weight (out, in) -> (in, out)."""
    return np.ascontiguousarray(np.asarray(sd[key]).T.astype(np.float32))


def _b(sd: Mapping[str, np.ndarray], key: str) -> np.ndarray:
    return np.asarray(sd[key]).astype(np.float32)


def rope_permutation(head_dim: int) -> np.ndarray:
    """De-interleave permutation turning interleaved-pair RoPE into
    half-split RoPE: perm[j] = 2j for j < d/2, else 2(j - d/2) + 1.

    The reference rotates interleaved pairs (2i, 2i+1) with frequency i
    (lightglue.py:154-165); permuting q's and k's head dims alike makes the
    same rotation act on halves (j, j + d/2) and leaves Q K^T, so every
    model output, unchanged."""
    half = head_dim // 2
    perm = np.empty(head_dim, np.int64)
    perm[:half] = 2 * np.arange(half)
    perm[half:] = 2 * np.arange(half) + 1
    return perm


def _repack_qkv(w_torch: np.ndarray, b_torch: np.ndarray, heads: int, head_dim: int):
    """torch Wqkv (3E, E), rows interleaved as (head, dim, component) ->
    (3, E, E) component-major with head-major output columns, q and k
    RoPE-permuted (``rope_permutation``).

    Row o of the torch weight is head o // (3 d), dim (o % 3d) // 3,
    component o % 3: qkv.reshape(B, N, heads, head_dim, 3) in the reference
    (lightglue.py:140)."""
    e = heads * head_dim
    perm = rope_permutation(head_dim)
    wt = w_torch.T.astype(np.float32).reshape(e, heads, head_dim, 3)  # (in, out) split
    bt = b_torch.astype(np.float32).reshape(heads, head_dim, 3)
    ws, bs = [], []
    for c in range(3):
        wc, bc = wt[..., c], bt[..., c]
        if c < 2:  # q and k feel the rotary embedding; v does not
            wc, bc = wc[..., perm], bc[..., perm]
        ws.append(wc.reshape(e, e))
        bs.append(bc.reshape(e))
    return {"w": np.ascontiguousarray(np.stack(ws)), "b": np.stack(bs)}


def _pair(sd, key: str) -> Dict:
    return {"w": _t(sd, key + ".weight"), "b": _b(sd, key + ".bias")}


def lightglue_from_state_dict(
    sd: Mapping[str, np.ndarray], config: Optional[LightGlueConfig] = None
) -> Dict:
    """A numpy-valued LightGlue state dict -> the numpy tree (JAX layout).

    Takes the current key scheme (``transformers.{i}.self_attn...``) and the
    older one (``self_attn.{i}...``) that the reference renames
    (lightglue.py:347-354). Without a config the layer count is read from
    the keys."""
    sd = dict(sd)
    if config is None:
        n_layers = 1 + max(
            int(k.split(".")[1])
            for k in sd
            if k.startswith(("transformers.", "log_assignment."))
        )
        config = LightGlueConfig(n_layers=n_layers)
    for i in range(config.n_layers):
        for old, new in ((f"self_attn.{i}.", f"transformers.{i}.self_attn."),
                         (f"cross_attn.{i}.", f"transformers.{i}.cross_attn.")):
            for k in [k for k in sd if k.startswith(old)]:
                sd[new + k[len(old):]] = sd.pop(k)

    def ffn_part(p):
        return {"ffn1": _pair(sd, p + "ffn.0"), "ln_g": _b(sd, p + "ffn.1.weight"),
                "ln_b": _b(sd, p + "ffn.1.bias"), "ffn2": _pair(sd, p + "ffn.3")}

    def layer(i: int):
        sa, ca = f"transformers.{i}.self_attn.", f"transformers.{i}.cross_attn."
        return {
            "self_attn": {
                "qkv": _repack_qkv(np.asarray(sd[sa + "Wqkv.weight"]),
                                   np.asarray(sd[sa + "Wqkv.bias"]),
                                   config.num_heads, config.head_dim),
                "out": _pair(sd, sa + "out_proj"),
                **ffn_part(sa),
            },
            "cross_attn": {
                "qk": _pair(sd, ca + "to_qk"),
                "v": _pair(sd, ca + "to_v"),
                "out": _pair(sd, ca + "to_out"),
                **ffn_part(ca),
            },
        }

    params = {
        "posenc": {"wr": _t(sd, "posenc.Wr.weight")},
        "layers": _stack([layer(i) for i in range(config.n_layers)]),
        "assign": _stack([
            {"proj": _pair(sd, f"log_assignment.{i}.final_proj"),
             "match": _pair(sd, f"log_assignment.{i}.matchability")}
            for i in range(config.n_layers)
        ]),
    }
    if "token_confidence.0.token.0.weight" in sd:
        params["token"] = _stack([_pair(sd, f"token_confidence.{i}.token.0")
                                  for i in range(config.n_layers - 1)])
    if "input_proj.weight" in sd:
        params["input_proj"] = _pair(sd, "input_proj")
    return params


def superpoint_from_state_dict(sd: Mapping[str, np.ndarray]) -> Dict:
    """A numpy-valued SuperPoint state dict -> the numpy tree: OIHW conv
    weights -> HWIO."""
    params = {}
    for name, _, _, _ in _SP_CONVS:
        w = np.asarray(sd[f"{name}.weight"]).astype(np.float32)
        params[name] = {
            "w": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
            "b": np.asarray(sd[f"{name}.bias"]).astype(np.float32),
        }
    return params


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A ``.pth`` state dict as numpy arrays, read on the CPU and with
    ``weights_only`` (no code in the file runs)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in sd.items()}


def whiten_superpoint_descriptors(
    sp_params, images: np.ndarray, *, config: Optional[SuperPointConfig] = None,
    policy=None, device: Optional[str] = None,
) -> Dict:
    """Fold a ZCA whitening of the dense descriptor map into convDb (1x1)
    (JAX ``runtime/weights.py:338-384``).

    For random-init (proxy) weights only: a deep random ReLU CNN puts every
    position's raw descriptor on one dominant direction, so after L2
    normalisation all keypoints are ~0.9999 cosine-similar and matching
    degenerates. Whitening the raw convDb output over calibration images
    restores the spread trained weights have, so match counts mean
    something. The raw map comes from ``superpoint.forward_raw_descriptors``
    at the FP32 policy on ``device`` (None: the card, as the session).

    Args:
      sp_params: SuperPoint numpy tree (fp32, HWIO convs).
      images: (B, H, W, 1) float32 calibration batch.
    Returns a new tree with convDb rewritten."""
    from lightglue_tpu_torch.models import superpoint
    from lightglue_tpu_torch.precision import Precision, policy_for
    from lightglue_tpu_torch.runtime.session import resolve_device

    dev = resolve_device(device)
    with torch.inference_mode():
        raw = superpoint.forward_raw_descriptors(
            params_from_numpy(sp_params, dev), torch.from_numpy(np.asarray(images)).to(dev),
            config=config or SuperPointConfig(), policy=policy or policy_for(Precision.FP32),
        ).cpu().numpy()
    flat = raw.astype(np.float64).reshape(-1, raw.shape[-1])
    mu = flat.mean(0)
    cov = np.cov(flat.T)
    evals, evecs = np.linalg.eigh(cov)
    # relative floor: random-init raw descriptors are tiny (top eigenvalue
    # ~1e-5), so an absolute clip would flatten real directions; near-null
    # directions stay suppressed instead of being blown up
    floor = max(float(evals.max()), 1e-30) * 1e-6
    white = evecs @ np.diag(1.0 / np.sqrt(np.clip(evals, floor, None))) @ evecs.T

    out = {k: dict(v) for k, v in sp_params.items()}
    w = np.asarray(sp_params["convDb"]["w"], np.float64)  # (1, 1, 256, 256)
    b = np.asarray(sp_params["convDb"]["b"], np.float64)
    out["convDb"] = {
        "w": np.einsum("ik,ck->ic", w[0, 0], white)[None, None].astype(np.float32),
        "b": (white @ (b - mu)).astype(np.float32),
    }
    return out


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
