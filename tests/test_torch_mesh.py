"""Port parallel/mesh.py (plain versions on the CPU, ``[cpu] * n`` meshes)
against the JAX package's mesh on the conftest's simulated CPU devices:
the sharded match step over data x model meshes at fp32 and bf16, the
adaptive and extraction steps; and against the port's own single-device
forward (``full=True``, an int8 tree); parameter sharding (whole heads of
each [q | k | v] component); the multi-process helpers in one process."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.config import LightGlueConfig as JLGC
from lightglue_tpu.config import PipelineConfig as JPC
from lightglue_tpu.config import SuperPointConfig as JSPC
from lightglue_tpu.parallel import mesh as jax_mesh
from lightglue_tpu.precision import Precision as JPrecision
from lightglue_tpu.precision import policy_for as jax_policy_for
from lightglue_tpu.runtime import weights as jax_weights
from lightglue_tpu_torch import quant
from lightglue_tpu_torch.config import LightGlueConfig, PipelineConfig, SuperPointConfig
from lightglue_tpu_torch.models import lightglue
from lightglue_tpu_torch.parallel import mesh, multihost
from lightglue_tpu_torch.pipeline.extract import extract_keypoints
from lightglue_tpu_torch.models import superpoint
from lightglue_tpu_torch.precision import Precision, policy_for
from lightglue_tpu_torch.runtime import weights

from conftest import require_devices
from test_torch_adaptive import ATOL, _pinned_exit, _spread, _tree, _with_match_bias
from test_torch_host import one_torch_thread  # noqa: F401 (autouse)
from test_torch_superpoint import smooth_images

N_LAYERS = 2
BUCKET = 128
BATCH = 2
# FP32: true fp32 on both sides, sums in another order. BF16: the 2-layer
# gate of golden/bf16_layer_err_r05.txt that test_torch_per_block uses
# (twice the measured envelope between two summation orders, 2 x 0.0563)
DESC_TOL = {"fp32": 1e-4, "bf16": 2 * 0.0563}
MESHES = [(2, 1), (1, 2), (2, 2), (1, 4)]
CPU = torch.device("cpu")


def _config(precision, **lg):
    kw = dict(buckets=(BUCKET,), match_threshold=0.0, max_matches=BUCKET)
    return (PipelineConfig(lightglue=LightGlueConfig(n_layers=N_LAYERS, **lg),
                           precision=Precision(precision), **kw),
            JPC(lightglue=JLGC(n_layers=N_LAYERS, **lg), precision=JPrecision(precision), **kw))


def _inputs(seed=5, b=BATCH, n=BUCKET):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (b, n, 2)).astype(np.float32),
            rng.uniform(-1, 1, (b, n, 2)).astype(np.float32),
            rng.standard_normal((b, n, 256), dtype=np.float32),
            rng.standard_normal((b, n, 256), dtype=np.float32),
            np.asarray([n - 7, n - 20][:b], np.int32),
            np.asarray([n - 3, n][:b], np.int32))


def _cpu_mesh(data, model):
    return mesh.make_mesh(data, model, devices=[CPU] * (data * model))


def _params(tree, precision):
    pol = policy_for(Precision(precision))
    if pol.int8_weights:
        return weights.params_from_numpy(quant.quantize_lightglue(tree), "cpu")
    return weights.params_from_numpy(tree, "cpu", pol.param_dtype)


@pytest.fixture(scope="module")
def tree():
    return weights.init_lightglue(3, LightGlueConfig(n_layers=N_LAYERS))


def _assert_close(got, want, precision):
    """LightGlueOutput against LightGlueOutput (numpy fields)."""
    for g, w in ((got.desc0, want.desc0), (got.desc1, want.desc1)):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32),
                                   atol=DESC_TOL[precision], rtol=0)
    s_got, s_want = np.asarray(got.scores, np.float32), np.asarray(want.scores, np.float32)
    valid = s_want > -1e29
    assert np.array_equal(valid, s_got > -1e29)
    if precision == "fp32":
        np.testing.assert_allclose(s_got, s_want, atol=1e-4, rtol=1e-4)
    else:  # the JAX package's own bf16 bar (tests/test_layer_stack.py)
        assert np.abs(s_got - s_want)[valid].max() < 0.15


def _numpy(out):
    return type(out)(*(np.asarray(x.float() if x.is_floating_point() else x) for x in out))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("data,model", MESHES)
def test_match_step_matches_jax(tree, data, model, precision):
    require_devices(data * model)
    cfg, jcfg = _config(precision)
    args = _inputs()
    jpol = jax_policy_for(JPrecision(precision))
    jm = jax_mesh.make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    jp = jax_mesh.shard_lightglue_params(jax_weights.to_jax(tree, jpol.param_dtype), jm)
    jout, jmatch = jax_mesh.make_parallel_match_fn(jm, jcfg, BUCKET, BUCKET)(
        jp, *map(jnp.asarray, args))
    m = _cpu_mesh(data, model)
    out, match = mesh.make_parallel_match_fn(m, cfg, BUCKET, BUCKET)(
        mesh.shard_lightglue_params(_params(tree, precision), m), *map(torch.from_numpy, args))
    assert out.scores.shape == (BATCH, BUCKET, BUCKET)
    assert match.indices.shape == (BATCH, BUCKET, 2) and match.count.dtype == torch.int32
    assert out.desc0.dtype == policy_for(Precision(precision)).act_dtype
    _assert_close(_numpy(out), jout, precision)
    if precision == "fp32":  # the mutual matches of both: equal but for near-ties
        for b in range(BATCH):
            ours = {tuple(p) for p in match.indices[b, :int(match.count[b])].tolist()}
            theirs = {tuple(p) for p in np.asarray(jmatch.indices[b, :int(jmatch.count[b])])
                      .tolist()}
            assert theirs and len(ours & theirs) >= 0.95 * len(ours | theirs)


def _single(tree, args, precision, full=False):
    pol = policy_for(Precision(precision))
    t = [torch.from_numpy(a) for a in args]
    return lightglue.forward(_params(tree, precision), *t[:4],
                             *((None, None) if full else t[4:]),
                             config=LightGlueConfig(n_layers=N_LAYERS), policy=pol)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("data,model", [(2, 1), (2, 2), (1, 4)])
def test_match_step_equals_single_device(tree, data, model, precision):
    """Data-parallel rows are the single-device rows; tensor-parallel ones
    differ by the order of the partial sums (int8: weight-only on the
    per-block route, the stack at model 1)."""
    cfg, _ = _config(precision)
    args = _inputs(seed=6)
    m = _cpu_mesh(data, model)
    out, _ = mesh.make_parallel_match_fn(m, cfg, BUCKET, BUCKET)(
        mesh.shard_lightglue_params(_params(tree, precision), m), *map(torch.from_numpy, args))
    want = _single(tree, args, precision)
    if model == 1:
        for g, w in zip(out[:3], want[:3]):
            assert torch.equal(g, w)
    else:
        _assert_close(_numpy(out), _numpy(want), "fp32" if precision == "fp32" else "bf16")


def test_full_drops_lengths(tree):
    """``full=True`` ignores the lengths (every pair fills its bucket), as
    the unmasked single-device forward."""
    cfg, _ = _config("fp32")
    args = _inputs(seed=7)
    m = _cpu_mesh(1, 2)
    params = mesh.shard_lightglue_params(_params(tree, "fp32"), m)
    full = mesh.make_parallel_match_fn(m, cfg, BUCKET, BUCKET, full=True)
    out, _ = full(params, *map(torch.from_numpy, args))
    _assert_close(_numpy(out), _numpy(_single(tree, args, "fp32", full=True)), "fp32")
    masked, _ = mesh.make_parallel_match_fn(m, cfg, BUCKET, BUCKET)(
        params, *map(torch.from_numpy, args))
    assert not torch.equal(out.scores, masked.scores)


def _rebuild(shards, spec):
    """The shards of one leaf, concatenated back (the inverse of sharding)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        parts = 1 if entry == mesh.AXIS_MODEL else entry[1]
        split = [s.unflatten(dim, (parts, s.shape[dim] // parts)) for s in shards]
        return torch.cat(split, dim + 1).flatten(dim, dim + 1)
    return shards[0]


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_sharded_params_rebuild_the_tree(tree, int8):
    params = _params(tree, "int8" if int8 else "fp32")
    m = _cpu_mesh(1, 4)
    sharded = mesh.shard_lightglue_params(params, m)
    shards = [sharded.shards[(0, j)] for j in range(4)]

    def walk(node, spec, parts, path):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, spec[key], [p[key] for p in parts], path + (key,))
            elif spec[key] == mesh.STACK_ONLY:  # the W8A8 stack's copy: no shard holds it
                assert all(key not in p for p in parts), path + (key,)
            else:
                assert torch.equal(_rebuild([p[key] for p in parts], spec[key]), val), path + (key,)

    walk(params, sharded.specs, shards, ())
    e, hd = 256, 64
    for j, p in enumerate(shards):  # shard j holds heads j of q, k and v
        wk = "w_q" if int8 else "w"
        qkv, full = p["layers"]["self_attn"]["qkv"][wk], params["layers"]["self_attn"]["qkv"][wk]
        assert qkv.shape[-1] == 3 * hd
        for c in range(3):
            assert torch.equal(qkv[..., c * hd:(c + 1) * hd],
                               full[..., c * e + j * hd:c * e + (j + 1) * hd])
        assert lightglue.local_heads(p, hd) == 1
    one = mesh.shard_lightglue_params(params, _cpu_mesh(2, 1))
    assert one.shards[(0, 0)] is one.shards[(1, 0)]  # one device: one copy
    if int8:
        assert "w_t" in one.shards[(0, 0)]["layers"]["self_attn"]["qkv"]


def test_whole_heads_keep_the_rope_permutation():
    """The RoPE de-interleave permutation acts inside each head: a torch
    Wqkv whose row o holds the number o, repacked, shows where each column
    of [q | k | v] came from; shard j's columns of every component come from
    exactly its heads' rows (the reference's head o // (3 d))."""
    heads, hd, e = 4, 64, 256
    w = np.repeat(np.arange(3 * e, dtype=np.float32)[:, None], e, axis=1)  # row o holds o
    ws = weights._repack_qkv(w, np.zeros(3 * e), heads, hd)["w"]  # (3, E, E)
    whole = torch.from_numpy(np.concatenate(list(ws), axis=-1))[None]  # (1, E, 3E)
    spec = mesh.lightglue_param_specs(
        {"layers": {"self_attn": {"qkv": {"w": whole, "b": whole[:, 0]}}}})
    spec = spec["layers"]["self_attn"]["qkv"]["w"]
    for tp in (2, 4):
        per = heads // tp
        for j in range(tp):
            src = mesh._shard_leaf(whole, spec, j, tp)[0, 0].long()  # (3 * E / tp,) source rows
            for c in range(3):
                rows = src[c * per * hd:(c + 1) * per * hd]
                assert set((rows // (3 * hd)).tolist()) == set(range(j * per, (j + 1) * per))
                assert set((rows % 3).tolist()) == {c}  # the component's rows
                assert len(set(rows.tolist())) == per * hd


@pytest.mark.parametrize("setup", ["exit3", "prune"])
def test_adaptive_step_matches_jax_and_single_device(setup):
    """make_parallel_adaptive_fn over (data 2, model 2): per-pair exits,
    surviving lengths and compacted index maps equal JAX's sharded step and
    the port's single device; scores at fp32 1e-4 (a shard's batch of one
    sums in another order than the batch of two)."""
    require_devices(4)
    n_layers = 3
    if setup == "exit3":
        t = _tree(n_layers, token=_pinned_exit(n_layers, 2))
        lg = dict(n_layers=n_layers, depth_confidence=0.95, width_confidence=0.99)
    else:  # a spread token head with unmatchable tokens prunes at every layer
        t = _with_match_bias(_tree(n_layers, token=_spread(n_layers, 7)), -50.0)
        lg = dict(n_layers=n_layers, depth_confidence=-1.0, width_confidence=0.99)
    kw = dict(buckets=(BUCKET,), max_matches=BUCKET)
    args = _inputs(seed=8)
    jm = jax_mesh.make_mesh(data=2, model=2, devices=jax.devices()[:4])
    want = jax_mesh.make_parallel_adaptive_fn(jm, JPC(lightglue=JLGC(**lg),
                                                      precision=JPrecision.FP32, **kw))(
        jax_weights.to_jax(t), *map(jnp.asarray, args))
    cfg = PipelineConfig(lightglue=LightGlueConfig(**lg), precision=Precision.FP32, **kw)
    params = weights.params_from_numpy(t, "cpu", torch.float32)
    tin = [torch.from_numpy(a) for a in args]
    got = mesh.make_parallel_adaptive_fn(_cpu_mesh(2, 2), cfg)(params, *tin)
    single = lightglue.forward_adaptive(params, *tin, config=cfg.lightglue,
                                        policy=policy_for(Precision.FP32))
    if setup == "exit3":
        assert np.asarray(want.exit_layer).tolist() == [2, 2]
    else:
        assert (np.asarray(want.lengths0) < BUCKET - 20).all()
    for key in ("exit_layer", "lengths0", "lengths1", "index0", "index1"):
        g = getattr(got, key).numpy()
        assert np.array_equal(g, getattr(single, key).numpy()), key
        assert np.array_equal(g, np.asarray(getattr(want, key))), key
    np.testing.assert_allclose(got.scores.numpy(), single.scores.numpy(), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=ATOL, rtol=ATOL)


def test_extract_step_bit_for_bit_and_matches_jax():
    """make_parallel_extract_fn over (data 2, model 2): every field equals
    the unsharded extraction bit for bit; counts equal JAX's sharded
    extraction, keypoints but for the tie order at the k-th score, and
    descriptors at fp32 1e-4."""
    require_devices(4)
    sp_cfg = SuperPointConfig(max_num_keypoints=BUCKET)
    cfg = PipelineConfig(superpoint=sp_cfg, precision=Precision.FP32, buckets=(BUCKET,))
    tree = weights.init_superpoint(4, sp_cfg)
    images = smooth_images(9, 4, 64, 96)
    sp = weights.params_from_numpy(tree, "cpu")
    got = mesh.make_parallel_extract_fn(_cpu_mesh(2, 2), cfg)(sp, torch.from_numpy(images))
    pol = policy_for(Precision.FP32)
    scores, desc = superpoint.forward(sp, torch.from_numpy(images), config=sp_cfg, policy=pol,
                                      nms=False)
    want = extract_keypoints(scores, desc, config=sp_cfg, raw_scores=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    jm = jax_mesh.make_mesh(data=2, model=2, devices=jax.devices()[:4])
    jext = jax_mesh.make_parallel_extract_fn(jm, JPC(superpoint=JSPC(max_num_keypoints=BUCKET),
                                                     precision=JPrecision.FP32,
                                                     buckets=(BUCKET,)))(
        jax_weights.to_jax(tree), jnp.asarray(images))
    assert np.array_equal(got.count.numpy(), np.asarray(jext.count))
    assert got.count.min() > 10
    for b in range(images.shape[0]):
        c = int(got.count[b])
        ours = {tuple(p): j for j, p in enumerate(got.keypoints[b, :c].numpy())}
        theirs = {tuple(p): j for j, p in enumerate(np.asarray(jext.keypoints[b, :c]))}
        # only the tie order at the k-th score may differ (test_torch_superpoint)
        assert len(ours.keys() ^ theirs.keys()) <= 2
        for p in ours.keys() & theirs.keys():
            np.testing.assert_allclose(got.descriptors[b, ours[p]].numpy(),
                                       np.asarray(jext.descriptors[b, theirs[p]]), atol=1e-4)


def test_mesh_rules_and_single_process_helpers(tree, monkeypatch):
    m = _cpu_mesh(2, 2)
    assert m.shape == {"data": 2, "model": 2} and m.size == 4
    assert [i for i, _ in m.local_rows()] == [0, 1] and m.model_group(0) is None
    with pytest.raises(ValueError, match="mesh 3x2 != 4 devices"):
        mesh.make_mesh(3, 2, devices=[CPU] * 4)
    cfg, _ = _config("fp32")
    with pytest.raises(ValueError, match="splits 4 heads"):
        mesh.make_parallel_match_fn(_cpu_mesh(1, 3), cfg, BUCKET, BUCKET)
    step = mesh.make_parallel_match_fn(_cpu_mesh(2, 1), cfg, BUCKET, BUCKET)
    with pytest.raises(ValueError, match="does not split"):
        step(_params(tree, "fp32"), *map(torch.from_numpy, _inputs(b=1)))
    with pytest.raises(ValueError, match="another mesh"):
        step(mesh.shard_lightglue_params(_params(tree, "fp32"), _cpu_mesh(2, 1)),
             *map(torch.from_numpy, _inputs()))
    # multihost in one process: initialize is a no-op, the batch splits,
    # the barrier counts this process's devices
    multihost.initialize(num_processes=1, backend="gloo")
    assert not multihost.is_multiprocess()
    local = [np.arange(16, dtype=np.float32).reshape(4, 2, 2), np.arange(4, dtype=np.int32)]
    arrs = multihost.global_batch_from_local(local, m)
    assert arrs[0].shape == (4, 2, 2) and [s.start for s in arrs[0].shards] == [0, 2]
    assert arrs[1].rows() == {k: k for k in range(4)}
    assert multihost.barrier(m) == 4
    # a step takes sharded inputs
    args = _inputs()
    sharded = multihost.global_batch_from_local(args, _cpu_mesh(2, 1))
    got, _ = step(_params(tree, "fp32"), *sharded)
    want, _ = step(_params(tree, "fp32"), *map(torch.from_numpy, args))
    assert torch.equal(got.scores, want.scores)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):  # the card unless the CPU is asked
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA mesh"):
        mesh.make_mesh(devices=["cuda:0"] * 2)


def test_a_failing_shard_raises_and_frees_the_others(tree, monkeypatch):
    """A tensor-parallel shard that raises mid-forward: its error comes out
    of the step, and the shards waiting for it at the model axis leave."""
    cfg, _ = _config("fp32")
    m = _cpu_mesh(1, 4)
    params = mesh.shard_lightglue_params(_params(tree, "fp32"), m)
    calls, gelu = [], lightglue._gelu

    def failing(x):
        calls.append(x)
        if len(calls) == 1:
            raise FloatingPointError("shard failure")
        return gelu(x)

    monkeypatch.setattr(lightglue, "_gelu", failing)
    with pytest.raises(FloatingPointError, match="shard failure"):
        mesh.make_parallel_match_fn(m, cfg, BUCKET, BUCKET)(params,
                                                           *map(torch.from_numpy, _inputs()))
