"""Port adaptive depth and width (plain versions on the CPU) against the JAX
package: ``forward_adaptive`` on the Pallas ``transformer_stack_adaptive``
in interpret mode, its ``force_loop`` oracle, the stack itself (and its
decision on a batch with a retired pair), and the adaptive session; and
``decide_plan``, the decision kernel's launch. The cases mirror
tests/test_adaptive.py, on the same numpy weights from
``weights.init_lightglue`` with the same overrides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.config import LightGlueConfig as JLGC
from lightglue_tpu.config import PipelineConfig as JPC
from lightglue_tpu.config import SuperPointConfig as JSPC
from lightglue_tpu.kernels import layer_stack as jax_stack
from lightglue_tpu.models import lightglue as jax_lg
from lightglue_tpu.precision import Precision as JPrecision
from lightglue_tpu.precision import policy_for as jax_policy_for
from lightglue_tpu.runtime import weights as jax_weights
from lightglue_tpu.runtime.session import MatcherSession as JaxSession
from lightglue_tpu_torch.config import LightGlueConfig, PipelineConfig, SuperPointConfig
from lightglue_tpu_torch.kernels import layer_stack
from lightglue_tpu_torch.models import lightglue
from lightglue_tpu_torch.precision import Precision, policy_for
from lightglue_tpu_torch.runtime import weights
from lightglue_tpu_torch.runtime.session import MatcherSession

from test_torch_layer_stack import make_inputs
from test_torch_superpoint import smooth_images

N = 128
# FP32: true fp32 on both sides, sums in another order
ATOL = 1e-4


def _inputs(b=1, n=N, seed=888):
    """tests/test_adaptive.py:_inputs: lengths n - 5 and n - 9."""
    rng = np.random.default_rng(seed)
    return (
        rng.uniform(-1, 1, (b, n, 2)).astype(np.float32),
        rng.uniform(-1, 1, (b, n, 2)).astype(np.float32),
        rng.standard_normal((b, n, 256), dtype=np.float32),
        rng.standard_normal((b, n, 256), dtype=np.float32),
        np.full((b,), n - 5, np.int32),
        np.full((b,), n - 9, np.int32),
    )


def _tree(n_layers, **overrides):
    tree = weights.init_lightglue(0, LightGlueConfig(n_layers=n_layers))
    tree.update(overrides)
    return tree


def _token(n_layers, b, w=None):
    return {"w": np.zeros((n_layers - 1, 256, 1), np.float32) if w is None else w,
            "b": np.asarray(b, np.float32).reshape(n_layers - 1, 1)}


def _pinned_exit(n_layers, exit_layer):
    """Token bias -50 before ``exit_layer`` and +50 from it on."""
    return _token(n_layers, np.where(np.arange(n_layers - 1) >= exit_layer - 1, 50.0, -50.0))


def _spread(n_layers, seed):
    return _token(n_layers, np.zeros(n_layers - 1),
                  w=np.random.default_rng(seed).standard_normal((n_layers - 1, 256, 1))
                  .astype(np.float32))


def _with_match_bias(tree, bias):
    match = tree["assign"]["match"]
    tree["assign"] = dict(tree["assign"], match=dict(match, b=np.full_like(match["b"], bias)))
    return tree


def _port(tree, args, precision="fp32", force_loop=False, **cfg):
    """The port's AdaptiveOutput, each field as numpy."""
    pol = policy_for(Precision(precision))
    got = lightglue.forward_adaptive(
        weights.params_from_numpy(tree, "cpu", pol.param_dtype),
        *map(torch.from_numpy, args), config=LightGlueConfig(**cfg), policy=pol,
        force_loop=force_loop)
    return {k: v.float().numpy() if v.is_floating_point() else v.numpy()
            for k, v in got._asdict().items()}


def _run(tree, args, precision="fp32", force_loop=False, **cfg):
    """(port, JAX) AdaptiveOutputs, each field as numpy."""
    jpol = jax_policy_for(JPrecision(precision))
    k0, k1, d0, d1, l0, l1 = args
    want = jax_lg.forward_adaptive(
        jax_weights.to_jax(tree, jpol.param_dtype),
        *map(jnp.asarray, (k0, k1)), jnp.asarray(d0, jpol.act_dtype),
        jnp.asarray(d1, jpol.act_dtype), jnp.asarray(l0), jnp.asarray(l1),
        config=JLGC(**cfg), policy=jpol, force_loop=force_loop)
    return (_port(tree, args, precision, force_loop, **cfg),
            {k: np.asarray(v, np.float32 if k == "scores" else None)
             for k, v in want._asdict().items()})


def _assert_same(got, want, atol=ATOL):
    np.testing.assert_array_equal(got["exit_layer"], want["exit_layer"])
    for key in ("lengths0", "lengths1", "index0", "index1"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=atol, rtol=atol)


def _prune_parity(a, b, i, max_flips=4):
    """tests/test_adaptive.py:_prune_parity: the keep decision compares logits
    with a threshold, and two lowerings round them differently, so a token on
    the boundary may flip. Lengths within 2, at most ``max_flips`` tokens in
    the index sets' symmetric difference, and scores at 1e-3 on every
    (original i, original j) pair both kept."""
    la = (int(a["lengths0"][i]), int(a["lengths1"][i]))
    lb = (int(b["lengths0"][i]), int(b["lengths1"][i]))
    assert abs(la[0] - lb[0]) <= 2 and abs(la[1] - lb[1]) <= 2

    def kept(out, side, n):
        return out[f"index{side}"][i, :n].tolist()

    for side in (0, 1):
        diff = set(kept(a, side, la[side])) ^ set(kept(b, side, lb[side]))
        assert len(diff) <= max_flips, f"index{side} sets diverge: {sorted(diff)}"

    def smap(out, lens):
        s = out["scores"][i, :lens[0], :lens[1]]
        return {(r, c): s[x, y] for x, r in enumerate(kept(out, 0, lens[0]))
                for y, c in enumerate(kept(out, 1, lens[1]))}

    ma, mb = smap(a, la), smap(b, lb)
    common = ma.keys() & mb.keys()
    assert len(common) >= 0.9 * max(len(ma), len(mb))
    if common:
        assert max(abs(ma[k] - mb[k]) for k in common) < 1e-3


def test_disabled_equals_fixed_depth():
    args = _inputs()
    got, want = _run(_tree(3), args, n_layers=3)
    _assert_same(got, want)
    assert int(got["exit_layer"][0]) == 3
    np.testing.assert_array_equal(got["index0"][0], np.arange(N))
    fixed = lightglue.forward(weights.params_from_numpy(_tree(3)), *map(torch.from_numpy, args),
                              config=LightGlueConfig(n_layers=3),
                              policy=policy_for(Precision.FP32))
    np.testing.assert_allclose(got["scores"], fixed.scores.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("exit_layer,b", [(1, 1), (2, 2)], ids=["exit1-B1", "exit2-B2"])
def test_pinned_exit_matches_jax(exit_layer, b):
    n_layers = 4
    tree = _tree(n_layers, token=_pinned_exit(n_layers, exit_layer))
    got, want = _run(tree, _inputs(b=b), n_layers=n_layers, depth_confidence=0.95)
    assert got["exit_layer"].tolist() == [exit_layer] * b
    _assert_same(got, want)


def test_pairs_exit_independently_matches_jax():
    """Pair 0 is confident from layer 1 on (its descriptors point along the
    token head), pair 1 never: pair 0 retires while pair 1 runs on, so the
    layer kernels must skip it and keep its activations, and each pair
    takes the assignment head of its own exit layer."""
    n_layers = 4
    tdir = np.zeros((256, 1), np.float32)
    tdir[0, 0] = 1.0
    tree = _tree(n_layers, token=_token(n_layers, np.zeros(n_layers - 1),
                                        w=np.tile(tdir[None], (n_layers - 1, 1, 1))))
    k0, k1, d0, d1, l0, l1 = _inputs(b=2)
    d0[0, :, 0] = d1[0, :, 0] = 100.0
    d0[1, :, 0] = d1[1, :, 0] = -100.0
    got, want = _run(tree, (k0, k1, d0, d1, l0, l1), n_layers=n_layers, depth_confidence=0.95)
    assert got["exit_layer"].tolist() == [1, n_layers]
    _assert_same(got, want)


def test_unconfident_runs_all_layers():
    n_layers = 3
    tree = _tree(n_layers, token=_token(n_layers, np.full(n_layers - 1, -10.0)))
    got, want = _run(tree, _inputs(), n_layers=n_layers, depth_confidence=0.95)
    assert int(got["exit_layer"][0]) == n_layers
    _assert_same(got, want)


@pytest.mark.parametrize("depth", [True, False], ids=["depth+width", "width-only"])
def test_width_pruning_matches_jax(depth):
    """A spread token head with width_confidence 0.2 prunes at every layer."""
    n_layers, b = (4, 2) if depth else (3, 1)
    tree = _tree(n_layers, token=_spread(n_layers, 7))
    cfg = dict(n_layers=n_layers, width_confidence=0.2)
    if depth:
        cfg["depth_confidence"] = 0.95
    got, want = _run(tree, _inputs(b=b), **cfg)
    np.testing.assert_array_equal(got["exit_layer"], want["exit_layer"])
    for i in range(b):
        assert got["lengths0"][i] < N - 5 or got["lengths1"][i] < N - 9, "nothing pruned"
        _prune_parity(got, want, i)


def test_downshift_half_arm_matches_jax():
    """wc 0.05 prunes hard enough that every pair fits N/2 after layer 2."""
    n_layers, n = 4, 256
    tree = _tree(n_layers, token=_spread(n_layers, 3))
    cfg = dict(n_layers=n_layers, depth_confidence=0.95, width_confidence=0.05,
               downshift_layer=2)
    got, want = _run(tree, _inputs(b=2, n=n), **cfg)
    np.testing.assert_array_equal(got["exit_layer"], want["exit_layer"])
    assert got["lengths0"].max() <= n // 2 and got["lengths1"].max() <= n // 2
    assert got["lengths0"].min() > 0
    for i in range(2):
        _prune_parity(got, want, i)


def test_downshift_full_arm_matches_jax():
    """Nothing prunable: phase 2 runs at full width and equals the one-call
    width path of the port and the JAX downshift."""
    n_layers, n = 3, 256
    tree = _tree(n_layers, token=_token(n_layers, np.full(n_layers - 1, -10.0)))
    args = _inputs(n=n)
    got, want = _run(tree, args, n_layers=n_layers, width_confidence=0.99, downshift_layer=1)
    assert int(got["lengths0"][0]) == n - 5
    _assert_same(got, want)
    _assert_same(got, _port(tree, args, n_layers=n_layers, width_confidence=0.99), atol=1e-5)


def test_downshift_exit_in_phase_two_follows_the_oracle():
    """A pair that meets the depth criterion inside the downshift's second
    phase exits there. The JAX kernel disagrees: its phase 2 tests liveness
    as exit > LOCAL layer index while the exit register holds the GLOBAL
    layer (lightglue_tpu/kernels/layer_stack.py:734-737 against :586 and
    :642-644), so the pair runs on and the forced last-layer exit overwrites
    it (exit 5 here, scores off by ~9.7). The port follows the documented
    parity reference, the JAX force_loop oracle (ROADMAP queue 3)."""
    n_layers, n = 5, 256
    tree = _with_match_bias(_tree(n_layers, token=_pinned_exit(n_layers, 4)), 50.0)
    cfg = dict(n_layers=n_layers, depth_confidence=0.95, width_confidence=0.99,
               downshift_layer=2)
    args = _inputs(n=n)
    got = _port(tree, args, **cfg)
    port_loop, oracle = _run(tree, args, force_loop=True, **cfg)
    assert int(oracle["exit_layer"][0]) == 4
    _assert_same(got, oracle)
    _assert_same(port_loop, oracle)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_one_image_fully_retired_stays_finite(precision):
    """Width pruning retires every token of image 1 while image 0 stays:
    image 0's cross rows see no key at all and must come out 0, not NaN."""
    n_layers = 4
    tdir = np.zeros((256, 1), np.float32)
    tdir[0, 0] = 1.0
    tree = _tree(n_layers, token=_token(n_layers, np.zeros(n_layers - 1),
                                        w=np.tile(tdir[None], (n_layers - 1, 1, 1))))
    match = tree["assign"]["match"]
    tree["assign"] = dict(tree["assign"], match=dict(
        match, w=np.zeros_like(match["w"]), b=np.full_like(match["b"], -50.0)))
    k0, k1, d0, d1, l0, l1 = _inputs()
    d1[..., 0] = 1000.0  # always confident
    d0[..., 0] = 0.0     # never confident
    got, want = _run(tree, (k0, k1, d0, d1, l0, l1), precision, n_layers=n_layers,
                     width_confidence=0.2)
    assert int(got["lengths1"][0]) == 0 and int(got["lengths0"][0]) > 0
    assert int(got["exit_layer"][0]) == n_layers
    np.testing.assert_array_equal(got["lengths0"], want["lengths0"])
    for key in ("scores", "index0", "index1"):
        assert np.isfinite(got[key]).all()


def test_full_equals_masked():
    """The unmasked depth-only variant equals the masked one when every
    length fills the bucket."""
    n_layers = 4
    tree = _tree(n_layers, token=_token(
        n_layers, np.where(np.arange(n_layers - 1) >= 1, 10.0, -10.0)))
    params = weights.params_from_numpy(tree)
    k0, k1, d0, d1, _, _ = map(torch.from_numpy, _inputs())
    lens = torch.full((1,), N, dtype=torch.int32)
    kw = dict(config=LightGlueConfig(n_layers=n_layers, depth_confidence=0.95),
              policy=policy_for(Precision.FP32))
    masked = lightglue.forward_adaptive(params, k0, k1, d0, d1, lens, lens, **kw)
    full = lightglue.forward_adaptive(params, k0, k1, d0, d1, lens, lens, full=True, **kw)
    assert int(full.exit_layer[0]) == 2
    torch.testing.assert_close(full.exit_layer, masked.exit_layer)
    torch.testing.assert_close(full.scores, masked.scores, atol=1e-6, rtol=1e-6)


# BF16: the golden 2x gate of test_torch_layer_stack.py, at this depth
# (golden/bf16_layer_err_r05.txt: 3-layer envelope 0.0816)
STACK_TOL = {"fp32": 1e-4, "bf16": 2 * 0.0816}
STACK_CASES = {
    # label: (token head, match bias, width_confidence, lengths, bucket of image 1)
    "depth exit 2, masked": (lambda L: _pinned_exit(L, 2), None, -1.0, ([100], [120]), N),
    "width, spread head": (lambda L: _spread(L, 5), None, 0.2, ([128], [110]), N),
    "width, nothing pruned, mixed 128x256": (lambda L: _spread(L, 5), 50.0, 0.99,
                                             ([100], [230]), 2 * N),
}


# the pruning case runs in fp32 only: in bf16 the two stacks differ by
# one-ulp flips, which move tokens on the pruning boundary
@pytest.mark.parametrize("case,dtype", [(c, d) for c in STACK_CASES for d in ("fp32", "bf16")
                                        if d == "fp32" or c != "width, spread head"])
def test_stack_adaptive_plain_matches_jax(case, dtype):
    """transformer_stack_adaptive_plain against the Pallas kernel at L=3:
    exit, keep, d0', d1'."""
    n_layers = 3
    token_fn, match_bias, wc, lens, n1 = STACK_CASES[case]
    tree = _tree(n_layers, token=token_fn(n_layers))
    if match_bias is not None:
        tree = _with_match_bias(tree, match_bias)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    (d0, f0), (d1, f1) = make_inputs(2, 1, N, n1, tree["posenc"]["wr"])
    l0, l1 = (np.asarray(x, np.int32) for x in lens)
    width = wc > 0
    jt = jax_weights.to_jax(tree, jdt)
    want = jax_stack.transformer_stack_adaptive(
        jt["layers"], jt["token"], jnp.asarray(d0, jdt), jnp.asarray(d1, jdt),
        jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(l0), jnp.asarray(l1),
        jt["assign"]["match"] if width else None, num_heads=4, head_dim=64,
        depth_confidence=0.95, width_confidence=wc, stat_dtype=jdt, attn_dtype=jdt)
    pt = weights.params_from_numpy(tree, "cpu", tdt)
    got = layer_stack.transformer_stack_adaptive_plain(
        pt["layers"], pt["token"], torch.from_numpy(d0).to(tdt), torch.from_numpy(d1).to(tdt),
        torch.from_numpy(f0), torch.from_numpy(f1), torch.from_numpy(l0), torch.from_numpy(l1),
        pt["assign"]["match"] if width else None, num_heads=4, head_dim=64,
        depth_confidence=0.95, width_confidence=wc, stat_dtype=tdt, attn_dtype=tdt)
    assert len(got) == len(want) == (5 if width else 3)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    rows = [np.ones(N, bool), np.ones(n1, bool)]
    if width:
        for i in (0, 1):  # the JAX keep output replicates lane 0 over 128 lanes
            keep_j = np.asarray(want[3 + i])
            assert (keep_j == keep_j[..., :1]).all()
            np.testing.assert_array_equal(got[3 + i].numpy(), keep_j[..., 0])
        rows = [got[3 + i][0].numpy() > 0.5 for i in (0, 1)]
        if case == "width, spread head":
            assert rows[0].sum() < 128 and rows[1].sum() < 110, "nothing pruned"
    for i in (0, 1):
        assert got[i].dtype == tdt
        np.testing.assert_allclose(got[i][0].float().numpy()[rows[i]],
                                   np.asarray(want[i][0], np.float32)[rows[i]],
                                   atol=STACK_TOL[dtype], rtol=0)


def _session_configs():
    lgc = dict(n_layers=2, depth_confidence=0.95, width_confidence=0.99)
    kw = dict(buckets=(128, 256), match_threshold=0.0, max_matches=256)
    return (JPC(superpoint=JSPC(max_num_keypoints=256), lightglue=JLGC(**lgc),
                precision=JPrecision.FP32, **kw),
            PipelineConfig(superpoint=SuperPointConfig(max_num_keypoints=256),
                           lightglue=LightGlueConfig(**lgc), precision=Precision.FP32, **kw))


@pytest.fixture(scope="module")
def adaptive_sessions():
    jcfg, cfg = _session_configs()
    sp = jax_weights.init_superpoint(11)
    lg = jax_weights.init_lightglue(12, JLGC(n_layers=2))
    return (JaxSession(sp, lg, config=jcfg, compile_cache_dir=None),
            MatcherSession(sp, lg, config=cfg, device="cpu"))


def _match_set(r):
    return {(tuple(p0), tuple(p1))
            for p0, p1 in zip(r["matched_kpts0"], r["matched_kpts1"])}


def test_adaptive_session_matches_jax_session(adaptive_sessions):
    jax_session, session = adaptive_sessions
    imgs = smooth_images(5, 1, 112, 152)[0]
    img0, img1 = imgs[:96, :128], imgs[16:112, 24:152]
    want = jax_session.match_pair(img0, img1)
    got = session.match_pair(img0, img1)
    assert got["num_keypoints0"] == want["num_keypoints0"] > 10
    ours, theirs = _match_set(got), _match_set(want)
    assert theirs, "JAX found no matches; the comparison would be vacuous"
    assert len(ours & theirs) / len(ours | theirs) > 0.95
    m = got["matches"]
    assert m[:, 0].max() < got["num_keypoints0"] and m[:, 1].max() < got["num_keypoints1"]


def test_adaptive_match_batch_equals_match_pair(adaptive_sessions):
    _, session = adaptive_sessions
    imgs = smooth_images(6, 4, 96, 128)
    batch = session.match_batch(imgs[:2], imgs[2:])
    for i in range(2):
        assert _match_set(batch[i]) == _match_set(session.match_pair(imgs[i], imgs[2 + i]))


def test_remap_maps_compacted_slots_to_keypoints():
    """Session remap: match rows/columns index compacted slots."""
    from lightglue_tpu_torch.pipeline.match import Matches
    from lightglue_tpu_torch.runtime.session import _remap

    idx = torch.tensor([[[0, 1], [2, 0], [-1, -1]]], dtype=torch.int32)
    m = Matches(idx, torch.tensor([[0.9, 0.5, 0.0]]), torch.tensor([[True, True, False]]),
                torch.tensor([2], dtype=torch.int32))
    out = _remap(m, torch.tensor([[5, 7, 9]], dtype=torch.int32),
                 torch.tensor([[4, 8, 6]], dtype=torch.int32))
    assert out.indices.tolist() == [[[5, 8], [9, 4], [-1, -1]]]


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "kwargs",
    [dict(w_tok=_meta(128)), dict(exit=_meta(2, dtype=torch.float32)),
     dict(keep0=_meta(1, 128, dtype=torch.float32))],
    ids=["head width", "exit shape", "width without its head"],
)
def test_adaptive_decide_rejects_malformed_operands(kwargs):
    # meta tensors take the kernel branch without a card; the checks run first
    args = dict(x0=_meta(1, 128, 256), x1=_meta(1, 128, 256), w_tok=_meta(256),
                b_tok=_meta(1, dtype=torch.float32), exit=_meta(1, dtype=torch.float32))
    args.update(kwargs)
    with pytest.raises(ValueError):
        layer_stack.adaptive_decide(**args, layer=0, n_layers=3, depth_confidence=0.95)


# (B, N0, N1, E, itemsize) -> (rows a block, blocks): csrc/adaptive.cu's
# launch at the adaptive path's buckets, batches of 1, 2 and 4, N0 != N1 and
# pairs whose rows are no multiple of a block's slice
DECIDE_PLANS = {
    "B=1 1024x1024 bf16": ((1, 1024, 1024, 256, 2), (8, 256)),
    "B=1 1024x1024 fp32 (MIXED rows)": ((1, 1024, 1024, 256, 4), (8, 256)),
    "B=2 1024x772": ((2, 1024, 772, 256, 2), (8, 450)),
    "B=4 1024x772": ((4, 1024, 772, 256, 4), (16, 452)),
    "B=4 512x512": ((4, 512, 512, 256, 2), (16, 256)),
    "B=8 1024x1024": ((8, 1024, 1024, 256, 4), (32, 512)),
    "B=3 128x256": ((3, 128, 256, 256, 2), (8, 144)),
}


@pytest.mark.parametrize("case", list(DECIDE_PLANS))
def test_decide_plan_covers_every_row_once(case):
    """decide_plan (csrc/adaptive.cu:decide_rows): block (x, b) takes rows
    [x R, min((x + 1) R, N0 + N1)) of pair b, one warp a row in turn, so
    every row of every pair is read by exactly one block and one warp; the
    largest slice that still gives 256 blocks, a row per warp at least; a
    block's rows fit its shared memory; one pair of 1024 x 1024 rows fills
    the card (an H100 has 132 SMs)."""
    (bsz, n0, n1, e, size), (rows, blocks) = DECIDE_PLANS[case]
    plan = layer_stack.decide_plan(bsz, n0, n1, e, size)
    assert (plan.rows, plan.blocks) == (rows, blocks)
    assert plan.threads == 256 and plan.smem == rows * e * size <= 48 * 1024
    n, warps = n0 + n1, plan.threads // 32
    per_pair = plan.blocks // bsz
    assert per_pair * bsz == plan.blocks and per_pair == -(-n // rows)
    for b in range(bsz):
        seen = np.zeros(n, np.int32)
        for x in range(per_pair):
            lo, hi = x * rows, min((x + 1) * rows, n)
            assert hi > lo
            for w in range(warps):  # the kernel's warp loop over its slice
                for i in range(w, hi - lo, warps):
                    seen[lo + i] += 1
        assert (seen == 1).all()
    if n % rows:
        assert n - (per_pair - 1) * rows < rows  # the last slice is partial
    if rows > warps:  # the next smaller slice would have been taken
        assert bsz * -(-n // rows) >= 256
    if rows < 32:  # the next larger slice would not give 256 blocks
        assert bsz * -(-n // (2 * rows)) < 256
    if (bsz, n0, n1) == (1, 1024, 1024):
        assert plan.blocks >= 132


def test_decide_plan_rejects_rows_past_shared_memory():
    with pytest.raises(ValueError):
        layer_stack.decide_plan(1, 1024, 1024, 2048, 4)  # 8 rows of 8 KB


@pytest.mark.parametrize("width", [False, True], ids=["depth, masked", "depth and width, masked"])
def test_decision_batch_matches_jax(width):
    """The plain decision (adaptive_decide_plain, which chip_smoke.py holds
    the kernel to exactly) against the JAX kernel's in-kernel decision on a
    B = 3 batch, masked, N0 != N1, over L = 2 layers: pair 0 retired before
    the stack (JAX's ``exited``, the port's exit register 0), pair 1
    confident (it stops at layer 0), pair 2 live to g = L - 1, whose forced
    exit it takes; under width, pair 2's confident tokens are pruned at
    layer 0 and pair 1 prunes nothing (it stopped). Token head on feature
    0; FP32."""
    n_layers, n0, n1 = 2, N, 2 * N
    tree = _tree(n_layers, token={
        "w": np.tile(np.eye(256, 1, dtype=np.float32)[None], (n_layers - 1, 1, 1)),
        "b": np.zeros((n_layers - 1, 1), np.float32)})
    if width:
        tree = _with_match_bias(tree, -50.0)  # confident tokens are not matchable
    (d0, f0), (d1, f1) = make_inputs(9, 3, n0, n1, tree["posenc"]["wr"])
    rng = np.random.default_rng(10)
    for d in (d0, d1):
        d[1, :, 0] = 100.0  # along the token head: every token confident
        d[2, :, 0] = rng.normal(0.0, 3.0, d.shape[1])  # a share of them
    l0, l1 = np.asarray([120, 100, 128], np.int32), np.asarray([250, 256, 200], np.int32)
    wc = 0.99 if width else -1.0
    jt = jax_weights.to_jax(tree, jnp.float32)
    want = jax_stack.transformer_stack_adaptive(
        jt["layers"], jt["token"], jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(f0),
        jnp.asarray(f1), jnp.asarray(l0), jnp.asarray(l1),
        jt["assign"]["match"] if width else None, jnp.asarray([True, False, False]),
        num_heads=4, head_dim=64, depth_confidence=0.95, width_confidence=wc)
    pt = weights.params_from_numpy(tree, "cpu", torch.float32)
    got = layer_stack.transformer_stack_adaptive_plain(
        pt["layers"], pt["token"], torch.from_numpy(d0), torch.from_numpy(d1),
        torch.from_numpy(f0), torch.from_numpy(f1), torch.from_numpy(l0), torch.from_numpy(l1),
        pt["assign"]["match"] if width else None,
        torch.tensor([0.0, n_layers + 1.0, n_layers + 1.0]),
        num_heads=4, head_dim=64, depth_confidence=0.95, width_confidence=wc)
    assert got[2].tolist() == np.asarray(want[2]).reshape(-1).tolist() == [0, 1, 2]
    if width:
        for i, lens in ((0, l0), (1, l1)):
            keep_j = np.asarray(want[3 + i])[..., 0]
            np.testing.assert_array_equal(got[3 + i].numpy(), keep_j)
            prefix = np.arange(keep_j.shape[1])[None] < lens[:, None]
            assert (keep_j[:2] == prefix[:2]).all()  # dead and stopped pairs prune nothing
            assert keep_j[2].sum() < lens[2]  # pair 2 prunes at layer 0
    for i in (0, 1):
        np.testing.assert_allclose(got[i][1:].numpy(), np.asarray(want[i])[1:], atol=ATOL, rtol=0)
