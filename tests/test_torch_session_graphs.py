"""The port's per-bucket runner caches against the JAX session's: the match
keys' normalization of ``full`` (JAX session.py:144-163), the key sets that
``warmup`` fills (JAX :341-389) on the configurations of
tests/test_e2e.py:211-252, results after ``warmup`` against results without
it, returned arrays that a later call leaves alone, and the extraction's
``normalize_keypoints`` against JAX's. On the CPU a runner is the eager
body; chip_smoke.py holds the CUDA graphs to it on the card."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightglue_tpu.config import LightGlueConfig as JLGC
from lightglue_tpu.config import PipelineConfig as JPC
from lightglue_tpu.config import SuperPointConfig as JSPC
from lightglue_tpu.pipeline.extract import normalize_keypoints as jax_normalize
from lightglue_tpu.precision import Precision as JPrecision
from lightglue_tpu.runtime import weights as jax_weights
from lightglue_tpu.runtime.session import MatcherSession as JaxSession
from lightglue_tpu_torch.config import LightGlueConfig, PipelineConfig, SuperPointConfig
from lightglue_tpu_torch.models import lightglue
from lightglue_tpu_torch.pipeline.extract import normalize_keypoints
from lightglue_tpu_torch.precision import Precision, policy_for
from lightglue_tpu_torch.runtime import weights
from lightglue_tpu_torch.runtime.session import MatcherSession

from test_torch_superpoint import smooth_images

# LightGlue modes: fixed depth, adaptive depth only, adaptive width (+depth)
MODES = {"fixed": {}, "depth-only": dict(depth_confidence=0.95),
         "width": dict(depth_confidence=0.95, width_confidence=0.99)}


def _pair(mode, buckets=(64, 128), keypoints=128, max_matches=128, layers=2, **kw):
    """A JAX and a port PipelineConfig of the same setting (FP32)."""
    lg = dict(n_layers=layers, **MODES[mode])
    common = dict(buckets=buckets, max_matches=max_matches, **kw)
    return (JPC(superpoint=JSPC(max_num_keypoints=keypoints), lightglue=JLGC(**lg),
                precision=JPrecision.FP32, **common),
            PipelineConfig(superpoint=SuperPointConfig(max_num_keypoints=keypoints),
                           lightglue=LightGlueConfig(**lg), precision=Precision.FP32, **common))


def _sessions(mode, **kw):
    jcfg, cfg = _pair(mode, **kw)
    sp = jax_weights.init_superpoint(21)
    lg = jax_weights.init_lightglue(22, jcfg.lightglue)
    return (JaxSession(sp, lg, config=jcfg, compile_cache_dir=None),
            MatcherSession(sp, lg, config=cfg, device="cpu"))


def _jax_keys_only(session):
    """The JAX session's runner lookups with their keys recorded as they are
    (its own _extract_fn / _match_fn fill the caches) and nothing compiled or
    run: each returns a no-op."""
    extract_fn, match_fn = session._extract_fn, session._match_fn

    def extract(batch, h, w):
        extract_fn(batch, h, w)
        return lambda *a: None

    def match(b0, b1, full=False):
        match_fn(b0, b1, full)
        return lambda *a: None

    session._extract_fn, session._match_fn = extract, match


def _key_of(cache, runner):
    return next(k for k, v in cache.items() if v is runner)


@pytest.mark.parametrize("full", [False, True], ids=["masked", "full"])
@pytest.mark.parametrize("mode", list(MODES))
def test_match_keys_normalize_as_jax(mode, full):
    """Every (bucket0, bucket1, full) lands on the JAX session's key, the
    batch added: full only where not width-pruning, for adaptive only at the
    cap bucket."""
    jax_s, port = _sessions(mode)
    for b0 in (64, 128):
        for b1 in (64, 128):
            want = _key_of(jax_s._match_cache, jax_s._match_fn(b0, b1, full))
            got = _key_of(port._match_cache, port._match_fn(b0, b1, full, batch=3))
            assert got == (*want, 3), (b0, b1, full)
    assert {k[:3] for k in port._match_cache} == set(jax_s._match_cache)


@pytest.mark.parametrize("mode", list(MODES))
def test_full_bucket_unmasked_runner_equals_masked(mode):
    """JAX tests/test_e2e.py:179 on the port: where every pair fills its
    bucket the session runs the unmasked runner (fixed depth; adaptive
    depth-only at the cap bucket; width pruning always masks, so both keys
    are one runner), and its outputs equal the masked runner's at the same
    lengths: log assignments at JAX's 1e-5, match indices and counts
    equal."""
    cfg = _pair(mode, match_threshold=0.0)[1]
    session = MatcherSession(jax_weights.init_superpoint(21),
                             jax_weights.init_lightglue(22, JLGC(n_layers=2, **MODES[mode])),
                             config=cfg, device="cpu")
    b = max(cfg.buckets)
    rng = np.random.default_rng(3)
    k0, k1 = (torch.from_numpy(rng.uniform(-1, 1, (1, b, 2)).astype(np.float32))
              for _ in range(2))
    d0, d1 = (torch.from_numpy(rng.standard_normal((1, b, 256)).astype(np.float32))
              for _ in range(2))
    lens = torch.full((1,), b, dtype=torch.int32)
    masked, full = (session._match_fn(b, b, full=f) for f in (False, True))
    assert (masked is full) == (mode == "width")
    out_m, mat_m = masked(k0, k1, d0, d1, lens, lens)
    out_f, mat_f = full(k0, k1, d0, d1, lens, lens)
    np.testing.assert_allclose(out_f.scores.numpy(), out_m.scores.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(mat_f.indices.numpy(), mat_m.indices.numpy())
    assert int(mat_f.count[0]) == int(mat_m.count[0]) > 0


@pytest.mark.parametrize("pairs", [None, "all", [(64, 128), (128, 128)]],
                         ids=["diagonal", "all", "listed"])
@pytest.mark.parametrize("config", [
    # tests/test_e2e.py:211-252 (the first at 2 layers), and width pruning
    dict(mode="fixed", buckets=(128,), max_matches=128),
    dict(mode="depth-only", buckets=(64, 128), max_matches=64),
    dict(mode="width", buckets=(64, 128), max_matches=64),
], ids=["fixed 128", "depth-only 64,128", "width 64,128"])
def test_warmup_fills_the_jax_sessions_keys(config, pairs):
    if pairs is not None and pairs != "all" and config["buckets"] == (128,):
        pairs = [(128, 128)]
    jax_s, port = _sessions(**config)
    _jax_keys_only(jax_s)
    jax_s.warmup((48, 64), batch=2, pairs=pairs)
    port.warmup((48, 64), batch=2, pairs=pairs)
    assert set(port._extract_cache) == set(jax_s._extract_cache) == {(2, 48, 64)}
    assert {k[:3] for k in port._match_cache} == set(jax_s._match_cache)
    assert {k[3] for k in port._match_cache} == {2}


@pytest.mark.parametrize("mode", list(MODES))
def test_results_after_warmup_equal_results_without(mode):
    cfg = _pair(mode, buckets=(128, 256), keypoints=256, max_matches=256,
                match_threshold=0.0)[1]
    sp = jax_weights.init_superpoint(23)
    lg = jax_weights.init_lightglue(24, JLGC(n_layers=2, **MODES[mode]))
    warm = MatcherSession(sp, lg, config=cfg, device="cpu")
    cold = MatcherSession(sp, lg, config=cfg, device="cpu")
    warm.warmup((96, 128), pairs="all")
    warm.warmup((96, 128), batch=2)
    imgs = smooth_images(7, 4, 96, 128)
    for got, want in ((warm.match_pair(imgs[0], imgs[1]), cold.match_pair(imgs[0], imgs[1])),
                      *zip(warm.match_batch(imgs[:2], imgs[2:]),
                           cold.match_batch(imgs[:2], imgs[2:]))):
        assert got.keys() == want.keys()
        assert got["num_keypoints0"] > 10
        for key, value in got.items():
            if isinstance(value, np.ndarray):
                assert value.dtype == want[key].dtype and value.shape == want[key].shape, key
                np.testing.assert_array_equal(value, want[key], err_msg=key)
            else:
                assert value == want[key], key


@pytest.mark.parametrize("call", ["match_pair", "match_batch"])
def test_a_later_call_leaves_returned_arrays_alone(call):
    cfg = _pair("fixed", buckets=(128, 256), keypoints=256, max_matches=256,
                match_threshold=0.0)[1]
    session = MatcherSession(config=cfg, seed=5, device="cpu")
    imgs = smooth_images(8, 4, 96, 128)
    run = (lambda a, b: session.match_pair(a[0], b[0])) if call == "match_pair" else (
        lambda a, b: session.match_batch(a, b)[0])
    first = run(imgs[:2], imgs[2:])
    kept = copy.deepcopy(first)
    second = run(imgs[2:], imgs[:2])
    assert any(not np.array_equal(second[k], kept[k]) for k in ("keypoints0", "keypoints1"))
    for key, value in first.items():
        np.testing.assert_array_equal(value, kept[key], err_msg=key)


@pytest.mark.parametrize("hw", [(480, 640), (640, 480), (96, 128), (48, 64), (360, 488)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_normalize_keypoints_matches_jax(hw):
    """The center and scale filled on the device give JAX's values bit for bit."""
    h, w = hw
    rng = np.random.default_rng(h * w)
    kpts = np.stack([rng.integers(0, w, 300), rng.integers(0, h, 300)], -1)
    kpts = kpts.astype(np.float32)[None]
    got = normalize_keypoints(torch.from_numpy(kpts), h, w)
    want = np.asarray(jax_normalize(jnp.asarray(kpts), h, w))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,n", [(256, 256), (384, 384), (256, 128), (128, 128)])
def test_reads_host_names_the_downshift(m, n):
    """The session splits a match runner in two exactly where
    ``adaptive_head`` stops at the downshift's host read."""
    cfg = LightGlueConfig(n_layers=3, depth_confidence=0.95, width_confidence=0.99,
                          downshift_layer=1)
    params = weights.params_from_numpy(weights.init_lightglue(3, cfg))
    policy = policy_for(Precision.FP32)
    rng = np.random.default_rng(m + n)
    kpts = [torch.from_numpy(rng.uniform(-1, 1, (1, k, 2)).astype(np.float32)) for k in (m, n)]
    desc = [torch.from_numpy(rng.standard_normal((1, k, 256)).astype(np.float32)) for k in (m, n)]
    lengths = [torch.tensor([k - 7], dtype=torch.int32) for k in (m, n)]
    head = lightglue.adaptive_head(params, *kpts, *desc, *lengths, config=cfg, policy=policy)
    want = (m, n) == (256, 256)  # m == n with (m / 2) % 128 == 0 and 0 < ds <= L - 2
    assert ("fits" in head) == lightglue.reads_host(params, m, n, cfg, policy.act_dtype) == want
