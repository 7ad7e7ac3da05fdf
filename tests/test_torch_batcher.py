"""Port parallel/batcher.py:ContinuousBatcher (one device) against the JAX
ContinuousBatcher on the JAX session, and against the port's own per-pair
match_from_extractions; the sharded batcher over a ``[cpu] * 2`` mesh
against the single-device one."""

import numpy as np
import pytest
import torch

from lightglue_tpu.config import LightGlueConfig as JLGC
from lightglue_tpu.config import PipelineConfig as JPC
from lightglue_tpu.config import SuperPointConfig as JSPC
from lightglue_tpu.parallel.batcher import ContinuousBatcher as JaxBatcher
from lightglue_tpu.precision import Precision as JPrecision
from lightglue_tpu.runtime import weights as jax_weights
from lightglue_tpu.runtime.session import MatcherSession as JaxSession
from lightglue_tpu_torch.config import LightGlueConfig, PipelineConfig, SuperPointConfig
from lightglue_tpu_torch.parallel import mesh
from lightglue_tpu_torch.parallel.batcher import ContinuousBatcher, mesh_match_fn, session_match_fn
from lightglue_tpu_torch.pipeline.extract import Extraction
from lightglue_tpu_torch.precision import Precision
from lightglue_tpu_torch.runtime.session import MatcherSession

from test_batcher import _random_pair
from test_torch_host import one_torch_thread  # noqa: F401 (autouse)

BUCKETS = (128, 256)
BATCH = 4
# tests/test_batcher.py:39's stream, then three pairs of the 256 bucket
COUNTS = [(50, 60), (64, 30), (100, 120), (10, 10), (128, 90), (70, 40),
          (200, 150), (256, 180), (140, 250)]


@pytest.fixture(scope="module")
def sessions():
    kw = dict(buckets=BUCKETS, match_threshold=0.0, max_matches=256)
    lg = jax_weights.init_lightglue(4, JLGC(n_layers=2))
    jax_session = JaxSession(lg_params=lg, config=JPC(
        superpoint=JSPC(max_num_keypoints=256), lightglue=JLGC(n_layers=2),
        precision=JPrecision.FP32, **kw), compile_cache_dir=None)
    session = MatcherSession(lg_params=lg, config=PipelineConfig(
        superpoint=SuperPointConfig(max_num_keypoints=256), lightglue=LightGlueConfig(n_layers=2),
        precision=Precision.FP32, **kw), device="cpu")
    return jax_session, session


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(888)  # tests/conftest.py:rng
    return [_random_pair(rng, *ns) for ns in COUNTS]


def _logged(match_fn, log):
    """match_fn, recording each dispatch's (bucket, len0, len1)."""

    def run(params, kpts0, kpts1, desc0, desc1, len0, len1):
        log.append((kpts0.shape[1], kpts1.shape[1], np.asarray(len0).tolist(),
                    np.asarray(len1).tolist()))
        return match_fn(params, kpts0, kpts1, desc0, desc1, len0, len1)

    return run


def _run(batcher, pairs):
    for i, p in enumerate(pairs):
        batcher.submit(i, *p)
    return {r.pair_id: r for r in batcher.flush()}


@pytest.fixture(scope="module")
def results(sessions, pairs):
    jax_session, session = sessions
    jax_log, log = [], []
    jax_batcher = JaxBatcher(
        _logged(lambda params, *a: jax_session._match_fn(a[0].shape[1], a[1].shape[1])(
            params, *a), jax_log),
        jax_session.lg_params, buckets=BUCKETS, batch_size=BATCH)
    batcher = ContinuousBatcher(_logged(session_match_fn(session), log), session.lg_params,
                                buckets=BUCKETS, batch_size=BATCH, device="cpu")
    return (_run(jax_batcher, pairs), jax_log, jax_batcher), (_run(batcher, pairs), log, batcher)


def test_routing_and_dispatches_equal_jax(results):
    (_, jax_log, jax_batcher), (got, log, batcher) = results
    assert len(got) == len(COUNTS)
    assert log == jax_log  # every dispatch: the same bucket, the same pairs in order
    assert batcher.dispatches == jax_batcher.dispatches == 3  # 4 + padded 2, padded 3
    assert [entry[0] for entry in log] == [128, 128, 256]
    assert log[1][2] == [128, 70, 70, 70]  # the partial batch padded with its last pair


def test_results_match_jax(results):
    (want, _, _), (got, _, _) = results
    for i in range(len(COUNTS)):
        ours = {tuple(p): s for p, s in zip(got[i].indices.tolist(), got[i].scores)}
        theirs = {tuple(p): s for p, s in zip(np.asarray(want[i].indices).tolist(),
                                              np.asarray(want[i].scores))}
        assert theirs, f"pair {i}: JAX found no matches"
        iou = len(ours.keys() & theirs.keys()) / len(ours.keys() | theirs.keys())
        assert iou > 0.95, (i, iou)
        for key in ours.keys() & theirs.keys():
            np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-4, atol=1e-4)


def _extraction(kpts, desc, bucket):
    n = len(kpts)
    k = np.zeros((1, bucket, 2), np.float32)
    d = np.zeros((1, bucket, desc.shape[-1]), np.float32)
    k[0, :n], d[0, :n] = kpts, desc
    k, d = torch.from_numpy(k), torch.from_numpy(d)
    mask = torch.arange(bucket)[None] < n
    return Extraction(k, k, d, mask.float(), mask, torch.tensor([n], dtype=torch.int32))


def test_results_equal_per_pair_match(sessions, pairs, results):
    _, session = sessions
    _, (got, _, _) = results
    for i, (k0, k1, d0, d1) in enumerate(pairs):
        bucket = session.config.bucket_for(max(len(k0), len(k1)))
        _, m = session.match_from_extractions(_extraction(k0, d0, bucket),
                                              _extraction(k1, d1, bucket))
        c = int(m.count[0])
        assert got[i].indices.dtype == np.int32 and got[i].scores.dtype == np.float32
        np.testing.assert_array_equal(got[i].indices, m.indices[0, :c].numpy())
        np.testing.assert_array_equal(got[i].scores, m.scores[0, :c].numpy())


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2)])
def test_sharded_batcher_equals_single_device(sessions, pairs, results, data, model):
    """ContinuousBatcher(sharding=mesh) over [cpu] * 2 on the session's
    weights: the same dispatches as the single-device batcher, and each
    pair's matches equal (data parallel: the same rows bit for bit; tensor
    parallel: scores at fp32 1e-5, the order of the partial sums)."""
    _, session = sessions
    _, (want, log, single) = results
    m = mesh.make_mesh(data, model, devices=[torch.device("cpu")] * 2)
    sharded_log = []
    batcher = ContinuousBatcher(_logged(mesh_match_fn(m, session.config), sharded_log),
                                mesh.shard_lightglue_params(session.lg_params, m),
                                buckets=BUCKETS, batch_size=BATCH, sharding=m)
    got = _run(batcher, pairs)
    assert sharded_log == log and batcher.dispatches == single.dispatches
    assert batcher.device == torch.device("cpu")
    for i in range(len(COUNTS)):
        assert np.array_equal(got[i].indices, want[i].indices), i
        if model == 1:
            assert np.array_equal(got[i].scores, want[i].scores), i
        else:
            np.testing.assert_allclose(got[i].scores, want[i].scores, atol=1e-5, rtol=1e-5)


def test_batcher_rules(sessions, monkeypatch):
    _, session = sessions
    m = mesh.make_mesh(2, 1, devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="does not split"):
        ContinuousBatcher(mesh_match_fn(m, session.config), session.lg_params, batch_size=3,
                          sharding=m)
    with pytest.raises(ValueError, match="not both"):
        ContinuousBatcher(mesh_match_fn(m, session.config), session.lg_params, sharding=m,
                          device="cpu")
    with pytest.raises(ValueError, match="session.lg_params"):
        session_match_fn(session)({}, *(np.zeros((1, 128, 2)),) * 6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):  # the card unless the CPU is asked for
        ContinuousBatcher(session_match_fn(session), session.lg_params)
