"""Port runtime/aot.py (plain versions on the CPU) against the live session
and the JAX module: the counterpart of tests/test_aot.py at its size (FP32,
2 layers, bucket 64, 64 keypoints, the extractor at 32x48), plus the stack
route's bucket 128 and the adaptive downshift's split artifact.

A reloaded program runs the same operators as the session's body on the
same inputs, so the two agree bit for bit; against JAX's reloaded artifact
the scores agree at tests/test_torch_session.py's tolerance."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from lightglue_tpu.config import LightGlueConfig as JLGC
from lightglue_tpu.config import PipelineConfig as JPC
from lightglue_tpu.config import SuperPointConfig as JSPC
from lightglue_tpu.precision import Precision as JPrecision
from lightglue_tpu.runtime import aot as jax_aot
from lightglue_tpu.runtime import weights as jax_weights
from lightglue_tpu.runtime.session import MatcherSession as JaxSession
from lightglue_tpu_torch.config import LightGlueConfig, PipelineConfig, SuperPointConfig
from lightglue_tpu_torch.kernels import _build
from lightglue_tpu_torch.models.lightglue import AdaptiveOutput, LightGlueOutput
from lightglue_tpu_torch.pipeline.extract import Extraction
from lightglue_tpu_torch.pipeline.match import Matches
from lightglue_tpu_torch.precision import Precision
from lightglue_tpu_torch.runtime import aot
from lightglue_tpu_torch.runtime import session as session_lib
from lightglue_tpu_torch.runtime import weights

ROOT = Path(__file__).resolve().parent.parent
KW = dict(buckets=(64, 128), match_threshold=1e-9, max_matches=64)
HW = (32, 48)
# the downshift's split artifact: width pruning at 0.05 after layer 2 of 4,
# at the 256 bucket (phase 2 runs at 128 where every pair fits)
DOWNSHIFT = LightGlueConfig(n_layers=4, depth_confidence=0.95, width_confidence=0.05,
                            downshift_layer=2)


def _match_inputs(batch, bucket, seed):
    rng = np.random.default_rng(seed)
    counts = bucket - rng.integers(0, 12, (2, batch))
    return (torch.from_numpy(rng.uniform(-1, 1, (batch, bucket, 2)).astype(np.float32)),
            torch.from_numpy(rng.uniform(-1, 1, (batch, bucket, 2)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((batch, bucket, 256), dtype=np.float32)),
            torch.from_numpy(rng.standard_normal((batch, bucket, 256), dtype=np.float32)),
            torch.from_numpy(counts[0].astype(np.int32)),
            torch.from_numpy(counts[1].astype(np.int32)))


def _same_bits(got, want) -> bool:
    """Equal pytrees: the same structure, every tensor of the same dtype and
    shape with equal bits."""
    gl, gs = pytree.tree_flatten(got)
    wl, ws = pytree.tree_flatten(want)
    return gs == ws and all(
        g.dtype == w.dtype and g.shape == w.shape
        and g.reshape(-1).view(torch.uint8).equal(w.reshape(-1).view(torch.uint8))
        for g, w in zip(gl, wl))


@pytest.fixture(scope="module")
def numpy_weights():
    return jax_weights.init_superpoint(11), jax_weights.init_lightglue(12, JLGC(n_layers=2))


@pytest.fixture(scope="module")
def session(numpy_weights):
    cfg = PipelineConfig(superpoint=SuperPointConfig(max_num_keypoints=64),
                         lightglue=LightGlueConfig(n_layers=2), precision=Precision.FP32, **KW)
    return session_lib.MatcherSession(*numpy_weights, config=cfg, device="cpu")


@pytest.fixture(scope="module")
def artifacts(session, tmp_path_factory):
    out = tmp_path_factory.mktemp("aot")
    paths = {(1, *k): p for k, p in aot.export_matcher(session, str(out)).items()}
    paths.update({(4, *k): p for k, p in aot.export_matcher(session, str(out), batch=4,
                                                            pairs=[(64, 64)]).items()})
    paths["extract"] = aot.export_extractor(session, str(out), HW)
    return paths


def _live(session, inputs):
    with torch.inference_mode():
        return session._match_eager(False, *inputs)


@pytest.mark.parametrize("batch,bucket", [(1, 64), (1, 128), (4, 64)],
                         ids=["b1-64-per-block", "b1-128-stack", "b4-64-per-block"])
def test_reload_equals_the_session_body(session, artifacts, batch, bucket):
    inputs = _match_inputs(batch, bucket, seed=bucket + batch)
    got = aot.load_exported(artifacts[(batch, bucket, bucket)])(session.lg_params, *inputs)
    assert type(got[0]) is LightGlueOutput and type(got[1]) is Matches
    assert got[1].count.sum() > 0
    assert _same_bits(got, _live(session, inputs))


def test_extractor_reload_equals_the_session(session, artifacts):
    image = torch.from_numpy(np.random.default_rng(5).random((1, *HW, 1)).astype(np.float32))
    got = aot.load_exported(artifacts["extract"])(session.sp_params, image)
    assert type(got) is Extraction and int(got.count[0]) > 0
    with torch.inference_mode():
        assert _same_bits(got, session._extract_eager(image))


def test_reloaded_scores_match_jax(session, artifacts, numpy_weights, tmp_path):
    """The same numpy weights and inputs through JAX's export_matcher /
    load_exported (its Pallas kernels in interpret mode)."""
    jcfg = JPC(superpoint=JSPC(max_num_keypoints=64), lightglue=JLGC(n_layers=2),
               precision=JPrecision.FP32, **KW)
    jax_session = JaxSession(*numpy_weights, config=jcfg, compile_cache_dir=None)
    jax_paths = jax_aot.export_matcher(jax_session, str(tmp_path), pairs=[(64, 64)])
    inputs = _match_inputs(1, 64, seed=3)
    want, _ = jax_aot.load_exported(jax_paths[(64, 64)])(
        jax_session.lg_params, *(jnp.asarray(t.numpy()) for t in inputs))
    got, _ = aot.load_exported(artifacts[(1, 64, 64)])(session.lg_params, *inputs)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("key,ops", [
    ((1, 128, 128), {"linear", "attention", "ln_gelu"}),
    ((1, 64, 64), {"fused_mha", "bidirectional_cross_attention"}),
    ("extract", {"relu_conv1a_shift", "conv3x3", "nms_candidates"}),
], ids=["stack route", "per-block route", "extraction"])
def test_graph_names_the_kernel_operators(artifacts, key, ops):
    program = torch.export.load(artifacts[key])
    assert program.example_inputs is None  # the weights are an input, not part of the file
    named = {n.target.name().split("::")[1].split(".")[0] for n in program.graph.nodes
             if n.op == "call_function" and isinstance(n.target, torch._ops.OpOverload)
             and n.target.namespace == _build.NAMESPACE}
    assert named == ops


def test_fresh_process_reproduces_the_saved_outputs(session, artifacts, tmp_path):
    """A process that imports only runtime.aot loads both artifacts and gives
    the outputs saved here, bit for bit, without loading JAX."""
    inputs = _match_inputs(1, 64, seed=9)
    image = torch.from_numpy(np.random.default_rng(6).random((1, *HW, 1)).astype(np.float32))
    with torch.inference_mode():
        want = (session._match_eager(False, *inputs), session._extract_eager(image))
    saved = tmp_path / "io.pt"
    torch.save(dict(match=(artifacts[(1, 64, 64)], (session.lg_params, *inputs), want[0]),
                    extract=(artifacts["extract"], (session.sp_params, image), want[1])), saved)
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import torch\n"
        "import torch.utils._pytree as pytree\n"
        "from lightglue_tpu_torch.runtime import aot\n"
        f"for name, (path, args, want) in torch.load({str(saved)!r}, weights_only=False).items():\n"
        "    got = aot.load_exported(path)(*args)\n"
        "    gl, gs = pytree.tree_flatten(got)\n"
        "    wl, ws = pytree.tree_flatten(want)\n"
        "    assert gs == ws and type(got).__name__ == type(want).__name__, name\n"
        "    assert all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(gl, wl)), name\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'lightglue_tpu')]\n"
        "assert not bad, bad\n"
        "print('reloaded', flush=True)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and "reloaded" in out.stdout, out.stdout + out.stderr


def _downshift_tree(arm):
    """Weights whose pruning takes the downshift's half-width arm ("fits":
    random token heads, tests/test_torch_adaptive.py's) or its full-width
    arm ("full": token bias -10, so no token is confident and none is
    pruned)."""
    n = DOWNSHIFT.n_layers
    tree = weights.init_lightglue(0, LightGlueConfig(n_layers=n))
    if arm == "fits":
        w = np.random.default_rng(3).standard_normal((n - 1, 256, 1)).astype(np.float32)
        tree["token"] = {"w": w, "b": np.zeros((n - 1, 1), np.float32)}
    else:
        tree["token"] = {"w": np.zeros((n - 1, 256, 1), np.float32),
                         "b": np.full((n - 1, 1), -10.0, np.float32)}
    return tree


@pytest.fixture(scope="module")
def downshift_artifact(tmp_path_factory):
    cfg = PipelineConfig(superpoint=SuperPointConfig(max_num_keypoints=256), lightglue=DOWNSHIFT,
                         precision=Precision.FP32, buckets=(256,), match_threshold=0.0,
                         max_matches=256)
    session = session_lib.MatcherSession(lg_params=_downshift_tree("fits"), config=cfg,
                                         device="cpu")
    assert session_lib.reads_host(session.lg_params, 256, 256, cfg, session.policy)
    path = Path(aot.export_matcher(session, str(tmp_path_factory.mktemp("split")))[(256, 256)])
    assert sorted(p.name for p in path.iterdir()) == ["head.pt2", "rest_fits.pt2",
                                                      "rest_full.pt2"]
    return cfg, aot.load_exported(str(path))


@pytest.mark.parametrize("arm", ["fits", "full"])
def test_downshift_split_artifact_equals_the_session(downshift_artifact, arm):
    """One artifact, weights as its argument: both arms of the host read,
    each equal to a session on the same weights. The arm shows in the
    survivors: every count fits the half width after the "fits" arm, and
    the "full" weights prune nothing, so their counts stay above it."""
    cfg, loaded = downshift_artifact
    session = session_lib.MatcherSession(lg_params=_downshift_tree(arm), config=cfg,
                                         device="cpu")
    inputs = _match_inputs(1, 256, seed=4)
    got = loaded(session.lg_params, *inputs)
    assert type(got[0]) is AdaptiveOutput
    survivors = torch.stack([got[0].lengths0, got[0].lengths1])
    if arm == "fits":
        assert 0 < int(survivors.min()) and int(survivors.max()) <= 128
    else:
        assert torch.equal(survivors, torch.stack(inputs[4:]))
    assert _same_bits(got, _live(session, inputs))


def test_enable_compile_cache_moves_the_library_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "_lib", None)
    cache = tmp_path / "cache" / "kernels"
    aot.enable_compile_cache(str(cache))
    assert cache.is_dir() and _build.BUILD_DIR == cache.resolve()
    assert _build.builds == 0  # nothing built on the CPU
    # a library loaded from another directory cannot move
    monkeypatch.setattr(_build, "_lib", object())
    monkeypatch.setattr(_build, "_lib_dir", (tmp_path / "elsewhere").resolve())
    with pytest.raises(RuntimeError, match="already loaded"):
        aot.enable_compile_cache(str(cache))
    monkeypatch.setattr(_build, "_lib_dir", cache.resolve())
    aot.enable_compile_cache(str(cache))  # its own directory again is fine


def test_session_compile_cache_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "_lib", None)
    default = _build.BUILD_DIR
    cfg = PipelineConfig(lightglue=LightGlueConfig(n_layers=1), buckets=(64,))
    session_lib.MatcherSession(config=cfg, device="cpu")
    assert _build.BUILD_DIR == default  # None keeps the checkout's build/torch_kernels/
    session_lib.MatcherSession(config=cfg, device="cpu", compile_cache_dir=str(tmp_path / "k"))
    assert _build.BUILD_DIR == (tmp_path / "k").resolve()
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    with pytest.raises(OSError):  # no silent fallback to another directory
        session_lib.MatcherSession(config=cfg, device="cpu",
                                   compile_cache_dir=str(blocker / "k"))
