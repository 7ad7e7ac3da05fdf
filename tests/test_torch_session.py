"""Port MatcherSession (plain versions on the CPU) against the JAX session,
its device rule, and the rule that the port imports neither JAX nor the JAX
package."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lightglue_tpu.config import LightGlueConfig as JLGC
from lightglue_tpu.config import PipelineConfig as JPC
from lightglue_tpu.config import SuperPointConfig as JSPC
from lightglue_tpu.precision import Precision as JPrecision
from lightglue_tpu.runtime import weights as jax_weights
from lightglue_tpu.runtime.session import MatcherSession as JaxSession
from lightglue_tpu_torch.config import LightGlueConfig, PipelineConfig, SuperPointConfig
from lightglue_tpu_torch.precision import Precision
from lightglue_tpu_torch.runtime.session import MatcherSession

from test_torch_superpoint import smooth_images

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "lightglue_tpu_torch"


def _configs(precision="fp32"):
    # random weights give near-uniform match probabilities: threshold 0 keeps
    # every mutual match, so the test compares implementations, not quality
    kw = dict(buckets=(128, 256), match_threshold=0.0, max_matches=256)
    return (
        JPC(superpoint=JSPC(max_num_keypoints=256), lightglue=JLGC(n_layers=2),
            precision=JPrecision(precision), **kw),
        PipelineConfig(superpoint=SuperPointConfig(max_num_keypoints=256),
                       lightglue=LightGlueConfig(n_layers=2),
                       precision=Precision(precision), **kw),
    )


@pytest.fixture(scope="module")
def sessions():
    jcfg, cfg = _configs()
    sp = jax_weights.init_superpoint(11)
    lg = jax_weights.init_lightglue(12, JLGC(n_layers=2))
    jax_session = JaxSession(sp, lg, config=jcfg, compile_cache_dir=None)
    return jax_session, MatcherSession(sp, lg, config=cfg, device="cpu")


def _match_set(r):
    return {
        (tuple(p0), tuple(p1)): s
        for p0, p1, s in zip(r["matched_kpts0"], r["matched_kpts1"], r["match_scores"])
    }


def test_match_pair_matches_jax_session(sessions):
    jax_session, session = sessions
    imgs = smooth_images(5, 1, 112, 152)[0]
    img0, img1 = imgs[:96, :128], imgs[16:112, 24:152]
    want = jax_session.match_pair(img0, img1)
    got = session.match_pair(img0, img1)
    assert got["num_keypoints0"] == want["num_keypoints0"] > 10
    assert got["num_keypoints1"] == want["num_keypoints1"]
    ours, theirs = _match_set(got), _match_set(want)
    assert theirs, "JAX found no matches; the comparison would be vacuous"
    iou = len(ours.keys() & theirs.keys()) / len(ours.keys() | theirs.keys())
    assert iou > 0.95, (len(ours), len(theirs), iou)
    for key in ours.keys() & theirs.keys():
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-3, atol=1e-4)
    assert got["scores"].shape == want["scores"].shape


def test_match_batch_equals_match_pair(sessions):
    _, session = sessions
    imgs = smooth_images(6, 4, 96, 128)
    batch = session.match_batch(imgs[:2], imgs[2:])
    for i in range(2):
        single = session.match_pair(imgs[i], imgs[2 + i])
        assert _match_set(batch[i]).keys() == _match_set(single).keys()


def test_session_input_checks(sessions):
    _, session = sessions
    with pytest.raises(ValueError, match="multiples of the stride-8"):
        session.extract(np.zeros((1, 90, 128, 1), np.float32))
    with pytest.raises(ValueError, match="float32"):
        session.extract(np.zeros((1, 96, 128, 1), np.float64))


def test_session_requires_card_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for precision in ("fp32", "mixed", "bf16", "int8"):  # every rung runs on the card
        with pytest.raises(RuntimeError, match="CUDA"):
            MatcherSession(config=_configs(precision)[1])


def _port_sources():
    # the package (kernels/stem.py included), chip_smoke.py and the port's
    # tuning scripts
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts").glob("tune_torch_*.py")))


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "lightglue_tpu"), f"{path}: imports {name}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import lightglue_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(lightglue_tpu_torch.__path__, 'lightglue_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'lightglue_tpu')]\n"
        "print(len([k for k in sys.modules if k.startswith('lightglue_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 13
