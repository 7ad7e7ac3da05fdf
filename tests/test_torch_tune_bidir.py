"""scripts/tune_torch_bidir.py on the CPU: every attribute it reads of the
repo's modules exists (``tune.<name>`` of scripts/tune_torch_stack_kernels.py,
``cs.<name>`` of chip_smoke.py and the kernel modules' names), so a helper
removed or renamed fails here and not at run time on the card. Importing
the script is not enough: its calls run only there."""

import ast
import importlib
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "tune_torch_bidir.py"
# the script's aliases of the repo's modules: a file, or an importable package module
MODULES = {"tune": ROOT / "scripts" / "tune_torch_stack_kernels.py", "cs": ROOT / "chip_smoke.py",
           "at": "lightglue_tpu_torch.kernels.attention",
           "ls": "lightglue_tpu_torch.kernels.layer_stack",
           "_build": "lightglue_tpu_torch.kernels._build"}


def _module(alias):
    where = MODULES[alias]
    if isinstance(where, str):
        return importlib.import_module(where)
    spec = importlib.util.spec_from_file_location(where.stem, where)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _uses():
    """alias -> the module its import names, and alias -> the attributes the
    script reads or sets on it."""
    tree = ast.parse(SCRIPT.read_text())
    imported, uses = {}, {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update({a.asname or a.name: a.name for a in node.names})
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.update({a.asname or a.name: f"{node.module}.{a.name}" for a in node.names})
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            uses.setdefault(node.value.id, set()).add(node.attr)
    return imported, uses


@pytest.mark.parametrize("alias", sorted(MODULES))
def test_tune_bidir_names_exist(alias):
    imported, uses = _uses()
    target = MODULES[alias]
    assert imported[alias] == (target.stem if isinstance(target, Path) else target)
    assert uses.get(alias), f"the script no longer reads {alias}: drop it from MODULES"
    module = _module(alias)
    missing = sorted(name for name in uses[alias] if not hasattr(module, name))
    assert not missing, f"scripts/tune_torch_bidir.py calls {alias}.{missing}, which do not exist"
