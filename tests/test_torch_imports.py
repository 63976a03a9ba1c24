"""The port stands alone: no module of ``gecco_tpu_torch``, no line of
``chip_smoke.py`` or ``__graft_entry_torch__.py`` and no port tool
(``tools/torch_*.py``) imports ``gecco_tpu`` or ``jax``.

Every ``import`` and ``from ... import`` statement of the files is read
with :mod:`ast` (imports inside functions too); relative imports stay
inside the port.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("gecco_tpu", "jax")


def _sources():
    package = os.path.join(ROOT, "gecco_tpu_torch")
    paths = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "__graft_entry_torch__.py")]
    tools = os.path.join(ROOT, "tools")
    paths += [os.path.join(tools, f) for f in os.listdir(tools)
              if f.startswith("torch_") and f.endswith(".py")]
    for folder, _dirs, files in os.walk(package):
        paths += [os.path.join(folder, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_sources_found():
    paths = [os.path.relpath(p, ROOT) for p in _sources()]
    assert "chip_smoke.py" in paths
    assert "__graft_entry_torch__.py" in paths
    assert os.path.join("tools", "torch_check.py") in paths
    assert os.path.join("gecco_tpu_torch", "hmm", "kernels.py") in paths
    assert len(paths) > 40


@pytest.mark.parametrize("path", [os.path.relpath(p, ROOT) for p in _sources()])
def test_no_import_of_jax_package(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [(line, name) for line, name in _imported(tree)
           if name.split(".")[0] in BANNED]
    assert not bad, f"{path} imports {bad}"
