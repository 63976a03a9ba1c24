"""``tools/torch_check.py``, the twin of ``tools/tpu_check.py``, on the CPU.

With ``--device cpu`` every kernel wrapper takes its plain version, so
the checks hold the plain versions against each other and against the
float64 host engine and host path; on the card the same tool holds the
CUDA kernels to them (``chip_smoke.py`` phase 9a).
"""

import importlib.util
import os

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_check", os.path.join(ROOT, "tools", "torch_check.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_torch_check_passes_on_cpu(capsys, monkeypatch):
    monkeypatch.delenv("GECCO_REFERENCE", raising=False)
    assert _tool().main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert "parity: ok (device=cpu)" in out
    assert "minipfam: skipped" in err and "minipfam.hmm" in err
    assert "viterbi: ok" in err and "multidomain: ok" in err


def test_torch_check_fails_on_mismatch(capsys, monkeypatch):
    """A kernel that disagrees with the float64 engine fails the tool."""
    tool = _tool()
    from gecco_tpu_torch.hmm import kernels

    real = kernels.dense_scores
    monkeypatch.setattr(kernels, "dense_scores",
                        lambda pack, bank, **kw: real(pack, bank, **kw) + 0.01)
    assert tool.main(["--device", "cpu"]) == 1
    assert "PARITY FAILURE: viterbi/dense" in capsys.readouterr().err
