"""``--profile`` on ``torch.profiler`` and the ``--devices`` option of the port's CLI.

``device_trace`` is the twin of ``gecco_tpu.profiling.xla_trace``
(``tests/test_profiling.py::test_xla_trace_noop_without_dir``): nothing
without a directory, a Perfetto-readable trace with one.  The CLI runs
are ``test_torch_cli.py``'s small genome on the CPU.
"""

import glob
import io
import json

import pytest
import torch

from gecco_tpu_torch.cli import main
from gecco_tpu_torch.profiling import device_trace

from test_torch_cli import _run, inputs  # noqa: F401  (the module's genome fixture)

torch.set_num_threads(1)


def _traces(directory):
    return sorted(glob.glob(str(directory / "*.pt.trace.json")))


def test_device_trace_noop_without_dir(tmp_path):
    for logdir in (None, ""):
        with device_trace(logdir):
            assert not torch.autograd.profiler._is_profiler_enabled
            value = int(torch.arange(4).sum())
        assert value == 6
    assert not list(tmp_path.iterdir())


def test_device_trace_writes_trace_on_cpu(tmp_path):
    with device_trace(str(tmp_path)):
        assert torch.autograd.profiler._is_profiler_enabled
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    (path,) = _traces(tmp_path)
    with open(path) as f:
        trace = json.load(f)
    names = {event.get("name") for event in trace["traceEvents"]}
    assert "aten::mm" in names
    assert not torch.autograd.profiler._is_profiler_enabled


def test_run_profile_writes_trace(inputs, tmp_path):  # noqa: F811
    """``run --profile DIR`` writes one trace that holds the search's
    plain kernels, and the same tables as ``run`` without it, which
    writes no trace."""
    traced = _run(inputs, tmp_path / "traced", main,
                  ["--device", "cpu", "--profile", str(tmp_path / "trace")])
    (path,) = _traces(tmp_path / "trace")
    with open(path) as f:
        names = {event.get("name") for event in json.load(f)["traceEvents"]}
    assert any(str(name).startswith("aten::") for name in names)
    plain = _run(inputs, tmp_path / "plain", main, ["--device", "cpu"])
    assert plain == traced
    assert not glob.glob(str(tmp_path / "plain" / "*.json"))
    assert _traces(tmp_path / "trace") == [path]


def test_devices_with_cpu_refused(inputs, tmp_path):  # noqa: F811
    stream = io.StringIO()
    code = main(["run", "-g", str(inputs / "genome.fna"), "--hmm", str(inputs / "bank.h3m"),
                 "-o", str(tmp_path / "out"), "--device", "cpu", "--devices", "2"], stream)
    assert code == 1 and "--devices" in stream.getvalue()
    assert not (tmp_path / "out" / "genome.features.tsv").exists()


@pytest.mark.parametrize("value", ["0", "-1", "some"])
def test_devices_value_rejected(value):
    stream = io.StringIO()
    assert main(["annotate", "-g", "x.fna", "--devices", value], stream) == 2
    assert "--devices" in stream.getvalue()
