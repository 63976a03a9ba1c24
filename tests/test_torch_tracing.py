"""The port's span tree and counters (``gecco_tpu_torch.profiling.TIMER``).

The tree's nesting, threads and reset on a timer of the test's own; the
spans, counters and ``-vv`` report of ``run --device cpu`` on
``test_torch_cli.py``'s small genome (with ``record_function`` made to
raise, so a span that called it with the profiler off would fail the
run), and of ``run --profile``, whose trace holds each span as a
``user_annotation`` on the spans' own clock and whose ``spans.json`` holds
the export; the search's
stage spans, on one device and on two CPU shards; ``kernel_builds`` with
the build faked.
"""

import glob
import io
import json
import threading

import pytest
import torch

from gecco_tpu_torch import _build
from gecco_tpu_torch.cli import main
from gecco_tpu_torch.hmm import stream
from gecco_tpu_torch.hmm.pipeline import SearchPipeline
from gecco_tpu_torch.hmm.stream import StreamDomains
from gecco_tpu_torch.profiling import SPANS_FILE, TIMER, StageTimer

from test_torch_cli import inputs  # noqa: F401  (the module's genome fixture)
from test_torch_pipeline import _port, multidomain_inputs

torch.set_num_threads(1)

#: the stage records of ``run`` on the genome, as before the tree
STAGES = ["extract-genes", "annotate-domains", "predict-probabilities", "extract-clusters",
          "predict-types"]
#: each span of a ``run --profile`` on the CPU and its parent (None: a root);
#: ``load-kernels`` is the card's, ``fit-model`` the ``train`` command's
PARENTS = {
    "import": None, "import-torch": "import", "profiler": None, "export-trace": None,
    "init-device": None, "read-inputs": None, "load-models": None, "write-outputs": None,
    "extract-genes": None, "annotate-domains": None, "predict-probabilities": None,
    "extract-clusters": None, "predict-types": None,
    "encode-sequences": "annotate-domains", "report-hits": "annotate-domains",
    "read-profiles": "annotate-domains", "configure-profiles": "annotate-domains",
    "build-bank": "annotate-domains", "upload-bank": "annotate-domains",
    "pack-sequences": "annotate-domains", "filter": "annotate-domains",
    "viterbi": "annotate-domains", "forward": "annotate-domains",
    "domains": "annotate-domains",
    "load-crf": "predict-probabilities", "decode": "predict-probabilities",
}


def _refuse(*args, **kwargs):
    raise AssertionError("record_function entered with the profiler off")


def _cli(inputs, out, extra):  # noqa: F811
    stream = io.StringIO()
    code = main(["run", "-g", str(inputs / "genome.fna"), "--hmm", str(inputs / "bank.h3m"),
                 "-o", str(out), "--force-tsv", "-j", "1", "--device", "cpu", *extra], stream)
    assert code == 0, stream.getvalue()
    return stream.getvalue()


@pytest.fixture(scope="module")
def plain_run(inputs, tmp_path_factory):  # noqa: F811
    """``run -vv``, no profiler, ``record_function`` refused; the log, the
    records, the export and the search's pipelines."""
    pipelines = []
    search = SearchPipeline.search

    def keep(self, sequences):
        pipelines.append(self)
        return search(self, sequences)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(SearchPipeline, "search", keep)
        patch.setattr(torch.profiler, "record_function", _refuse)
        patch.setattr(torch.autograd.profiler, "record_function", _refuse)
        log = _cli(inputs, tmp_path_factory.mktemp("plain"), ["-vv"])
    return log, list(TIMER.records), TIMER.export(), pipelines


@pytest.fixture(scope="module")
def profiled_run(inputs, tmp_path_factory):  # noqa: F811
    """``run --profile``: the export, the trace's events and the tree
    written beside the trace."""
    trace = tmp_path_factory.mktemp("trace")
    _cli(inputs, tmp_path_factory.mktemp("profiled"), ["--profile", str(trace)])
    (path,) = glob.glob(str(trace / "*.pt.trace.json"))
    with open(path) as f, open(trace / SPANS_FILE) as g:
        return TIMER.export(), json.load(f), json.load(g)


def _by_name(export):
    out = {}
    for span in export["spans"]:
        out.setdefault(span["name"], []).append(span)
    return out


def test_spans_nest_by_thread():
    timer = StageTimer()
    with timer.stage("outer") as outer:
        with timer.span("inner") as inner:
            assert timer.current() is inner
        parent = timer.current()
        spans = {}

        def work(device):
            with timer.attach(parent, device), timer.span("worker") as span:
                with timer.span("leaf") as leaf:
                    spans[device] = (span, leaf)

        def stray():
            with timer.span("stray") as span:
                spans["stray"] = span

        threads = [threading.Thread(target=work, args=(f"cuda:{d}",)) for d in range(2)]
        threads.append(threading.Thread(target=stray))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    assert timer.current() is None
    assert outer.parent is None and inner.parent == outer.id
    for device in ("cuda:0", "cuda:1"):
        span, leaf = spans[device]
        assert (span.parent, span.device) == (outer.id, device)
        assert (leaf.parent, leaf.device) == (span.id, device)
        assert outer.start_ns <= span.start_ns <= leaf.start_ns <= leaf.end_ns <= span.end_ns
    assert spans["stray"].parent is None and spans["stray"].device is None
    assert len({s["id"] for s in timer.export()["spans"]}) == 7
    assert timer.records == [("outer", outer.seconds)]      # only stages are records
    report = timer.report()
    assert report[0].startswith("timing: outer: ") and "(1 call, self " in report[0]
    assert any(line.startswith("timing:   worker [cuda:1]: ") for line in report)
    assert any(line.startswith("timing:     leaf [cuda:1]: ") for line in report)


def test_spans_make_no_torch_call_with_the_profiler_off(monkeypatch, plain_run):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    timer = StageTimer()
    with timer.stage("stage"), timer.span("span"):
        pass
    assert [s["name"] for s in timer.export()["spans"]] == ["stage", "span"]
    # the whole run, under the same patch (``plain_run``), spanned its stages
    _, _, export, _ = plain_run
    assert set(STAGES) <= set(_by_name(export))


def test_run_records_the_stages_as_before(plain_run):
    _, records, export, _ = plain_run
    assert [name for name, _ in records] == STAGES
    spans = _by_name(export)
    for name, seconds in records:
        (span,) = spans[name]
        assert seconds == (span["end_ns"] - span["start_ns"]) / 1e9


def test_run_exports_every_span(profiled_run):
    export, _, written = profiled_run
    assert written == export
    assert export["clock"] == "unix_ns"
    spans = _by_name(export)
    assert set(spans) == set(PARENTS)
    ids = {s["id"]: s for s in export["spans"]}
    for name, parent in PARENTS.items():
        for span in spans[name]:
            assert span["start_ns"] <= span["end_ns"]
            assert (ids[span["parent"]]["name"] if span["parent"] else None) == parent, name
            if span["parent"]:
                outer = ids[span["parent"]]
                assert outer["start_ns"] <= span["start_ns"] <= span["end_ns"] <= outer["end_ns"]
    (lead,), (command,) = spans["profiler"], spans["export-trace"]
    assert lead["end_ns"] <= spans["init-device"][0]["start_ns"]
    assert spans["write-outputs"][-1]["end_ns"] <= command["start_ns"]


def test_trace_annotations_lie_on_the_spans(profiled_run):
    """Each span opened while the profiler ran is a ``user_annotation`` of
    the trace within 2 ms of its own stamps, on the trace's clock."""
    export, trace, _ = profiled_run
    base = trace["baseTimeNanoseconds"]
    events = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            events.setdefault(e["name"], []).append(e)
    annotated = [s for s in export["spans"]
                 if s["name"] not in ("import", "import-torch", "profiler", "export-trace")]
    assert len(annotated) > 20
    for name, spans in _by_name({"spans": annotated}).items():
        marks = sorted(events.get(name, []), key=lambda e: e["ts"])
        assert len(marks) == len(spans), name
        for span, mark in zip(spans, marks):
            start = base + mark["ts"] * 1e3
            end = start + mark["dur"] * 1e3
            assert abs(start - span["start_ns"]) < 2e6 and abs(end - span["end_ns"]) < 2e6, name


def test_funnel_and_device_counters(plain_run):
    _, _, export, pipelines = plain_run
    (pipeline,) = pipelines
    counters = export["counters"]
    assert pipeline.stage_counts["pairs"] > 0
    assert {k[len("funnel."):]: v for k, v in counters.items()
            if k.startswith("funnel.")} == pipeline.stage_counts
    assert counters["host_pairs"] == pipeline.host_pairs
    # the domain stage's routes, each counted, host_pairs their sum
    assert {key: counters[key] for key in StreamDomains.COUNTS} == pipeline.domain_counts
    assert counters["host_pairs"] == counters["host_pairs.length"] + counters["host_pairs.overflow"]
    # the F1 mask, the Viterbi and Forward scores, the envelopes and the alignments
    assert counters["host_reads"] == 5
    bank = pipeline.bank
    tensors = [bank.e_odds, bank.trans, bank.e_log, bank.trans_log, bank.tbm_log, bank.lengths,
               bank.logratio] + [index for _, index in bank.classes]
    assert counters["bank_upload_bytes"] == sum(t.numel() * t.element_size() for t in tensors)
    assert "kernel_builds" not in counters


def test_vv_prints_the_tree(plain_run):
    log = plain_run[0]
    lines = [line.split(" INFO     ", 1)[-1] for line in log.splitlines()]
    tree = [line for line in lines if line.startswith("timing: ")]
    assert tree[0].startswith("timing: import: ")
    assert "timing:   import-torch: " in "\n".join(tree)
    for name in STAGES:
        assert any(line.startswith(f"timing: {name}: ") for line in tree), name
    for name in ("read-profiles", "filter", "domains"):
        assert any(line.startswith(f"timing:   {name}: ") for line in tree), name
    counters = [line for line in lines if line.startswith("counter: ")]
    assert lines.index(tree[-1]) < lines.index(counters[0])
    assert any(line.startswith("counter: funnel.pairs: ") for line in counters)


@pytest.fixture(scope="module")
def multidomain():
    profiles, seqs = multidomain_inputs()
    return _port(profiles), seqs


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]], ids=["one", "shards"])
def test_stage_seconds_are_the_spans(multidomain, devices):
    """The search's stage times are its spans: each of ``filter``,
    ``viterbi``, ``forward`` and ``domains`` once a shard, naming the
    shard's device, nested under the span open where the search started
    and in none of the others."""
    profiles, seqs = multidomain
    TIMER.reset()
    with TIMER.span("outer") as outer:
        pipeline = SearchPipeline(profiles, device="cpu", Z=6, domZ=6, devices=devices)
        assert pipeline.search(seqs)
    spans = _by_name(TIMER.export())
    for name in ("filter", "viterbi", "forward", "domains"):
        assert len(spans[name]) == (len(devices) if devices else 1)
        for span in spans[name]:
            assert span["parent"] == outer.id
            assert span["device"] == ("cpu" if devices else None)
            assert outer.start_ns <= span["start_ns"] <= span["end_ns"] <= outer.end_ns
    assert spans["build-bank"][0]["parent"] == outer.id


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]], ids=["one", "shards"])
def test_host_engine_spans_and_route_counts(multidomain, monkeypatch, devices):
    """Each pair the host engine defines is a span ``host-engine`` under its
    shard's ``domains``; ``domain_counts`` counts the pairs the device
    stages refuse (here every sequence longer than the shortest) and the
    long rows defined on the device (here every row past 0 residues),
    summed over shards, and ``host_pairs`` is the refused and overflowing
    pairs."""
    profiles, seqs = multidomain
    shortest = min(map(len, seqs))
    monkeypatch.setattr(StreamDomains, "_on_device", lambda self, length, width: length == shortest)
    monkeypatch.setattr(stream, "_MAX_LPS", 0)
    TIMER.reset()
    pipeline = SearchPipeline(profiles, device="cpu", Z=6, domZ=6, devices=devices)
    assert pipeline.search(seqs)
    counts = pipeline.domain_counts
    on_device = [(s, p) for s, p in pipeline.candidate_pairs if len(seqs[s]) == shortest]
    assert 0 < len(on_device) < len(pipeline.candidate_pairs)
    assert counts == {"host_pairs.length": len(pipeline.candidate_pairs) - len(on_device),
                      "host_pairs.overflow": 0, "domains.long_rows": len(on_device)}
    assert pipeline.host_pairs == counts["host_pairs.length"]
    spans = _by_name(TIMER.export())
    ids = {s["id"]: s for s in TIMER.export()["spans"]}
    assert len(spans["host-engine"]) == pipeline.host_pairs
    for span in spans["host-engine"]:
        parent = ids[span["parent"]]
        assert parent["name"] == "domains"
        assert span["device"] == parent["device"] == ("cpu" if devices else None)
        assert parent["start_ns"] <= span["start_ns"] <= span["end_ns"] <= parent["end_ns"]


def test_kernel_builds_counts_builds(monkeypatch, tmp_path):
    def compile(sources, target):
        with open(target, "w") as f:
            f.write("built")

    monkeypatch.setattr(_build, "_BUILD", str(tmp_path))
    monkeypatch.setattr(_build, "_compile", compile)
    monkeypatch.setattr(_build, "_open", lambda target: target)
    monkeypatch.setattr(_build, "_library", None)
    TIMER.reset()
    first = _build.library()
    assert TIMER.counters["kernel_builds"] == 1
    assert [s["name"] for s in TIMER.export()["spans"] if s["parent"] is None][-1] == "load-kernels"
    TIMER.reset()
    monkeypatch.setattr(_build, "_library", None)
    assert _build.library() == first
    assert TIMER.counters.get("kernel_builds", 0) == 0


def test_reset_keeps_the_import_span():
    TIMER.count("something")
    TIMER.reset()
    export = TIMER.export()
    assert [s["name"] for s in export["spans"]] == ["import", "import-torch"]
    assert export["counters"] == {} and TIMER.records == []
