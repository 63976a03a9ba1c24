"""The comparison that decides ``correct`` fails what it must: the control
(the reference in bfloat16 in the program's place) and each fault that a
cell can have, planted under a run of the harness."""

import pytest

from .conftest import run_bench


@pytest.mark.parametrize("cell", ["tiny_genome.run", "tiny_genome.predict"])
def test_control_is_not_correct(tiny, cell):
    code, line, err = run_bench(tiny, "--workload", cell, "--seed", "21", "--seconds", "1",
                                "--control")
    assert code == 0, err
    assert line["correct"] is False
    failing = {name for name, c in line["checks"].items() if not c["value"] <= c["limit"]}
    assert "crf_p_gap" in failing
    if cell.endswith(".run"):
        assert failing & {"search_bits_gap", "search_coord_gap", "search_unmatched"}


@pytest.mark.parametrize("cell, fault, numbers", [
    ("tiny_genome.run", "pvalue", {"search_bits_gap"}),
    ("tiny_genome.run", "half", {"search_unmatched"}),
    ("tiny_genome.run", "crf", {"crf_p_gap"}),
    ("tiny_genome.run", "genes", {"genes_missed_pct"}),
    ("tiny_genome.run", "shift", {"genes_bad", "genes_missed_pct"}),
    ("tiny_genome.predict", "crf", {"crf_p_gap"}),
    ("tiny_genome.predict", "crf_half", {"tables_mismatch", "crf_p_gap"}),
])
def test_faults_are_not_correct(tiny, cell, fault, numbers):
    code, line, err = run_bench(tiny, "--workload", cell, "--seed", "22", "--seconds", "1",
                                "--child", "benchmark.tests.fault_child",
                                env={"GECCO_BENCH_FAULT": fault})
    assert code == 0, err
    assert line["correct"] is False
    failing = {name for name, c in line["checks"].items() if not c["value"] <= c["limit"]}
    assert numbers <= failing, line["checks"]
