"""The port's float64 host checking path against the JAX package's.

``SearchPipeline(use_accelerator=False)`` in both packages: every pair
Forward-scored by the float64 host engine, the candidates rescored and
gated again in float64, their domains defined by ``define_domains``.
Both are float64 engines, so scores agree within 1e-6 bits.  The
workload is ``test_torch_pipeline.py``'s multidomain one (six profiles
of 40-80 nodes, eight proteins of up to 448 residues), small because
the host engine loops over residues in Python.
"""

import numpy
import pytest
import torch

from gecco_tpu.hmm import HMM as JaxHMM
from gecco_tpu.hmm import ProfileHMMAnnotator as JaxAnnotator
from gecco_tpu.hmm.pipeline import SearchPipeline as JaxSearchPipeline
from gecco_tpu.model import Gene as JaxGene, Protein as JaxProtein, Strand as JaxStrand
from gecco_tpu.seq import Seq as JaxSeq, SeqRecord as JaxSeqRecord

from gecco_tpu_torch.hmm import HMM, ProfileHMMAnnotator
from gecco_tpu_torch.hmm.h3m import write_h3m
from gecco_tpu_torch.hmm.io import AMINO_ALPHABET
from gecco_tpu_torch.hmm.pipeline import SearchPipeline
from gecco_tpu_torch.model import Gene, Protein, Strand
from gecco_tpu_torch.profiling import TIMER
from gecco_tpu_torch.seq import Seq, SeqRecord

from test_torch_pipeline import _port, multidomain_inputs

torch.set_num_threads(1)

#: bits; both packages score in float64
TOL = 1e-6


@pytest.fixture(scope="module")
def workload():
    profiles, seqs = multidomain_inputs()
    # GA cutoffs that split the hits: two profiles' thresholds above their
    # planted copies' scores
    for p, gm in enumerate(profiles):
        gm.hmm.cutoffs["GA"] = (60.0 if p % 3 == 0 else 20.0, 15.0)
    return profiles, _port(profiles), seqs


def _coords(d):
    return (d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from, d.hmm_to)


def _same_hits(got, want):
    assert [(h.sequence_index, h.profile.name) for h in got] == [
        (h.sequence_index, h.profile.name) for h in want]
    for a, b in zip(got, want):
        assert a.score == pytest.approx(b.score, abs=TOL)
        assert a.pvalue == pytest.approx(b.pvalue, rel=1e-6, abs=1e-300)
        assert a.evalue == pytest.approx(b.evalue, rel=1e-6, abs=1e-300)
        assert [_coords(d) for d in a.domains] == [_coords(d) for d in b.domains]
        for da, db in zip(a.domains, b.domains):
            assert da.bitscore == pytest.approx(db.bitscore, abs=TOL)
            assert da.i_evalue == pytest.approx(db.i_evalue, rel=1e-6, abs=1e-300)


@pytest.mark.parametrize("options", [{}, {"max_filter": True}, {"bit_cutoffs": "gathering"},
                                     {"bias_filter": False}],
                         ids=["default", "max_filter", "bit_cutoffs", "nobias"])
def test_host_path_matches_jax(workload, options):
    jax_profiles, profiles, seqs = workload
    reference = JaxSearchPipeline(jax_profiles, Z=6, domZ=6, use_accelerator=False, **options)
    expected = reference.search(seqs)
    pipeline = SearchPipeline(profiles, device="cpu", Z=6, domZ=6, use_accelerator=False,
                              **options)
    TIMER.reset()
    hits = pipeline.search(seqs)
    assert pipeline.stage_counts == reference.stage_counts
    pairs = len(seqs) * len(profiles)
    assert pipeline.stage_counts["F1"] == pipeline.stage_counts["F2"] == pairs
    assert pipeline.stage_cells["filter"] == reference.stage_cells["filter"] == 0.0
    for key in ("viterbi", "forward", "domains"):
        assert pipeline.stage_cells[key] == pytest.approx(reference.stage_cells[key])
    assert expected and sum(len(h.domains) >= 2 for h in hits) >= 2
    _same_hits(hits, expected)
    # nothing uploaded, nothing launched; the host engine defined every
    # rescored candidate's domains
    assert pipeline._torch_bank is None
    assert not [key for key in TIMER.counters if key.startswith("launch.")]
    assert pipeline.host_pairs >= len(hits)
    assert len(pipeline.candidate_pairs) == pipeline.stage_counts["F3"]
    s_arr, p_arr = pipeline.rescored_pairs
    assert len(s_arr) == len(p_arr) == pairs


def test_host_path_reports_float64_scores(workload):
    """The device path reports float32 F3 scores; the host path the
    float64 engine's, within 5e-3 bits of them on the same hits."""
    _jax_profiles, profiles, seqs = workload
    host = SearchPipeline(profiles, device="cpu", Z=6, domZ=6, use_accelerator=False)
    device = SearchPipeline(profiles, device="cpu", Z=6, domZ=6)
    by_key = {(h.sequence_index, h.profile.name): h for h in host.search(seqs)}
    hits = device.search(seqs)
    assert hits and all((h.sequence_index, h.profile.name) in by_key for h in hits)
    assert host.stage_cells["filter"] == 0.0 < device.stage_cells["filter"]
    for h in hits:
        assert h.score == pytest.approx(by_key[(h.sequence_index, h.profile.name)].score,
                                        abs=5e-3)


def test_backend_auto_resolves_to_plain_on_cpu(workload):
    _jax_profiles, profiles, seqs = workload
    from gecco_tpu_torch._device import resolve_backend

    assert resolve_backend("auto", torch.device("cpu")) == "torch"
    assert resolve_backend("cuda", torch.device("cpu")) == "cuda"
    with pytest.raises(ValueError):
        resolve_backend("pallas", torch.device("cpu"))
    auto = SearchPipeline(profiles, device="cpu", Z=6, domZ=6)
    assert auto.backend == "auto"
    plain = SearchPipeline(profiles, device="cpu", Z=6, domZ=6, backend="torch")
    a, b = auto.search(seqs[:4]), plain.search(seqs[:4])
    assert auto.stage_counts == plain.stage_counts
    assert [(h.sequence_index, h.profile.name, h.score) for h in a] == [
        (h.sequence_index, h.profile.name, h.score) for h in b]


def _genes(seqs, gene_type, protein_type, record_type, seq_type, strand):
    record = record_type(id="contig", seq=seq_type("A" * 10))
    return [
        gene_type(record, 1 + 3000 * i, 3000 * (i + 1), strand.Coding,
                  protein_type(f"contig_{i + 1}",
                               seq_type("".join(AMINO_ALPHABET[c] for c in x))))
        for i, x in enumerate(seqs)
    ]


def test_annotator_host_path_matches_jax(workload, tmp_path):
    jax_profiles, profiles, seqs = workload
    path = str(tmp_path / "bank.h3m")
    write_h3m(path, [gm.hmm for gm in profiles])
    mine = ProfileHMMAnnotator(HMM("Pfam", "0", "", path, size=6), use_accelerator=False,
                               device="cpu").run(
        _genes(seqs, Gene, Protein, SeqRecord, Seq, Strand))
    theirs = JaxAnnotator(JaxHMM("Pfam", "0", "", path, size=6), use_accelerator=False).run(
        _genes(seqs, JaxGene, JaxProtein, JaxSeqRecord, JaxSeq, JaxStrand))
    got = [[(d.name, d.start, d.end) for d in g.protein.domains] for g in mine]
    want = [[(d.name, d.start, d.end) for d in g.protein.domains] for g in theirs]
    assert got == want and sum(map(len, got)) >= 8
    for g, h in zip(mine, theirs):
        for a, b in zip(g.protein.domains, h.protein.domains):
            assert a.i_evalue == pytest.approx(b.i_evalue, rel=1e-6, abs=1e-300)
            assert a.pvalue == pytest.approx(b.pvalue, rel=1e-6, abs=1e-300)
