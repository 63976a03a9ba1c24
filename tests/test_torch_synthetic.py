"""The port's benchmark workload builder and library writer, at a small size."""

import numpy

from gecco_tpu.hmm.h3m import read_h3m as jax_read_h3m

from gecco_tpu_torch.hmm.h3m import read_h3m
from gecco_tpu_torch.hmm.io import encode_sequence
from gecco_tpu_torch.hmm.synthetic import bench_proteins, bench_workload, write_library
from gecco_tpu_torch.orf.scan import ScanFinder
from gecco_tpu_torch.seq import Seq, SeqRecord


def test_bench_workload_plants_domains_in_the_genome():
    genome, profiles, seqs = bench_workload(n_genes=40, n_profiles=30)
    assert len(profiles) == 30
    assert seqs and all(0 < len(x) <= 512 for x in seqs)
    # the genome carries the planted residues: the planted proteins are
    # called again from it (gene calls may shift, so compare as sets)
    genes = ScanFinder().find_genes([SeqRecord(id="g", seq=Seq(genome))])
    called = {encode_sequence(str(g.protein.seq))[:512].tobytes() for g in genes}
    planted = [x.tobytes() for i, x in enumerate(seqs) if i % 4 != 3]
    assert sum(x in called for x in planted) >= len(planted) // 2


def test_bench_proteins_are_the_workloads():
    _, profiles, seqs = bench_workload(n_genes=40, n_profiles=30)
    again, proteins = bench_proteins(n_genes=40, n_profiles=30)
    assert [gm.name for gm in again] == [gm.name for gm in profiles]
    assert len(proteins) == len(seqs)
    assert all(numpy.array_equal(a, b) for a, b in zip(proteins, seqs))


def test_write_library_uses_whitelisted_accessions(tmp_path):
    _, profiles, _ = bench_workload(n_genes=8, n_profiles=5)
    path = str(tmp_path / "bank.h3m")
    write_library(path, profiles)
    back = list(read_h3m(path))
    assert [h.accession for h in back] == [gm.hmm.accession for gm in profiles]
    # the JAX package reads the same library
    assert [h.accession for h in jax_read_h3m(path)] == [h.accession for h in back]
    assert all(a.startswith("PF") for a in (h.accession for h in back))
    numpy.testing.assert_array_equal([h.M for h in back], [gm.M for gm in profiles])
