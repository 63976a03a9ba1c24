"""The benchmark's inputs: the bank and the genome."""

import json
import os

import numpy
import pytest

from benchmark.inputs import synthetic

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bank():
    return synthetic.pfam_shaped_profiles(2766, seed=0)


def config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_bank_shape_and_calibration(bank):
    assert len(bank) == 2766
    assert sum(gm.M for gm in bank) == 487354
    assert [gm.accession for gm in bank] == synthetic.accessions()[:2766]
    assert all(set(gm.stats) == {"MSV", "VITERBI", "FORWARD"} for gm in bank)
    lam = {v[1] for gm in bank for v in gm.stats.values()}
    assert lam == {float(numpy.float32(numpy.log(2.0)))}


def test_sizes_do_not_depend_on_the_seed(bank):
    cfg = config("genome")
    genomes = [synthetic.make_genome(cfg, bank, seed) for seed in (1, 2**31 + 11)]
    sizes = [(len(g.genes), g.bp, len(g.contigs),
              sorted(sum(1 for x in g.genes if x.contig == c) for c, _ in g.contigs))
             for g in genomes]
    assert sizes[0] == sizes[1]
    assert len(genomes[0].genes) == cfg["genes"] == 4288
    assert 4.6e6 < genomes[0].bp < 4.7e6
    assert genomes[0].contigs != genomes[1].contigs
    assert len(genomes[0].contigs) == 1


def test_genes_are_open_reading_frames_with_their_plants(bank):
    genome = synthetic.make_genome(config("genome"), bank, seed=5)
    contigs = dict(genome.contigs)
    for i, g in enumerate(genome.genes):
        protein = synthetic.translate_gene(contigs[g.contig], g.start, g.end, g.strand)
        assert protein[0] == "M" and protein[-1] == "*" and "*" not in protein[:-1]
        seq = contigs[g.contig]
        if g.strand > 0:
            rbs = seq[g.start - 14 : g.start - 8]
        else:
            rbs = seq[g.end + 7 : g.end + 13].translate(str.maketrans("ACGT", "TGCA"))[::-1]
        assert rbs == "AGGAGG"
        if g.cluster is None:
            assert g.profile == ((13 * i) % len(bank) if i % 4 != 3 else None) or g.domain == (0, 0)
        if g.profile is not None:
            assert 12 == g.domain[0] <= g.domain[1] < len(protein)
    assert sum(1 for g in genome.genes if g.cluster) == 60
    with open(os.path.join(HERE, "inputs", "cluster_domains.json")) as f:
        kinds = json.load(f)
    for g in genome.genes:
        if g.cluster:
            assert bank[g.profile].accession in kinds[g.cluster]


def test_h3m_writer_round_trips(tmp_path):
    from gecco_tpu_torch.hmm.h3m import read_h3m

    bank = synthetic.pfam_shaped_profiles(2766, seed=0)[:5]
    path = str(tmp_path / "bank.h3m")
    synthetic.write_h3m(path, bank)
    read = list(read_h3m(path))
    assert [h.accession for h in read] == [gm.accession for gm in bank]
    for h, gm in zip(read, bank):
        assert numpy.array_equal(h.match[1:], gm.match[1:])
        assert numpy.array_equal(h.trans, gm.trans)
        assert h.stats["FORWARD"] == pytest.approx(gm.stats["FORWARD"], abs=0)
