"""The benchmark's inputs: the bank and the genome."""

import hashlib
import json
import os

import numpy
import pytest

from benchmark import run
from benchmark.inputs import synthetic
from benchmark.reference import judge

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


# --- the optional keys: none changes a configuration that leaves it out ----

#: SHA-256 of the inputs of ``genome`` (``benchmark/run.py``'s files, and
#: those of its warm-up cut), computed before the optional keys existed
PINNED = {
    0: {"full": ("7cfee8afae535b43bde214dcc477575273a75c2076422a649a26af2a63d02782",
                 "80329381c765fcd7e432b9329c0f34c171905aa0bd848fab1aae8ffca7cbc0ac",
                 "3d5e0afe1841ac27cbd3e047f2dd72670026aa6d3db38d000fe68cb1087b7b2a",
                 "442b17cdda98e62abe1292ffebee41cd9b775f11601e31863e001323fc9c8c47"),
        "warm": ("bbc96eedbfd7e78a527be96e52dbbc36a5ddfa44319b622a0f3afa111525d3ae",
                 "98bee2724c488ab3b452249ff03b7b272c64c2e68bc4129092f41ec55a107e0b",
                 "a7908b3ecd529ece7640f984c12f3982e2c9a8139ae7ea9b3674e2d80d5bb786",
                 "a396681fd339b88e94aec63f84e00f7ed24e94c9dbaf75d0f3f6861ef1f11a52")},
    1: {"full": ("20e68d71672b477d34c104f273eb6e337562111b4e186912c69ceb23cf95665d",
                 "80329381c765fcd7e432b9329c0f34c171905aa0bd848fab1aae8ffca7cbc0ac",
                 "f6311f267427a97e89fcbcce4120487b5ba990727e4d6735306f463f602e0f4e",
                 "312a0c5ce8ce77ef8beca9f535ec5384b4b69fd7a484f3bca0197f6105221077"),
        "warm": ("992699fc999dee0b5b7556e0410a82a3abead9d1c21cc0d423363e007898b23b",
                 "98bee2724c488ab3b452249ff03b7b272c64c2e68bc4129092f41ec55a107e0b",
                 "ebe65291926c9f66ad204c79cafed7de98057364991d21651e1d097f68f5ad76",
                 "7e26c3bffdb2ea88564fed9d9ea63330ff2fe9a55af019f58d16de753792ac08")},
    2147483901: {"full": ("22340a10ec382ecedbb2ec84b4217315b6756ec1e5955584ad9874a17a485c7d",
                          "80329381c765fcd7e432b9329c0f34c171905aa0bd848fab1aae8ffca7cbc0ac",
                          "fe739c62063a6c72e242a6b5068b4e81b91a513d603285f4253c598e6b1ffce9",
                          "7063912dfe46ddd01cf9a5262bce3930be1f627491f6ddbb3d7e023e6377ac83"),
                 "warm": ("0f36638b1a2ed83f42e42fc351419cf6f05b3f2d4f08e2f0c5299aab3d4e9001",
                          "98bee2724c488ab3b452249ff03b7b272c64c2e68bc4129092f41ec55a107e0b",
                          "265508898a03a0b713218ddb4bdafa5699fb3c44519991658e7aa5793555c772",
                          "6903d28344537f4d4e43e2184aa230f4cf8972bd1662f3d4ec96fcce9bec9778")},
}
FILES = ("fasta", "bank", "genes", "features")
#: every table the ``predict`` traffic writes, so that all four files exist
ALL_INPUTS = {"inputs": list(FILES)}


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("seed", sorted(PINNED))
def test_genome_inputs_are_byte_identical_to_the_pinned(bank, tmp_path, seed):
    cfg = config("genome")
    _, _, full = run.make_inputs(cfg, ALL_INPUTS, seed, str(tmp_path), bank=bank)
    warm_dir = tmp_path / "warm"
    warm_dir.mkdir()
    _, _, warm = run.make_inputs(run.warm_config(cfg), ALL_INPUTS, seed, str(warm_dir), bank=bank)
    assert tuple(_sha256(full[k]) for k in FILES) == PINNED[seed]["full"]
    assert tuple(_sha256(warm[k]) for k in FILES) == PINNED[seed]["warm"]


def _generated_outputs(genes_path, features_path):
    """A call's tables as if it had called every generated gene and reported
    the given domains of the genes whose number is even (so that both of the
    judge's groups have members)."""
    features = [r for r in judge.read_table(features_path)
                if int(r["protein_id"].rsplit("_", 1)[1]) % 2 == 0]
    return judge.Outputs(judge.read_table(genes_path), features, [])


def test_judge_samples_the_pinned_genes_of_genome(bank, tmp_path):
    seed = 2147483901
    _, genome, paths = run.make_inputs(config("genome"), ALL_INPUTS, seed, str(tmp_path), bank=bank)
    out = _generated_outputs(paths["genes"], paths["features"])
    ref = judge.Reference(genome, bank, subcommand="run", seed=seed, judged=["genes", "search"])
    sample = ref.sample(out)
    searched = {r["protein_id"]: ref.searched(r, [x for x in out.features
                                                   if x["protein_id"] == r["protein_id"]])
                for r in sample}
    blob = json.dumps({"ids": [r["protein_id"] for r in sample], "searched": searched},
                      sort_keys=True)
    assert len(sample) == judge.SAMPLE_REPORTED + judge.SAMPLE_QUIET
    assert hashlib.sha256(blob.encode()).hexdigest() == (
        "fc8924e1b464c33b79f000af1f4f590c695c4d2fff2d55ba0750cfb018a4681e")


#: a configuration with every optional key: an assembly of contigs of
#: lognormal gene counts (some smaller than a run), a tail of modular
#: proteins from 1,700 to 6,700 residues, GC-rich codons and spacers
ASSEMBLY = {"genes": 600, "cluster_runs": [10, 20, 30],
            "contig_genes": {"median": 30, "sigma": 0.8, "min": 4},
            "protein_tail": {"share": 0.02, "aa": [1700, 6700], "module_aa": 1000},
            "gc3": 0.92, "spacer_gc": 0.7}


def _assembly(**change):
    cfg = dict(config("genome"), **ASSEMBLY)
    cfg.update(change)
    return {k: v for k, v in cfg.items() if v is not None}


def _in_runs(counts_per_contig, sizes):
    """Whether the cluster genes of each contig are some of the runs, each run
    in one contig."""
    def place(i, left):
        if i == len(sizes):
            return not any(left)
        return any(place(i + 1, left[:c] + (left[c] - sizes[i],) + left[c + 1:])
                   for c in range(len(left)) if left[c] >= sizes[i])
    return place(0, tuple(counts_per_contig))


def test_contigs_are_fixed_named_and_hold_their_genes_and_runs(bank):
    cfg = _assembly()
    shapes = []
    for seed in (3, 2**31 + 19):
        genome = synthetic.make_genome(cfg, bank, seed)
        names = [name for name, _ in genome.contigs]
        assert len(set(names)) == len(names) > 5
        assert names == [f"contig{i + 1:05d}" for i in range(len(names))]
        contigs = dict(genome.contigs)
        per_contig = {name: [g for g in genome.genes if g.contig == name] for name in names}
        for name, genes in per_contig.items():
            assert genes, name
            assert all(g.protein_id.startswith(name + "_") for g in genes)
            # a spacer (at least 20 bp) before the first gene's unit and after the last
            assert min(g.start for g in genes) > 20
            assert max(g.end for g in genes) <= len(contigs[name]) - 20
        assert sum(len(genes) for genes in per_contig.values()) == cfg["genes"]
        clustered = [sum(1 for g in genes if g.cluster) for genes in per_contig.values()]
        assert sum(clustered) == sum(cfg["cluster_runs"])
        assert _in_runs(clustered, cfg["cluster_runs"])
        shapes.append((len(names), sorted(len(genes) for genes in per_contig.values()), genome.bp))
    assert shapes[0][:2] == shapes[1][:2]
    assert min(shapes[0][1]) < max(cfg["cluster_runs"])


def test_a_contig_layout_with_no_room_for_a_run_fails(bank):
    cfg = _assembly(contig_genes={"median": 5, "sigma": 0.0, "min": 1}, protein_tail=None)
    with pytest.raises(ValueError, match="no room for a cluster run"):
        synthetic.make_genome(cfg, bank, 1)


def test_tail_proteins_sit_in_the_runs_with_a_domain_a_module(bank, tmp_path):
    cfg = _assembly()
    lo, hi = cfg["protein_tail"]["aa"]
    module = cfg["protein_tail"]["module_aa"]
    with open(os.path.join(HERE, "inputs", "cluster_domains.json")) as f:
        kinds = json.load(f)
    seed = 2**31 + 5
    _, genome, paths = run.make_inputs(cfg, ALL_INPUTS, seed, str(tmp_path), bank=bank)
    contigs = dict(genome.contigs)
    tail = [g for g in genome.genes if g.tail]
    assert len(tail) == round(cfg["protein_tail"]["share"] * cfg["genes"])
    assert max(g.aa for g in tail) > 4096
    for g in tail:
        assert lo <= g.aa <= hi and g.cluster is not None
        protein = synthetic.translate_gene(contigs[g.contig], g.start, g.end, g.strand)
        assert protein[0] == "M" and protein[-1] == "*" and "*" not in protein[:-1]
        assert len(g.plants) == g.aa // module
        spans = [domain for _, domain in g.plants]
        assert all(a <= b for a, b in spans)
        assert all(b < c for (_, b), (c, _) in zip(spans, spans[1:]))
        assert spans[-1][1] <= g.aa
        accessions = [bank[p].accession for p, _ in g.plants]
        cycle = kinds[g.cluster]
        j = cycle.index(accessions[0])
        assert accessions == [cycle[(j + m) % len(cycle)] for m in range(len(accessions))]
    # the predict traffic's table: a row for every plant
    rows = judge.read_table(paths["features"])
    assert len(rows) == sum(len(g.plants) for g in genome.genes)
    # the judge draws its tail group after the others
    out = _generated_outputs(paths["genes"], paths["features"])
    ref = judge.Reference(genome, bank, subcommand="run", seed=seed, judged=["search"])
    sample = ref.sample(out)
    assert sum(1 for r in sample if ref.generated(r).tail) >= judge.SAMPLE_TAIL
    for r in sample:
        gene = ref.generated(r)
        assert set(ref.planted(r)) == {p for p, _ in gene.plants}


def _third_positions(genome):
    contigs = dict(genome.contigs)
    for g in genome.genes:
        dna = contigs[g.contig][g.start - 1 : g.end]
        if g.strand < 0:
            dna = dna.translate(str.maketrans("ACGT", "TGCA"))[::-1]
        protein = synthetic.translate_gene(contigs[g.contig], g.start, g.end, g.strand)
        yield protein[1:-1], dna[5:-3:3]      # past the initiator, before the stop


def test_gc_rich_codons_and_spacers_reach_their_shares(bank):
    cfg = _assembly()
    genome = synthetic.make_genome(cfg, bank, 11)
    weights = synthetic.codon_weights(cfg["gc3"])
    codons, counts = synthetic._codon_choices()
    strong = numpy.isin(codons[:, :, 2], numpy.frombuffer(b"GC", dtype=numpy.uint8))
    p_strong = (weights * strong).sum(axis=1) / weights.sum(axis=1)
    residues, thirds = zip(*_third_positions(genome))
    encoded = synthetic.encode_protein("".join(residues))
    thirds = "".join(thirds)
    reached = (thirds.count("G") + thirds.count("C")) / len(thirds)
    predicted = float(p_strong[encoded].mean())
    # the spacers and the binding sites' gaps: everything but genes and motifs
    contigs = dict(genome.contigs)
    masked = {name: bytearray(seq.encode()) for name, seq in contigs.items()}
    for g in genome.genes:
        a, b = (g.start - 14, g.end) if g.strand > 0 else (g.start - 1, g.end + 13)
        masked[g.contig][a:b] = b"N" * (b - a)
        gap = (g.start - 8, g.start - 1) if g.strand > 0 else (g.end, g.end + 7)
        masked[g.contig][gap[0]:gap[1]] = contigs[g.contig][gap[0]:gap[1]].encode()
    spacer = b"".join(bytes(m) for m in masked.values()).replace(b"N", b"")
    spacer_gc = (spacer.count(b"G") + spacer.count(b"C")) / len(spacer)
    print(f"GC3 reached {reached:.4f}, predicted {predicted:.4f} (target {cfg['gc3']}); "
          f"spacer G+C {spacer_gc:.4f} (target {cfg['spacer_gc']}); genome G+C {genome.gc:.4f}")
    assert abs(reached - predicted) <= 0.02
    assert abs(predicted - cfg["gc3"]) <= 0.02
    assert abs(spacer_gc - cfg["spacer_gc"]) <= 0.02
    plain = synthetic.make_genome(_assembly(gc3=None, spacer_gc=None), bank, 11)
    assert genome.gc > plain.gc + 0.1
    # the same layout: sizes and strands are drawn before any base
    assert [(g.start, g.end, g.strand) for g in genome.genes] == \
        [(g.start, g.end, g.strand) for g in plain.genes]


@pytest.mark.parametrize("change", [{}, {"contig_genes": {"median": 6, "sigma": 0.5, "min": 2}}])
def test_the_warm_up_cut_of_a_configuration_with_every_key_generates(bank, tmp_path, change):
    cfg = _assembly(**change)
    _, genome, paths = run.make_inputs(run.warm_config(cfg), ALL_INPUTS, 7, str(tmp_path), bank=bank)
    assert len(genome.genes) == run.WARM["genes"] and len(genome.contigs) == 1
    assert all(os.path.exists(paths[k]) for k in FILES)
