"""Deterministic synthetic profile/sequence generators for tests & benchmarks.

The generators are a copy of ``gecco_tpu.hmm.synthetic`` (host numpy):
the same seed gives the same profiles and sequences in both packages.
The full 2,766-profile Pfam subset the reference downloads at install
time (``setup.py:344-372``) cannot be fetched in a hermetic
environment; benchmarks therefore run on synthetic banks with a
Pfam-like length distribution, which exercise exactly the same kernels.

Added here: the benchmark workload of ``bench.py:238-256`` — a synthetic
genome, its called proteins cut to 512 residues, three in four with a
planted domain from a Pfam-shaped bank.  :func:`consensus_proteins`
plants a profile's whole consensus, ending on its last node, at
several offsets (a filter's best segment then ends on the last node at
every residue phase).  :func:`bench_workload` also
writes the planted residues back into the genome's codons, so a CLI run
on the genome searches the same proteins; :func:`write_library` writes
a bank as ``.h3m`` under accessions the embedded classifier keeps.
"""

import os
from typing import Dict, List, Sequence, Tuple

import numpy

from ..model import Gene, Strand
from ..orf.scan import ScanFinder
from ..seq import Seq, SeqRecord, reverse_complement, translate
from .h3m import write_h3m
from .io import AMINO_ALPHABET, BACKGROUND_F, ProfileHMM, encode_sequence
from .profile import SearchProfile, configure_many

__all__ = [
    "bench_proteins", "bench_workload", "consensus_proteins", "pfam_shaped_lengths", "pfam_shaped_profiles", "plant_domain",
    "synthetic_genome", "synthetic_profiles", "synthetic_proteins", "write_library",
]


def synthetic_profiles(
    count: int,
    min_length: int = 40,
    max_length: int = 250,
    seed: int = 0,
) -> List[SearchProfile]:
    """Generate ``count`` random-but-plausible configured profiles."""
    rng = numpy.random.default_rng(seed)
    hmms = []
    for p in range(count):
        M = int(rng.integers(min_length, max_length + 1))
        match = rng.dirichlet(numpy.full(20, 0.3), size=M + 1)
        insert = numpy.tile(BACKGROUND_F, (M + 1, 1))
        trans = numpy.zeros((M + 1, 7))
        for k in range(M + 1):
            mm = rng.dirichlet(numpy.array([50.0, 1.0, 1.0]))
            trans[k] = [mm[0], mm[1], mm[2], 0.5, 0.5, 0.6, 0.4]
        trans[M] = [1.0, 0.0, 0.0, 0.5, 0.5, 1.0, 0.0]
        hmm = ProfileHMM(
            name=f"SYN{p:05d}", accession=f"SY{p:05d}.1", description=None,
            length=M, alphabet="amino", match=match, insert=insert, trans=trans,
            stats={
                "MSV": (-8.0 - 0.01 * (M // 10), 0.70),
                "VITERBI": (-9.0, 0.70),
                "FORWARD": (-5.0, 0.70),
            },
        )
        hmms.append(hmm)
    return configure_many(hmms)


def synthetic_proteins(
    count: int,
    mean_length: int = 280,
    seed: int = 1,
) -> List["numpy.ndarray"]:
    """Generate encoded protein sequences with background composition."""
    rng = numpy.random.default_rng(seed)
    lengths = numpy.clip(
        rng.gamma(4.0, mean_length / 4.0, size=count).astype(int), 40, 4 * mean_length
    )
    p = BACKGROUND_F / BACKGROUND_F.sum()
    return [
        rng.choice(20, size=int(L), p=p).astype(numpy.int32)
        for L in lengths
    ]


def plant_domain(
    x: "numpy.ndarray",
    gm: SearchProfile,
    rng: "numpy.random.Generator",
    offset: int = 10,
    max_len: int = 100,
    divergence: float = 0.35,
) -> "numpy.ndarray":
    """Overwrite part of ``x`` with residues emitted from the profile.

    Samples a match-state path (emissions drawn from each node's match
    distribution, occasional node skips, ``divergence`` of positions
    substituted with background draws) so the sequence genuinely
    scores against ``gm`` — used to give benchmark workloads
    production-like hit rates so the domain-definition stage is
    exercised.  The divergence matters for load realism: a verbatim
    emission trace is a ~100%-identity hit, which passes the weak SSV
    filter against hundreds of unrelated profiles; real Pfam hits are
    diverged homologs (seed alignments sit at ~30-60% identity) whose
    cross-profile filter pass rate stays near the calibrated 2%.
    """
    match = gm.hmm.match[1:, :20]
    cdf = numpy.cumsum(match / match.sum(axis=1, keepdims=True), axis=1)
    u = rng.random((len(cdf), 1))
    emitted = (u > cdf).sum(axis=1).astype(numpy.int32)
    emitted = numpy.minimum(emitted, 19)
    p_bg = BACKGROUND_F / BACKGROUND_F.sum()
    mutate = rng.random(len(emitted)) < divergence
    emitted[mutate] = rng.choice(20, size=int(mutate.sum()), p=p_bg)
    keep = rng.random(len(emitted)) > 0.08          # ~8% deletions
    emitted = emitted[keep][:max_len]
    n = min(len(emitted), len(x) - offset)
    if n <= 0:
        return x
    out = x.copy()
    out[offset : offset + n] = emitted[:n]
    return out


def consensus_proteins(gm: SearchProfile, count: int = 5, length: int = 200,
                       seed: int = 0) -> List["numpy.ndarray"]:
    """``count`` random proteins of ``length`` residues, the ``s``-th with
    the profile's consensus (most likely match residues) at offset ``s``."""
    rng = numpy.random.default_rng(seed)
    cons = numpy.argmax(gm.hmm.match[1:, :20], axis=1).astype(numpy.int32)
    xs = []
    for off in range(count):
        x = rng.integers(0, 20, length).astype(numpy.int32)
        x[off : off + len(cons)] = cons
        xs.append(x)
    return xs


def pfam_shaped_lengths(count: int, seed: int = 0) -> "numpy.ndarray":
    """Model lengths following the real Pfam-A node-count histogram.

    Pfam 35 model lengths are roughly log-normal: median ~=130 nodes,
    bulk 50-400, a thin tail reaching past 2,000 (e.g. PF12252 at 2207).
    A clipped log-normal with ``mu=log(140), sigma=0.72`` reproduces
    that shape closely enough for kernel benchmarking (bucket fill,
    VMEM budget, padded-width mix) — unlike a uniform [40, 250] draw,
    which never exercises the wide buckets at all.
    """
    rng = numpy.random.default_rng(seed)
    lengths = rng.lognormal(mean=numpy.log(140.0), sigma=0.72, size=count)
    return numpy.clip(lengths, 25, 2200).astype(int)


def pfam_shaped_profiles(count: int, seed: int = 0) -> List[SearchProfile]:
    """``synthetic_profiles`` with a real-Pfam length histogram."""
    lengths = pfam_shaped_lengths(count, seed=seed)
    rng = numpy.random.default_rng(seed + 1)
    hmms = []
    for p, M in enumerate(lengths):
        M = int(M)
        match = rng.dirichlet(numpy.full(20, 0.3), size=M + 1)
        insert = numpy.tile(BACKGROUND_F, (M + 1, 1))
        trans = numpy.zeros((M + 1, 7))
        mm = rng.dirichlet(numpy.array([50.0, 1.0, 1.0]), size=M + 1)
        trans[:, 0:3] = mm
        trans[:, 3:7] = [0.5, 0.5, 0.6, 0.4]
        trans[M] = [1.0, 0.0, 0.0, 0.5, 0.5, 1.0, 0.0]
        hmm = ProfileHMM(
            name=f"SYN{p:05d}", accession=f"SY{p:05d}.1", description=None,
            length=M, alphabet="amino", match=match, insert=insert, trans=trans,
            stats={
                "MSV": (-8.0 - 0.01 * (M // 10), 0.70),
                "VITERBI": (-9.0, 0.70),
                "FORWARD": (-5.0, 0.70),
            },
        )
        hmms.append(hmm)
    return configure_many(hmms)


_CODON_BASES = "ACGT"


def synthetic_genome(
    n_genes: int = 3000,
    mean_gene: int = 900,
    intergenic: int = 120,
    seed: int = 0,
) -> str:
    """A bacterial-genome-shaped DNA string for gene-caller benchmarks.

    Alternating coding stretches (codon-biased, started with ATG, ended
    with TAA, strand flipped at random) and short intergenic spacers —
    random uniform DNA has a stop codon every ~21 codons and therefore
    produces none of the long-ORF candidate load a real genome gives
    the scanner; this layout reproduces realistic candidate statistics
    (ORF length histogram, ~85% coding density).
    """
    rng = numpy.random.default_rng(seed)
    # codon usage chosen so the TRANSLATED proteins match the Easel
    # amino background (p7_AminoFrequencies): the average real proteome
    # sits close to that composition, and HMMER's F1=2% MSV filter
    # contract is calibrated against it — a skewed codon model (e.g.
    # GC-rich) inflates the filter pass rate ~3x and mis-shapes every
    # downstream stage's benchmark load
    aa_freq = dict(zip(AMINO_ALPHABET, BACKGROUND_F / BACKGROUND_F.sum()))
    codons = [a + b + c for a in _CODON_BASES for b in _CODON_BASES for c in _CODON_BASES]
    amino_of = {codon: translate(codon) for codon in codons}
    codons_per_aa: Dict[str, int] = {}
    for aa in amino_of.values():
        codons_per_aa[aa] = codons_per_aa.get(aa, 0) + 1
    weights = numpy.array([
        aa_freq.get(amino_of[codon], 0.0) / codons_per_aa[amino_of[codon]]
        for codon in codons
    ])
    weights /= weights.sum()
    parts: List[str] = []
    for _ in range(n_genes):
        n_codons = max(30, int(rng.gamma(4.0, mean_gene / 4.0 / 3)))
        body = "".join(rng.choice(codons, size=n_codons, p=weights))
        gene = "ATG" + body + "TAA"
        if rng.random() < 0.5:
            complement = str.maketrans("ACGT", "TGCA")
            gene = gene.translate(complement)[::-1]
        spacer_len = max(20, int(rng.gamma(2.0, intergenic / 2.0)))
        spacer = "".join(rng.choice(list(_CODON_BASES), size=spacer_len))
        parts.append(gene)
        parts.append(spacer)
    return "".join(parts)


def bench_workload(
    n_genes: int = 3230, n_profiles: int = 2766, seed: int = 4,
) -> Tuple[str, List[SearchProfile], List["numpy.ndarray"]]:
    """``(genome, profiles, proteins)`` of the benchmark shape.

    The proteins are the genome's called genes cut to 512 residues,
    with a domain of profile ``(13 i) mod n_profiles`` planted in every
    protein ``i`` with ``i mod 4 != 3``; the returned genome carries the
    planted residues.  Profiles are uncalibrated.
    """
    genome, genes, profiles, seqs = _bench(n_genes, n_profiles, seed)
    return _plant_in_genome(genome, genes, seqs), profiles, seqs


def bench_proteins(
    n_genes: int = 3230, n_profiles: int = 2766, seed: int = 4,
) -> Tuple[List[SearchProfile], List["numpy.ndarray"]]:
    """``(profiles, proteins)`` of :func:`bench_workload`, without writing
    the planted residues back into the genome."""
    _genome, _genes, profiles, seqs = _bench(n_genes, n_profiles, seed)
    return profiles, seqs


def _bench(n_genes: int, n_profiles: int, seed: int):
    genome = synthetic_genome(n_genes, seed=seed)
    genes = list(ScanFinder().find_genes([SeqRecord(id="bench", seq=Seq(genome))]))
    profiles = pfam_shaped_profiles(n_profiles, seed=0)
    rng = numpy.random.default_rng(7)
    seqs = [encode_sequence(str(g.protein.seq))[:512] for g in genes]
    for i in range(len(seqs)):
        if i % 4 != 3:
            gm = profiles[(i * 13) % n_profiles]
            seqs[i] = plant_domain(seqs[i], gm, rng, max_len=min(150, gm.M))
    return genome, genes, profiles, seqs


def _plant_in_genome(genome: str, genes: Sequence[Gene], seqs) -> str:
    """Write the residues of ``seqs`` back into the genes' codons."""
    codons = {}
    for a in "ACGT":
        for b in "ACGT":
            for c in "ACGT":
                codons.setdefault(translate(a + b + c), []).append(a + b + c)
    rng = numpy.random.default_rng(11)
    dna = list(genome)
    for gene, x in zip(genes, seqs):
        called = encode_sequence(str(gene.protein.seq))[: len(x)]
        for j in numpy.flatnonzero(called != x):
            codon = str(rng.choice(codons[AMINO_ALPHABET[int(x[j])]]))
            if gene.strand == Strand.Reverse:
                at = gene.end - 3 * (j + 1)
                codon = reverse_complement(codon)
            else:
                at = gene.start - 1 + 3 * j
            dna[at : at + 3] = codon
    return "".join(dna)


def write_library(path: str, profiles: Sequence[SearchProfile]) -> None:
    """Write ``profiles`` as ``.h3m`` under the embedded Pfam accessions.

    Profile ``i`` takes the ``i``-th accession of the classifier's
    domain list (``gecco_tpu_torch/data/domains.tsv``), so the annotator's
    whitelist keeps every profile.  Renames the profiles in place.
    """
    data = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data", "domains.tsv")
    with open(data) as f:
        accessions = [line.strip() for line in f if line.strip()]
    if len(accessions) < len(profiles):
        raise ValueError(f"{len(profiles)} profiles, {len(accessions)} accessions")
    for gm, accession in zip(profiles, accessions):
        gm.hmm.accession = accession
    write_h3m(path, [gm.hmm for gm in profiles])
