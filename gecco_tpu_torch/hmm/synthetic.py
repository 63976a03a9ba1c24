"""Synthetic workloads for driving the port at the benchmark shape.

The generators of ``gecco_tpu.hmm.synthetic`` (host numpy, reused as
is), plus the benchmark workload of ``bench.py:238-256``: a synthetic
genome, its called proteins cut to 512 residues, three in four with a
planted domain from a Pfam-shaped bank.  :func:`bench_workload` also
writes the planted residues back into the genome's codons, so a CLI run
on the genome searches the same proteins; :func:`write_library` writes
a bank as ``.h3m`` under accessions the embedded classifier keeps.
"""

import os
from typing import List, Sequence, Tuple

import numpy

import gecco_tpu
from gecco_tpu.hmm.h3m import write_h3m
from gecco_tpu.hmm.io import AMINO_ALPHABET, encode_sequence
from gecco_tpu.hmm.profile import SearchProfile
from gecco_tpu.hmm.synthetic import (
    pfam_shaped_profiles, plant_domain, synthetic_genome, synthetic_profiles,
    synthetic_proteins,
)
from gecco_tpu.model import Gene, Strand
from gecco_tpu.orf.scan import ScanFinder
from gecco_tpu.seq import Seq, SeqRecord, reverse_complement, translate

__all__ = [
    "bench_workload", "pfam_shaped_profiles", "plant_domain", "synthetic_genome",
    "synthetic_profiles", "synthetic_proteins", "write_library",
]


def bench_workload(
    n_genes: int = 3230, n_profiles: int = 2766, seed: int = 4,
) -> Tuple[str, List[SearchProfile], List["numpy.ndarray"]]:
    """``(genome, profiles, proteins)`` of the benchmark shape.

    The proteins are the genome's called genes cut to 512 residues,
    with a domain of profile ``(13 i) mod n_profiles`` planted in every
    protein ``i`` with ``i mod 4 != 3``; the returned genome carries the
    planted residues.  Profiles are uncalibrated.
    """
    genome = synthetic_genome(n_genes, seed=seed)
    genes = list(ScanFinder().find_genes([SeqRecord(id="bench", seq=Seq(genome))]))
    profiles = pfam_shaped_profiles(n_profiles, seed=0)
    rng = numpy.random.default_rng(7)
    seqs = [encode_sequence(str(g.protein.seq))[:512] for g in genes]
    for i in range(len(seqs)):
        if i % 4 != 3:
            gm = profiles[(i * 13) % n_profiles]
            seqs[i] = plant_domain(seqs[i], gm, rng, max_len=min(150, gm.M))
    return _plant_in_genome(genome, genes, seqs), profiles, seqs


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
    domain list (``gecco_tpu/data/domains.tsv``), so the annotator's
    whitelist keeps every profile.  Renames the profiles in place.
    """
    data = os.path.join(os.path.dirname(gecco_tpu.__file__), "data", "domains.tsv")
    with open(data) as f:
        accessions = [line.strip() for line in f if line.strip()]
    if len(accessions) < len(profiles):
        raise ValueError(f"{len(profiles)} profiles, {len(accessions)} accessions")
    for gm, accession in zip(profiles, accessions):
        gm.hmm.accession = accession
    write_h3m(path, [gm.hmm for gm in profiles])
