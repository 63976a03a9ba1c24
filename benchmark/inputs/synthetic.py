"""Seeded inputs of the benchmark: the profile bank, the genome, and the
tables of the ``predict`` traffic.

Frozen copies of the port's generators (``gecco_tpu_torch/hmm/synthetic.py``:
``pfam_shaped_lengths``, ``pfam_shaped_profiles``, ``plant_domain``, the codon
model of ``synthetic_genome``), kept here so that a change to the program
cannot change what the benchmark feeds it.  Three departures:

* proteins are planted while the genes are generated (residues first, then
  codons), not called and written back, and no protein is cut at 512
  residues;
* gene, spacer and contig sizes are one fixed set drawn from the
  configuration's ``size_seed``; the run's seed permutes them and draws the
  residues, strands and planted domains, so every seed gives the same gene
  count, the same contig sizes in genes and the same number of base pairs;
* every gene has a ribosome binding site before its start codon (``rbs``:
  a motif, then a gap of random bases), as most bacterial genes do.

The keys of a configuration file (``benchmark/configs/<name>.json``), each
with its default and the fact of the deployment that it states:

* ``genes`` (required): protein-coding genes in the genome or assembly;
* ``protein_aa`` (required): ``{"median", "sigma", "min"}``, the lognormal
  of protein lengths in residues, the initiator counted, the stop not;
* ``spacer_bp`` (required): the mean length of the sequence between two
  genes, less the binding site (gamma of shape 2, at least 20 bp);
* ``rbs`` (required): ``{"motif", "gap"}``, the ribosome binding site;
* ``cluster_runs`` (required): the sizes in genes of the planted
  biosynthetic gene clusters, each of one type of ``cluster_domains.json``;
* ``size_seed`` (required): the seed of the sizes that every run shares;
* ``profiles``, ``bank_seed`` (required): the bank of
  :func:`pfam_shaped_profiles`;
* ``bank_subset`` (default: the whole bank): keep only the first this many
  profiles and the clusters' accessions (``benchmark/run.py``);
* ``contig_genes`` (default: one contig named ``genome``): ``{"median",
  "sigma", "min"}``, an assembly of many contigs, named ``contig00001`` on;
  genes per contig are drawn lognormally (at least ``min``) until ``genes``
  are used up, the last contig taking what is left;
* ``protein_tail`` (default: none): ``{"share", "aa": [lo, hi],
  "module_aa"}``, a tail of long modular proteins (NRPS and PKS): ``round(share
  x genes)`` protein lengths drawn log-uniform in ``[lo, hi]``, placed inside
  the cluster runs as far as they have room (elsewhere after that), each
  carrying a planted domain every ``module_aa`` residues;
* ``gc3`` (default: synonymous codons equally likely): the G+C share at
  third codon positions that the codon choice aims at, over the Easel
  background's amino acids;
* ``spacer_gc`` (default: 0.5, bases equally likely): the G+C share of the
  spacers and of the binding site's gap.

Without the last four keys, every seed gives the same bytes and the same
random draws as before they existed.

Probabilities are rounded to float32 here, as the ``.h3m`` stores them, so
the program (which reads the file) and the reference (which takes the
arrays) start from the same numbers.
"""

import dataclasses
import json
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy

HERE = os.path.dirname(os.path.abspath(__file__))

#: HMMER's amino acid order and Easel's background (``p7_AminoFrequencies``)
AMINO_ALPHABET = "ACDEFGHIKLMNPQRSTVWY"
BACKGROUND_F = numpy.array([
    0.0787945, 0.0151600, 0.0535222, 0.0668298, 0.0397062,
    0.0695071, 0.0229198, 0.0590092, 0.0594422, 0.0963728,
    0.0237718, 0.0414386, 0.0482904, 0.0395639, 0.0540978,
    0.0683364, 0.0540687, 0.0673417, 0.0114135, 0.0304133,
], dtype=numpy.float64)

_BASES = "TCAG"
#: NCBI translation table 11 in TCAG order
_TABLE11 = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
_COMPLEMENT = bytes.maketrans(b"ACGT", b"TGCA")


@dataclasses.dataclass
class Profile:
    """A core profile HMM in probability space (rows as in HMMER's files)."""

    name: str
    accession: str
    M: int
    match: "numpy.ndarray"    # [M+1, 20], row 0 unused
    insert: "numpy.ndarray"   # [M+1, 20]
    trans: "numpy.ndarray"    # [M+1, 7]: MM MI MD IM II DM DD
    stats: Dict[str, Tuple[float, float]]


@dataclasses.dataclass
class GeneRecord:
    """One generated gene: where it lies and what was planted in it."""

    contig: str
    start: int                # 1-based, inclusive, the start codon's first base
    end: int                  # 1-based, inclusive, the stop codon's last base
    strand: int               # +1 or -1
    protein_id: str
    profile: Optional[int]    # planted profile index, None if nothing planted
    domain: Tuple[int, int]   # planted residues, 1-based inclusive protein coordinates
    cluster: Optional[str]    # type of the planted cluster run the gene is in
    #: the plants after the first (``profile``, ``domain``): a gene of the
    #: protein tail carries one a module
    extra: Tuple[Tuple[int, Tuple[int, int]], ...] = ()
    tail: bool = False        # one of the ``protein_tail``'s long proteins

    @property
    def plants(self) -> List[Tuple[int, Tuple[int, int]]]:
        """Every ``(profile, domain)`` planted in the gene."""
        return [] if self.profile is None else [(self.profile, self.domain), *self.extra]

    @property
    def aa(self) -> int:
        """Protein length: the initiator counted, the stop not."""
        return (self.end - self.start + 1) // 3 - 1


@dataclasses.dataclass
class Genome:
    contigs: List[Tuple[str, str]]
    genes: List[GeneRecord]

    @property
    def bp(self) -> int:
        return sum(len(seq) for _, seq in self.contigs)

    @property
    def gc(self) -> float:
        """The G+C share of every contig together."""
        return sum(seq.count("G") + seq.count("C") for _, seq in self.contigs) / self.bp


def accessions() -> List[str]:
    """The classifier's Pfam accessions, in order (profile ``i`` takes the
    ``i``-th, so the annotator's whitelist keeps every profile)."""
    with open(os.path.join(HERE, "accessions.txt")) as f:
        return [line.strip() for line in f if line.strip()]


def pfam_shaped_lengths(count: int, seed: int = 0) -> "numpy.ndarray":
    """Node counts of a Pfam-A-like histogram (lognormal, median ~140)."""
    rng = numpy.random.default_rng(seed)
    lengths = rng.lognormal(mean=numpy.log(140.0), sigma=0.72, size=count)
    return numpy.clip(lengths, 25, 2200).astype(int)


def _f32(a: "numpy.ndarray") -> "numpy.ndarray":
    return numpy.asarray(a, dtype=numpy.float32).astype(numpy.float64)


def pfam_shaped_profiles(count: int, seed: int = 0) -> List[Profile]:
    """The bank: the draws of the port's ``pfam_shaped_profiles``, named by
    the classifier's accessions, calibrated from ``calibration.npz`` when
    that file holds this bank."""
    lengths = pfam_shaped_lengths(count, seed=seed)
    rng = numpy.random.default_rng(seed + 1)
    names = accessions()
    if len(names) < count:
        raise ValueError(f"{count} profiles, {len(names)} accessions")
    profiles = []
    for p, M in enumerate(lengths):
        M = int(M)
        match = rng.dirichlet(numpy.full(20, 0.3), size=M + 1)
        insert = numpy.tile(BACKGROUND_F, (M + 1, 1))
        trans = numpy.zeros((M + 1, 7))
        trans[:, 0:3] = rng.dirichlet(numpy.array([50.0, 1.0, 1.0]), size=M + 1)
        trans[:, 3:7] = [0.5, 0.5, 0.6, 0.4]
        trans[M] = [1.0, 0.0, 0.0, 0.5, 0.5, 1.0, 0.0]
        profiles.append(Profile(
            name=f"SYN{p:05d}", accession=names[p], M=M,
            match=_f32(match), insert=_f32(insert), trans=_f32(trans), stats={},
        ))
    _calibrate_from_file(profiles, count, seed)
    return profiles


def _calibrate_from_file(profiles: List[Profile], count: int, seed: int) -> None:
    path = os.path.join(HERE, "calibration.npz")
    if not os.path.exists(path):
        return
    data = numpy.load(path)
    if int(data["count"]) != count or int(data["seed"]) != seed:
        return
    lengths = numpy.array([gm.M for gm in profiles])
    if not numpy.array_equal(data["lengths"], lengths):
        raise ValueError("calibration.npz was computed for another bank")
    stats = _f32(data["stats"])      # [P, 3, 2]: MSV, VITERBI, FORWARD x (location, lambda)
    for gm, row in zip(profiles, stats):
        gm.stats = {"MSV": tuple(row[0]), "VITERBI": tuple(row[1]), "FORWARD": tuple(row[2])}


def plant_domain(x, match, rng, offset=10, max_len=100, divergence=0.35):
    """Overwrite part of ``x`` with a diverged emission of a profile's match
    states (the port's ``plant_domain``: ~35% background substitutions, ~8%
    deletions); returns ``(x, n)`` with ``n`` residues planted at ``offset``."""
    match = match[1:, :20]
    cdf = numpy.cumsum(match / match.sum(axis=1, keepdims=True), axis=1)
    u = rng.random((len(cdf), 1))
    emitted = numpy.minimum((u > cdf).sum(axis=1).astype(numpy.int32), 19)
    p_bg = BACKGROUND_F / BACKGROUND_F.sum()
    mutate = rng.random(len(emitted)) < divergence
    emitted[mutate] = rng.choice(20, size=int(mutate.sum()), p=p_bg)
    keep = rng.random(len(emitted)) > 0.08
    emitted = emitted[keep][:max_len]
    n = min(len(emitted), len(x) - offset)
    if n <= 0:
        return x, 0
    out = x.copy()
    out[offset : offset + n] = emitted[:n]
    return out, n


def _codon_choices():
    """``(codons [20, 6, 3] uint8, counts [20])``: the sense codons of each
    amino acid under table 11."""
    codons = numpy.zeros((20, 6, 3), dtype=numpy.uint8)
    counts = numpy.zeros(20, dtype=numpy.int64)
    for i, aa in enumerate(_TABLE11):
        if aa == "*":
            continue
        codon = _BASES[i // 16] + _BASES[(i // 4) % 4] + _BASES[i % 4]
        a = AMINO_ALPHABET.index(aa)
        codons[a, counts[a]] = numpy.frombuffer(codon.encode(), dtype=numpy.uint8)
        counts[a] += 1
    return codons, counts


def codon_weights(gc3: float) -> "numpy.ndarray":
    """``[20, 6]`` weights of the synonymous codons (``_codon_choices``' order,
    0 past an amino acid's count): ``omega`` to the number of G+C at the
    codon's third position, ``omega`` solved so that codons drawn for the
    Easel background's amino acids end in G or C with share ``gc3``."""
    codons, counts = _codon_choices()
    valid = numpy.arange(codons.shape[1])[None, :] < counts[:, None]
    third = numpy.isin(codons[:, :, 2], numpy.frombuffer(b"GC", dtype=numpy.uint8)) & valid
    strong = third.sum(axis=1)
    weak = counts - strong
    p_bg = BACKGROUND_F / BACKGROUND_F.sum()

    def share(log_omega: float) -> float:
        omega = numpy.exp(log_omega)
        return float(p_bg @ (omega * strong / (omega * strong + weak)))

    lo, hi = -40.0, 40.0
    if not share(lo) < gc3 < share(hi):
        raise ValueError(f"gc3 {gc3} is out of reach: {share(lo):.4f} to {share(hi):.4f}")
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if share(mid) < gc3 else (lo, mid)
    omega = numpy.exp(0.5 * (lo + hi))
    return numpy.where(valid, numpy.where(third, omega, 1.0), 0.0)


def _random_bases(rng, size: int, gc: Optional[float]) -> bytes:
    """``size`` bases, each G or C with probability ``gc`` (None: 0.5, by the
    draw the generator has always made)."""
    acgt = numpy.frombuffer(b"ACGT", dtype=numpy.uint8)
    if gc is None:
        return bytes(acgt[rng.integers(0, 4, size=size)])
    return bytes(acgt[rng.choice(4, size=size, p=[(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])])


def _sizes(config) -> Tuple["numpy.ndarray", "numpy.ndarray", "numpy.ndarray", List[int]]:
    """The fixed set of gene body lengths (codons after the initiator and
    before the stop) of the ordinary genes and of the protein tail, spacer
    lengths and contig gene counts that every seed of this configuration
    shares.  Each optional key draws only when it is there, after the draws
    that it follows."""
    rng = numpy.random.default_rng(config["size_seed"])
    n = config["genes"]
    shape = config["protein_aa"]
    tail = config.get("protein_tail")
    k = int(round(tail["share"] * n)) if tail else 0
    aa = rng.lognormal(numpy.log(shape["median"]), shape["sigma"], size=n - k)
    codons = numpy.maximum(numpy.round(aa), shape["min"]).astype(int) - 1
    tail_codons = numpy.zeros(0, dtype=int)
    if tail:
        lo, hi = tail["aa"]
        if not (0 <= k <= n and 0 < lo <= hi and tail["module_aa"] > 160):
            raise ValueError(f"protein_tail {tail}: share in [0, 1], 0 < lo <= hi, "
                             "module_aa > 160 (the room of one planted domain)")
        tail_codons = numpy.round(numpy.exp(rng.uniform(numpy.log(lo), numpy.log(hi), size=k)))
        tail_codons = tail_codons.astype(int) - 1
    counts = [n]
    if "contig_genes" in config:
        layout = config["contig_genes"]
        counts, left = [], n
        while left > 0:
            c = max(int(round(rng.lognormal(numpy.log(layout["median"]), layout["sigma"]))),
                    layout["min"], 1)
            counts.append(min(c, left))
            left -= counts[-1]
    spacers = numpy.maximum(20, rng.gamma(2.0, config["spacer_bp"] / 2.0,
                                          size=n + len(counts)).astype(int))
    return codons, tail_codons, spacers, counts


def make_genome(config, bank: Sequence[Profile], seed: int) -> Genome:
    """The genome or assembly of ``config`` for ``seed``: one contig named
    ``genome``, or with ``contig_genes`` contigs ``contig00001``, ... .

    Gene ``i`` (in genome order) carries a diverged domain of profile
    ``(13 i) mod P`` when ``i mod 4 != 3``; the genes of each planted cluster
    run carry, one each and in turn, the domains of its type's accessions.
    A gene of the protein tail carries a domain every ``module_aa`` residues:
    inside a run, its own and then the run's next accessions in turn;
    outside, ``(13 i) mod P`` each time.  Each contig starts and ends with a
    spacer and holds whole genes.
    """
    codons_of, tail_of, spacers, counts = _sizes(config)
    rng = numpy.random.default_rng(seed)
    n = config["genes"]
    lengths = codons_of[rng.permutation(len(codons_of))]
    spacers = spacers[rng.permutation(len(spacers))]
    counts = [counts[i] for i in rng.permutation(len(counts))]
    index = {gm.accession: i for i, gm in enumerate(bank)}
    with open(os.path.join(HERE, "cluster_domains.json")) as f:
        cluster_domains = json.load(f)

    # cluster runs: each inside one contig, not overlapping another run
    first = numpy.concatenate(([0], numpy.cumsum(counts)))
    planted: Dict[int, Tuple[int, str]] = {}
    cycles: Dict[int, Tuple[List[int], int]] = {}
    for size in config["cluster_runs"]:
        kind = sorted(cluster_domains)[int(rng.integers(len(cluster_domains)))]
        roomy = [c for c, count in enumerate(counts) if count >= size]
        for _ in range(1000 if roomy else 0):
            c = roomy[int(rng.integers(len(roomy)))]
            at = first[c] + int(rng.integers(counts[c] - size + 1))
            if all(g not in planted for g in range(at, at + size)):
                break
        else:
            raise ValueError(f"no room for a cluster run of {size} genes")
        domains = [index[acc] for acc in cluster_domains[kind]]
        for j in range(size):
            planted[at + j] = (domains[j % len(domains)], kind)
            cycles[at + j] = (domains, j)

    # the protein tail: inside the runs first, then anywhere else
    tail = numpy.zeros(n, dtype=bool)
    if len(tail_of):
        runs = sorted(planted)
        inside = rng.choice(runs, size=min(len(tail_of), len(runs)), replace=False)
        rest = [g for g in range(n) if g not in planted]
        outside = rng.choice(rest, size=len(tail_of) - len(inside), replace=False)
        tail[numpy.concatenate((inside, outside)).astype(int)] = True
        full = numpy.empty(n, dtype=int)
        full[tail] = tail_of[rng.permutation(len(tail_of))]
        full[~tail] = lengths
        lengths = full
    module = config["protein_tail"]["module_aa"] if len(tail_of) else 0

    codon_table, codon_counts = _codon_choices()
    weights = codon_weights(config["gc3"]) if "gc3" in config else None
    if weights is not None:
        cumulative = numpy.cumsum(weights, axis=1) / weights.sum(axis=1, keepdims=True)
        # the last codon of each amino acid takes every draw above the others
        cumulative[numpy.arange(weights.shape[1])[None, :] >= codon_counts[:, None] - 1] = numpy.inf
    spacer_gc = config.get("spacer_gc")
    motif = config["rbs"]["motif"].encode()
    gap = int(config["rbs"]["gap"])
    p_bg = BACKGROUND_F / BACKGROUND_F.sum()
    residues = rng.choice(20, size=int(lengths.sum()), p=p_bg).astype(numpy.int32)
    offsets = numpy.concatenate(([0], numpy.cumsum(lengths)))
    strands = numpy.where(rng.random(n) < 0.5, 1, -1)
    pick = rng.random(len(residues))
    genes: List[GeneRecord] = []
    contigs: List[Tuple[str, str]] = []
    g, s = 0, 0
    for c, count in enumerate(counts):
        contig = "genome" if "contig_genes" not in config else f"contig{c + 1:05d}"
        parts: List[bytes] = []
        pos = 0

        def spacer():
            nonlocal s, pos
            part = _random_bases(rng, int(spacers[s]), spacer_gc)
            s += 1
            pos += len(part)
            parts.append(part)

        spacer()
        for k in range(count):
            body = residues[offsets[g] : offsets[g + 1]]
            if g in planted:
                profile, kind = planted[g]
            elif g % 4 != 3:
                profile, kind = (13 * g) % len(bank), None
            else:
                profile, kind = None, None
            # (profile, body index of the domain's first residue)
            wanted = [] if profile is None else [(profile, 10)]
            if tail[g]:
                cycle, j = cycles.get(g, ([(13 * g) % len(bank)], 0))
                wanted = [(cycle[(j + m) % len(cycle)], 10 + m * module)
                          for m in range((len(body) + 1) // module)]
            plants = []
            for profile, offset in wanted:
                gm = bank[profile]
                body, planted_n = plant_domain(body, gm.match, rng, offset=offset,
                                               max_len=min(150, gm.M))
                # protein = initiator M + body; body index i is residue i + 2
                if planted_n:
                    plants.append((profile, (offset + 2, offset + 1 + planted_n)))
            (profile, domain), extra = (plants[0], plants[1:]) if plants else ((None, (0, 0)), [])
            u = pick[offsets[g] : offsets[g + 1]]
            if weights is None:
                choice = (u * codon_counts[body]).astype(numpy.int64)
            else:
                choice = (u[:, None] >= cumulative[body]).sum(axis=1)
            dna = b"ATG" + codon_table[body, choice].tobytes() + b"TAA"
            # the ribosome binding site: the motif, then a gap of random bases
            rbs = motif + _random_bases(rng, gap, spacer_gc)
            if strands[g] < 0:
                unit = (rbs + dna).translate(_COMPLEMENT)[::-1]
                begin = pos
            else:
                unit = rbs + dna
                begin = pos + len(rbs)
            genes.append(GeneRecord(
                contig=contig, start=begin + 1, end=begin + len(dna), strand=int(strands[g]),
                protein_id=f"{contig}_{k + 1}", profile=profile, domain=domain, cluster=kind,
                extra=tuple(extra), tail=bool(tail[g]),
            ))
            parts.append(unit)
            pos += len(unit)
            spacer()
            g += 1
        contigs.append((contig, b"".join(parts).decode()))
    return Genome(contigs=contigs, genes=genes)


def translate_gene(seq: str, start: int, end: int, strand: int) -> str:
    """The protein of a gene as the port's gene caller renders a complete gene:
    table 11, the trailing ``*`` kept, the initiator codon as ``M``."""
    dna = seq[start - 1 : end].encode()
    if strand < 0:
        dna = dna.translate(_COMPLEMENT)[::-1]
    ranks = {b: i for i, b in enumerate(_BASES.encode())}
    protein = []
    for i in range(0, len(dna) - len(dna) % 3, 3):
        codon = dna[i : i + 3]
        if any(b not in ranks for b in codon):
            protein.append("X")
        else:
            protein.append(_TABLE11[16 * ranks[codon[0]] + 4 * ranks[codon[1]] + ranks[codon[2]]])
    if protein and dna[:3] in (b"ATG", b"GTG", b"TTG"):
        protein[0] = "M"
    return "".join(protein)


def encode_protein(protein: str) -> "numpy.ndarray":
    """Alphabet indices; anything else (``*``, ``X``) is the degenerate code 20."""
    table = numpy.full(128, 20, dtype=numpy.int32)
    for i, ch in enumerate(AMINO_ALPHABET):
        table[ord(ch)] = i
    raw = numpy.frombuffer(protein.encode("ascii", "replace"), dtype=numpy.uint8)
    return table[numpy.minimum(raw, 127)]


def write_fasta(path: str, genome: Genome) -> None:
    with open(path, "w") as f:
        for name, seq in genome.contigs:
            f.write(f">{name}\n")
            for i in range(0, len(seq), 80):
                f.write(seq[i : i + 80] + "\n")


def write_predict_tables(genes_path: str, features_path: str, genome: Genome, bank,
                         seed: int, hmm: str = "Pfam") -> None:
    """The tables ``gecco predict`` resumes from: every generated gene, and a
    row for each planted domain (several on a gene of the protein tail) with
    a p-value drawn under the p-filter."""
    rng = numpy.random.default_rng([seed, 1])
    strand = {1: "+", -1: "-"}
    with open(genes_path, "w") as f:
        f.write("sequence_id\tprotein_id\tstart\tend\tstrand\n")
        for g in genome.genes:
            f.write(f"{g.contig}\t{g.protein_id}\t{g.start}\t{g.end}\t{strand[g.strand]}\n")
    with open(features_path, "w") as f:
        f.write("sequence_id\tprotein_id\tstart\tend\tstrand\tdomain\thmm\ti_evalue\tpvalue"
                "\tdomain_start\tdomain_end\n")
        for g in genome.genes:
            for profile, domain in g.plants:
                pvalue = float(10.0 ** -rng.uniform(10.0, 40.0))
                f.write(f"{g.contig}\t{g.protein_id}\t{g.start}\t{g.end}\t{strand[g.strand]}"
                        f"\t{bank[profile].accession}\t{hmm}\t{pvalue * len(bank)!r}\t{pvalue!r}"
                        f"\t{domain[0]}\t{domain[1]}\n")


# --- binary HMMER3/f ``.h3m`` writer (a copy of the port's ``write_h3m``) ---

_V3F_MAGIC = 0xE8EDEDB5 + 5
_F_STATS, _F_ACC = 1 << 7, 1 << 9
_UNSET = -99999.0


def _string(value: Optional[str]) -> bytes:
    if value is None:
        return struct.pack("<i", 0)
    raw = value.encode("ascii", "replace") + b"\0"
    return struct.pack("<i", len(raw)) + raw


def write_h3m(path: str, profiles: Sequence[Profile]) -> None:
    with open(path, "wb") as f:
        for gm in profiles:
            flags = _F_ACC | (_F_STATS if len(gm.stats) == 3 else 0)
            out = [struct.pack("<Iiii", _V3F_MAGIC, flags, gm.M, 3), _string(gm.name),
                   _string(gm.accession), _string(None), struct.pack("<if", 0, 0.0),
                   struct.pack("<i", 0), _string(None), struct.pack("<I", 0)]
            ev = numpy.full(6, _UNSET, dtype="<f4")
            if flags & _F_STATS:
                ev[:] = [*gm.stats["MSV"], *gm.stats["VITERBI"], *gm.stats["FORWARD"]]
            out.append(ev.tobytes())
            out.append(numpy.full(6, _UNSET, dtype="<f4").tobytes())
            out.append(numpy.asarray(gm.trans, dtype="<f4").tobytes())
            out.append(numpy.asarray(gm.match[1:], dtype="<f4").tobytes())
            out.append(numpy.asarray(gm.insert, dtype="<f4").tobytes())
            f.write(b"".join(out))
