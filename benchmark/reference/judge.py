"""The comparison that decides ``correct``: a call's tables against the plain
reference.

Every number is a worst case over what it compares; each has a limit in the
traffic's file (``limits``), set from the readings listed in ``PERF.md``.

Gene calling (``run``), against what the generator planted:

* ``genes_bad``: called genes that are no open reading frame of the FASTA
  (length not a whole number of codons, a stop inside, or no stop at the end
  of a gene that does not run off its contig);
* ``genes_missed_pct``: the share of generated genes whose stop codon ends no
  called gene on the same strand.

The search (``run``), on a sample of the called genes drawn from the seed
(``SAMPLE_REPORTED`` with reported domains, ``SAMPLE_QUIET`` planted ones
with none, and ``SAMPLE_TAIL`` of the protein tail's long proteins where the
configuration has one): the reference searches each gene's protein
(translated here from the FASTA) against every profile that the table
reports on it and against every profile planted in it, and

* ``search_bits_gap``: the largest gap in bits between a reported domain and
  the reference's domain with the same first and last residue (bits from
  the p-value: ``tau - ln(p) / lambda``);
* ``search_coord_gap``: the largest shift of a reported domain's first or
  last residue from the reference domain it overlaps most (a float32 near-tie
  at an envelope's edge moves it, and its score with it, so such a domain's
  bits are not compared);
* ``search_unmatched``: reported domains that overlap no reference domain of
  their profile or whose pair the reference's filter gates drop, and
  reference domains under the p-filter, of a pair that clears every gate,
  that no reported domain overlaps (a domain within ``BORDER_BITS`` of the
  p-filter, or a pair within ``GATE_BITS`` of a gate, counts neither way).
  The gates are hmmsearch's, as the CLI runs them: the SSV filter, Viterbi
  and Forward, each with the composition-bias null, and the E-value.

The CRF and what follows (both traffics): from the genes and domains that the
call took as its input (``run``: its own tables, judged above; ``predict``:
the tables the benchmark wrote), the reference decodes every gene, extracts
the clusters and types them:

* ``crf_p_gap``: the largest gap between a gene's ``average_p`` or ``max_p``
  and the reference's probability;
* ``clusters_mismatch``: clusters (contig, first and last base, type) in one
  table and not in the other;
* ``type_p_gap``: the largest gap in a type probability of a common cluster.

``predict`` adds ``tables_mismatch``: rows of the genes and features tables
that differ from the tables it was given (its features are those under the
p-filter).
"""

import math
import os
from typing import Dict, List, Optional, Sequence

import numpy
import torch

from ..inputs import calibrate, synthetic
from . import crf as _crf
from . import hmm as _hmm

P_FILTER = 1e-9
THRESHOLD = 0.8
CDS = 3
#: a reference domain this close to the p-filter (in bits) may fall either
#: side of it in float32
BORDER_BITS = 0.5
#: genes of a call whose search the reference makes again: ones with
#: reported domains, planted ones with none (where a lost hit hides) and,
#: drawn after those, long proteins of the protein tail
SAMPLE_REPORTED, SAMPLE_QUIET, SAMPLE_TAIL = 24, 48, 8
#: hmmsearch's filter gates and reporting threshold, as the CLI runs them
F1, F2, F3, E = 0.02, 1e-3, 1e-5, 10.0
#: a pair this close to a gate (in bits) may fall either side of it in float32
GATE_BITS = 0.5


def read_table(path: str) -> List[Dict[str, str]]:
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        return [dict(zip(header, line.rstrip("\n").split("\t"))) for line in f if line.strip()]


class Outputs:
    """The three tables of one call."""

    def __init__(self, genes, features, clusters) -> None:
        self.genes, self.features, self.clusters = genes, features, clusters

    @classmethod
    def read(cls, directory: str, base: str) -> "Outputs":
        tables = [read_table(os.path.join(directory, f"{base}.{name}.tsv"))
                  for name in ("genes", "features", "clusters")]
        return cls(*tables)

    def key(self):
        return tuple(tuple(tuple(sorted(r.items())) for r in t)
                     for t in (self.genes, self.features, self.clusters))


def _float(text: str) -> float:
    return math.nan if text == "" else float(text)


class Reference:
    """What the reference knows of one run's inputs, and its cached answers."""

    def __init__(self, genome: synthetic.Genome, bank: Sequence[synthetic.Profile], *,
                 subcommand: str, seed: int, judged: Sequence[str],
                 features_path: Optional[str] = None) -> None:
        self.genome = genome
        self.contigs = dict(genome.contigs)
        self.bank = bank
        self.by_accession = {gm.accession: i for i, gm in enumerate(bank)}
        self.subcommand = subcommand
        self.seed = seed
        #: judgements beside the CRF's and the clusters': "genes", "search", "tables"
        self.judged = set(judged)
        #: the features table that ``predict`` was given
        self.features_path = features_path
        self.model = _crf.Model()
        self._configured: Dict[int, dict] = {}
        self._domains: Dict[tuple, List[_hmm.Domain]] = {}
        #: what each judgement found amiss, for the run's log
        self.notes: List[str] = []
        self.stops = {}
        for g in genome.genes:
            stop = g.end if g.strand > 0 else g.start
            self.stops[(g.contig, g.strand, stop)] = g

    # --- inputs of the CRF -------------------------------------------------

    def given_genes(self) -> List[_crf.Gene]:
        """``predict``'s input: the generator's genes and planted domains,
        with the p-values written into its features table."""
        rows = read_table(self.features_path)
        domains: Dict[str, list] = {}
        for r in rows:
            if float(r["pvalue"]) < P_FILTER:
                domains.setdefault(r["protein_id"], []).append(
                    (int(r["domain_start"]), r["domain"], float(r["pvalue"])))
        return [_crf.Gene(g.contig, g.protein_id, g.start, g.end,
                          tuple((d, p) for _, d, p in sorted(domains.get(g.protein_id, []))))
                for g in self.genome.genes]

    @staticmethod
    def table_genes(out: Outputs) -> List[_crf.Gene]:
        domains: Dict[str, list] = {}
        for r in out.features:
            domains.setdefault(r["protein_id"], []).append(
                (int(r["domain_start"]), r["domain"], float(r["pvalue"])))
        return [_crf.Gene(r["sequence_id"], r["protein_id"], int(r["start"]), int(r["end"]),
                          tuple((d, p) for _, d, p in sorted(domains.get(r["protein_id"], []))))
                for r in out.genes]

    # --- the search ----------------------------------------------------------

    def protein(self, row) -> "numpy.ndarray":
        strand = 1 if row["strand"] == "+" else -1
        return synthetic.encode_protein(synthetic.translate_gene(
            self.contigs[row["sequence_id"]], int(row["start"]), int(row["end"]), strand))

    def domains(self, row, profile: int, q: _hmm.Arithmetic) -> List[_hmm.Domain]:
        key = (row["protein_id"], profile, q.name)
        if key not in self._domains:
            if profile not in self._configured:
                self._configured[profile] = calibrate.configure(self.bank[profile])
            gm = self.bank[profile]
            self._domains[key] = _hmm.Pair(self._configured[profile], gm.stats["FORWARD"],
                                           self.protein(row), q).domains()
        return self._domains[key]

    def gates(self, row, profile: int, proteins: int) -> float:
        """The least margin (bits) by which the pair clears hmmsearch's gates
        as the configuration runs them: F1 (SSV, P <= 0.02), F2 (Viterbi,
        P <= 1e-3) and F3 (Forward, P <= 1e-5), each against null1 plus the
        composition-bias null (``--nobias`` off), and the sequence E-value
        (Forward, null1, E <= 10 over ``proteins``).  Negative: it fails."""
        key = (row["protein_id"], profile, "gates")
        if key not in self._domains:
            gm = self.bank[profile]
            x = self.protein(row)
            xs = torch.as_tensor(x[None, :])
            null = _hmm.null1(len(x))
            ssv, vit, fwd = ((calibrate.score_group([gm], xs, a)[0, 0] - null) / _hmm.LOG2
                             for a in ("ssv", "viterbi", "forward"))
            counts = numpy.bincount(x, minlength=21)[:20].astype(numpy.float64)
            logratio = numpy.log(gm.match[1:].mean(axis=0) / synthetic.BACKGROUND_F)
            extra = max(numpy.logaddexp(0.0, counts @ logratio) - _hmm.LOG2, 0.0) / _hmm.LOG2
            mu, lam = gm.stats["MSV"]
            vmu, vlam = gm.stats["VITERBI"]
            tau, flam = gm.stats["FORWARD"]
            gumbel = lambda p: -math.log(-math.log1p(-p))  # noqa: E731
            self._domains[key] = min(
                ssv - extra - (mu + gumbel(F1) / lam),
                vit - extra - (vmu + gumbel(F2) / vlam),
                fwd - extra - (tau - math.log(F3) / flam),
                fwd - (tau - math.log(E / proteins) / flam),
            )
        return self._domains[key]

    def sample(self, out: Outputs) -> List[dict]:
        """Called genes whose search is checked, drawn from the seed: some with
        reported domains, some planted ones with none and, where the genome
        has a protein tail, some of its long proteins; none running off its
        contig (its first codon then reads as called)."""
        reported = {r["protein_id"] for r in out.features}
        inner = [r for r in out.genes
                 if int(r["start"]) > 1 and int(r["end"]) < len(self.contigs[r["sequence_id"]])]
        rng = numpy.random.default_rng([self.seed, 2])
        picked = []
        for group, size in (
                ([r for r in inner if r["protein_id"] in reported], SAMPLE_REPORTED),
                ([r for r in inner if r["protein_id"] not in reported and self.planted(r)],
                 SAMPLE_QUIET)):
            picked += [group[i] for i in rng.choice(len(group), size=min(size, len(group)),
                                                    replace=False)]
        if any(g.tail for g in self.genome.genes):
            ids = {r["protein_id"] for r in picked}
            group = [r for r in inner if r["protein_id"] not in ids
                     and getattr(self.generated(r), "tail", False)]
            picked += [group[i] for i in rng.choice(len(group), size=min(SAMPLE_TAIL, len(group)),
                                                    replace=False)]
        return sorted(picked, key=lambda r: (r["sequence_id"], int(r["start"])))

    def generated(self, row) -> Optional[synthetic.GeneRecord]:
        """The generated gene that ends at this called gene's stop codon."""
        strand = 1 if row["strand"] == "+" else -1
        stop = int(row["end"]) if strand > 0 else int(row["start"])
        return self.stops.get((row["sequence_id"], strand, stop))

    def planted(self, row) -> List[int]:
        """The profiles planted in the generated gene that ends at this called
        gene's stop codon (none if no such gene)."""
        gene = self.generated(row)
        return [] if gene is None else sorted({profile for profile, _ in gene.plants})

    def searched(self, row, rows_of_gene) -> List[int]:
        """Profiles the reference searches on a sampled gene: those reported on
        it and those planted in it."""
        profiles = {self.by_accession[r["domain"]] for r in rows_of_gene}
        profiles.update(self.planted(row))
        return sorted(profiles)

    # --- the judgement -------------------------------------------------------

    def judge(self, out: Outputs) -> Dict[str, float]:
        numbers: Dict[str, float] = {}
        if "genes" in self.judged:
            numbers.update(self._judge_genes(out))
        if "search" in self.judged:
            numbers.update(self._judge_search(out))
        if "tables" in self.judged:
            numbers["tables_mismatch"] = self._judge_tables(out)
        genes = self.given_genes() if self.subcommand == "predict" else self.table_genes(out)
        probability = self.model.probabilities(genes, _hmm.Arithmetic())
        numbers.update(self._judge_crf(out, probability))
        clusters = self.model.clusters(genes, probability, threshold=THRESHOLD, cds=CDS)
        numbers.update(self._judge_clusters(out, clusters))
        return numbers

    def _judge_genes(self, out: Outputs) -> Dict[str, float]:
        bad, called = 0, set()
        for r in out.genes:
            contig = self.contigs[r["sequence_id"]]
            start, end = int(r["start"]), int(r["end"])
            strand = 1 if r["strand"] == "+" else -1
            called.add((r["sequence_id"], strand, end if strand > 0 else start))
            protein = synthetic.translate_gene(contig, start, end, strand)
            # a gene running off its contig ends on the last whole codon
            edge = start <= 3 or end >= len(contig) - 2
            if ((end - start + 1) % 3 or "*" in protein[:-1]
                    or (not protein.endswith("*") and not edge)):
                bad += 1
                self.notes.append(f"gene not an ORF: {r['protein_id']} {start}..{end} "
                                  f"{r['strand']} of {len(contig)} bp: {protein[:10]}...{protein[-10:]}")
        missed = sum(1 for key in self.stops if key not in called)
        return {"genes_bad": bad, "genes_missed_pct": 100.0 * missed / len(self.stops)}

    def _judge_search(self, out: Outputs) -> Dict[str, float]:
        rows: Dict[str, list] = {}
        for r in out.features:
            rows.setdefault(r["protein_id"], []).append(r)
        bits_gap, coord_gap, unmatched = 0.0, 0, 0
        q = _hmm.Arithmetic()
        sample = self.sample(out)
        pairs = 0
        for gene in sample:
            mine = rows.get(gene["protein_id"], [])
            for profile in self.searched(gene, mine):
                pairs += 1
                gm = self.bank[profile]
                tau, lam = gm.stats["FORWARD"]
                border = tau - math.log(P_FILTER) / lam
                reported = [r for r in mine if r["domain"] == gm.accession]
                margin = self.gates(gene, profile, len(out.genes))
                if margin < -GATE_BITS and reported:
                    unmatched += len(reported)
                    self.notes.append(f"reported, filtered out by {-margin:.3f} bits: "
                                      f"{gene['protein_id']} {gm.accession} {reported}")
                    continue
                if margin < GATE_BITS and not reported:
                    continue
                ref = self.domains(gene, profile, q)
                for r in reported:
                    a, b = int(r["domain_start"]), int(r["domain_end"])
                    overlap = [(min(b, d.target_to) - max(a, d.target_from), d) for d in ref]
                    overlap = [(o, d) for o, d in overlap if o >= 0]
                    if not overlap:
                        unmatched += 1
                        self.notes.append(f"reported, not in the reference: {gene['protein_id']} "
                                          f"{gm.accession} {a}..{b} p={r['pvalue']}; reference {ref}")
                        continue
                    d = max(overlap, key=lambda od: od[0])[1]
                    if (a, b) != (d.target_from, d.target_to):
                        coord_gap = max(coord_gap, abs(a - d.target_from), abs(b - d.target_to))
                        self.notes.append(f"coordinates: {gene['protein_id']} {gm.accession} "
                                          f"{a}..{b} p={r['pvalue']}; reference {d}")
                        continue
                    p = float(r["pvalue"])
                    bits = tau - math.log(p) / lam if p > 0 else math.inf
                    bits_gap = max(bits_gap, abs(bits - d.bits))
                for d in ref:
                    if (d.pvalue >= P_FILTER or abs(d.bits - border) < BORDER_BITS
                            or margin < GATE_BITS):
                        continue
                    if not any(int(r["domain_start"]) <= d.target_to
                               and d.target_from <= int(r["domain_end"]) for r in reported):
                        unmatched += 1
                        self.notes.append(f"in the reference, not reported: {gene['protein_id']} "
                                          f"{gm.accession} {d}; reported {reported}")
        tail = sum(1 for g in sample if getattr(self.generated(g), "tail", False))
        self.notes.append(f"search: {len(sample)} genes sampled"
                          + (f" ({tail} of the protein tail)" if tail else "") + ", "
                          f"{sum(1 for g in sample if g['protein_id'] in rows)} with domains, "
                          f"{pairs} pairs searched again; {len(out.features)} domains in all")
        return {"search_bits_gap": float(bits_gap), "search_coord_gap": coord_gap,
                "search_unmatched": unmatched}

    def _judge_tables(self, out: Outputs) -> int:
        strand = {1: "+", -1: "-"}
        want = {(g.contig, g.protein_id, str(g.start), str(g.end), strand[g.strand])
                for g in self.genome.genes}
        got = {(r["sequence_id"], r["protein_id"], r["start"], r["end"], r["strand"])
               for r in out.genes}
        given = {(r["protein_id"], r["domain"], r["domain_start"], r["domain_end"],
                  float(r["pvalue"])) for r in read_table(self.features_path)
                 if float(r["pvalue"]) < P_FILTER}
        kept = {(r["protein_id"], r["domain"], r["domain_start"], r["domain_end"],
                 float(r["pvalue"])) for r in out.features}
        return len(want ^ got) + len(given ^ kept)

    @staticmethod
    def _judge_crf(out: Outputs, probability: Dict[str, float]) -> Dict[str, float]:
        gap = 0.0
        for r in out.genes:
            want = probability.get(r["protein_id"])
            for column in ("average_p", "max_p"):
                got = _float(r.get(column, ""))
                gap = max(gap, math.inf if want is None or math.isnan(got) else abs(got - want))
        if len(out.genes) != len(probability):
            gap = math.inf
        return {"crf_p_gap": gap}

    def _judge_clusters(self, out: Outputs, clusters: List[_crf.Cluster]) -> Dict[str, float]:
        want = {(c.contig, c.start, c.end, c.type): c for c in clusters}
        got = {(r["sequence_id"], int(r["start"]), int(r["end"]), r["type"]): r
               for r in out.clusters}
        gap = 0.0
        for key in set(want) & set(got):
            for name, p in want[key].probabilities.items():
                gap = max(gap, abs(_float(got[key].get(f"{name.lower()}_probability", "")) - p))
        return {"clusters_mismatch": len(set(want) ^ set(got)), "type_p_gap": gap}

    # --- the control ---------------------------------------------------------

    def control(self, out: Outputs) -> Outputs:
        """The call's tables with every judged answer replaced by the
        reference's own, computed in bfloat16."""
        q = _hmm.Arithmetic("bfloat16")
        features = [dict(r) for r in out.features]
        if "search" in self.judged:
            rows: Dict[str, list] = {}
            for r in out.features:
                rows.setdefault(r["protein_id"], []).append(r)
            sampled = self.sample(out)
            ids = {g["protein_id"] for g in sampled}
            features = [r for r in features if r["protein_id"] not in ids]
            for gene in sampled:
                for profile in self.searched(gene, rows.get(gene["protein_id"], [])):
                    for d in self.domains(gene, profile, q):
                        if d.pvalue < P_FILTER:
                            features.append(dict(
                                sequence_id=gene["sequence_id"], protein_id=gene["protein_id"],
                                start=gene["start"], end=gene["end"], strand=gene["strand"],
                                domain=self.bank[profile].accession, pvalue=repr(d.pvalue),
                                domain_start=str(d.target_from), domain_end=str(d.target_to)))
        lowered = Outputs(out.genes, features, out.clusters)
        genes = (self.given_genes() if self.subcommand == "predict"
                 else self.table_genes(lowered))
        probability = self.model.probabilities(genes, q)
        gene_rows = [dict(r, average_p=repr(probability[r["protein_id"]]),
                          max_p=repr(probability[r["protein_id"]])) for r in out.genes]
        cluster_rows = []
        for c in self.model.clusters(genes, probability, threshold=THRESHOLD, cds=CDS):
            row = dict(sequence_id=c.contig, cluster_id=c.cluster_id, start=str(c.start),
                       end=str(c.end), type=c.type)
            row.update({f"{k.lower()}_probability": repr(float(q(v)))
                        for k, v in c.probabilities.items()})
            cluster_rows.append(row)
        return Outputs(gene_rows, features, cluster_rows)
