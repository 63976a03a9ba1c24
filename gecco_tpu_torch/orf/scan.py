"""De-novo prokaryotic gene finding (the Prodigal-equivalent stage).

The reference wraps Prodigal in metagenome mode through pyrodigal
(``gecco/orf.py:44-146``).  This is an independent,
self-training gene finder of the same family (the Prodigal paper's
iterative scheme, re-implemented from scratch):

1. enumerate candidate genes in all six frames (start codons
   ATG/GTG/TTG, stops per translation table 11, minimum length 90 nt),
   including genes running off the contig edges (Prodigal's partial
   genes); regions of >=50 consecutive ``N`` are masked out when
   ``mask=True`` (pyrodigal ``GeneFinder(mask=...)``, ``orf.py:75``);
2. learn an in-frame hexamer (dicodon) log-odds model from a
   high-confidence seed set (long ORFs) against the contig background,
   select a provisional gene set, then **retrain** on that selection:
   second-pass hexamer statistics plus a learned start model (start
   codon usage and RBS motif-bin usage of selected genes vs the
   candidate background);
3. select the highest-scoring compatible gene set with a dynamic
   program over candidates sorted by end coordinate (bounded overlap).

``metagenome=True`` (the pipeline default) fits the model per contig;
``metagenome=False`` reproduces the reference's *single* mode: one model
fitted on all contigs joined with ``TTAATTAATTAA`` linkers
(``orf.py:77-85``) and then applied to each contig.  ``cpus`` drives a
thread pool over contigs exactly like the reference's
``ThreadPool(cpus).imap`` (``orf.py:95,128-130``); the hot loops run in
the native core (``native/orfscan.cpp``), whose ctypes calls release
the GIL for the duration of the native execution — which is why
``cpus > 1`` gives real per-contig parallelism.

Output coordinates are 1-based inclusive like the reference, proteins
are numbered ``{contig}_{i}`` left-to-right, and the gene qualifiers
mirror the reference's (``inference``/``transl_table``,
``orf.py:142-145``).
"""

import bisect
from multiprocessing.pool import ThreadPool
import os
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy

from ..model import Gene, Protein, Strand
from ..seq import Seq, SeqRecord, reverse_complement, translate
from . import ORFFinder

__all__ = ["ScanFinder"]

_STARTS = ("ATG", "GTG", "TTG")
_STOPS = ("TAA", "TAG", "TGA")
_START_BONUS = {"ATG": 0.0, "GTG": -0.5, "TTG": -1.5}
_RBS_MOTIFS = ("AGGAGG", "GGAGG", "AGGAG", "GGAG", "AGGA", "GAGG")
_RBS_BONUS = {6: 3.0, 5: 2.5, 4: 1.5}
MIN_GENE = 90
MAX_OVERLAP = 30
MIN_SCORE = 22.0        # selection floor: calibrated on the Prodigal golden
                        # (BGC0001737: all 10 genes exact, no extras; see
                        # tests/test_orf.py::test_scan_finder_prodigal_parity)
POS_MIN_SCORE = 5.0     # selection floor for the positional-model fallback
                        # (measured on held-out BGC0001866: floor 5 gives
                        # 21/23 golden stops with 2 spurious calls; floor 3
                        # already admits 7 spurious — docs/parity.md)
GC_GATE = 8.0           # a preset only qualifies for a contig within this
                        # many GC percentage points: a hexamer model carries
                        # its training genome's codon usage, and applying a
                        # GC-72 model to a GC-50 contig inverts the ranking
                        # of real genes vs shadow ORFs (measured: 12/23
                        # stops, 20 spurious on held-out BGC0001866)
FIT_MARGIN = 1.25       # a GC-compatible preset is still rejected when the
                        # de-novo fallback's selected genes carry >25% more
                        # total positional-model score — the misfit guard
                        # for GC-matched but composition-alien input
                        # (measured: good fits land at ratio 1.00-1.04,
                        # a misfit at 2.39 — docs/parity.md)
MASK_RUN = 50           # pyrodigal masks runs of >=50 N
_LINKER = "TTAATTAATTAA"  # single-mode contig linker (orf.py:80-84)
W_START = 2.0           # weight of the learned start-codon log-odds
W_RBS = 2.0             # weight of the learned RBS-bin log-odds
W_UPSTREAM = 1.5        # weight of the positional upstream model (uscore)
W_UP_WINDOW = 45        # upstream window, like Prodigal's -1..-45 region

_BASE = {"A": 0, "C": 1, "G": 2, "T": 3}


def _encode(seq: str) -> "numpy.ndarray":
    table = numpy.full(128, -1, dtype=numpy.int8)
    for base, code in _BASE.items():
        table[ord(base)] = code
        table[ord(base.lower())] = code
    raw = numpy.frombuffer(seq.encode("ascii", "replace"), dtype=numpy.uint8)
    return table[numpy.minimum(raw, 127)].astype(numpy.int32)


def _mask_spans(codes: "numpy.ndarray", min_run: int = MASK_RUN) -> List[Tuple[int, int]]:
    """Spans (0-based, half-open) of >=min_run consecutive non-ACGT codes."""
    invalid = codes < 0
    if not invalid.any():
        return []
    spans: List[Tuple[int, int]] = []
    padded = numpy.concatenate([[False], invalid, [False]])
    rises = numpy.flatnonzero(~padded[:-1] & padded[1:])
    falls = numpy.flatnonzero(padded[:-1] & ~padded[1:])
    for b, e in zip(rises, falls):
        if e - b >= min_run:
            spans.append((int(b), int(e)))
    return spans


class _Candidate:
    __slots__ = (
        "start", "end", "strand", "score",
        "partial_begin", "partial_end", "codon", "rbs", "upstream",
    )

    def __init__(self, start, end, strand, score=0.0,
                 partial_begin=False, partial_end=False):
        self.start = start          # 0-based inclusive leftmost nt
        self.end = end              # 0-based exclusive rightmost nt
        self.strand = strand
        self.score = score
        self.partial_begin = partial_begin
        self.partial_end = partial_end
        self.codon: Optional[str] = None
        self.rbs: int = -1
        self.upstream: Optional[str] = None  # W_UP_WINDOW nt before start


MAX_STARTS = 16


def _find_orfs(codes: "numpy.ndarray", strand: int, length: int) -> List[_Candidate]:
    """Enumerate candidate genes on one strand of an encoded sequence.

    ``codes`` must already be the strand's 5'→3' encoding; coordinates
    are returned relative to that orientation and mapped by the caller.
    Uses the native core (``native/orfscan.cpp``) when built; the pure
    Python path below is the reference fallback (tested equal).
    """
    from ._native import native_candidates

    native = native_candidates(codes, MIN_GENE, MAX_STARTS)
    if native is not None:
        starts, ends, flags = native
        return [
            _Candidate(
                int(s), int(e), strand,
                partial_begin=bool(f & 2), partial_end=bool(f & 4),
            )
            for s, e, f in zip(starts, ends, flags)
        ]
    n = len(codes)
    stop_set = {tuple(_BASE[c] for c in s) for s in _STOPS}
    start_set = {tuple(_BASE[c] for c in s) for s in _STARTS}
    candidates: List[_Candidate] = []
    for frame in range(3):
        stops = [
            i for i in range(frame, n - 2, 3)
            if (codes[i], codes[i + 1], codes[i + 2]) in stop_set
        ]
        boundaries = stops + [n - (n - frame) % 3]
        previous_stop_end = frame
        for stop_i, stop in enumerate(boundaries):
            is_real_stop = stop_i < len(stops)
            region = (previous_stop_end, stop)  # codons in [region) are stop-free
            previous_stop_end = stop + 3
            span = region[1] - region[0]
            if span < MIN_GENE - 3:
                continue
            # candidate starts inside the region
            starts = [
                i for i in range(region[0], region[1] - 2, 3)
                if (codes[i], codes[i + 1], codes[i + 2]) in start_set
            ]
            gene_end = region[1] + (3 if is_real_stop else 0)
            partial_end = not is_real_stop
            if region[0] == frame:
                # region touches the contig begin: allow a partial gene
                starts = [region[0]] + [s for s in starts if s != region[0]]
            for s in starts[:MAX_STARTS]:  # cap alternative starts per stop
                if gene_end - s < MIN_GENE:
                    continue
                partial_begin = (s == region[0]) and (
                    (codes[s], codes[s + 1], codes[s + 2]) not in start_set
                )
                candidates.append(_Candidate(s, gene_end, strand,
                                             partial_begin=partial_begin,
                                             partial_end=partial_end))
    return candidates


def _gc_percent(codes: "numpy.ndarray") -> float:
    """GC content (percent) over the valid (ACGT) positions."""
    valid = codes >= 0
    if not valid.any():
        return 50.0
    return float(((codes == 1) | (codes == 2)).sum() / valid.sum()) * 100.0


def _hexamer_counts(codes: "numpy.ndarray", spans: Sequence[Tuple[int, int]],
                    pseudocount: float = 1.0) -> "numpy.ndarray":
    counts = numpy.full(4096, pseudocount, dtype=numpy.float64)
    if not len(spans):
        return counts
    if pseudocount == 1.0:
        # the native core walks the spans directly; the numpy fallback
        # below pays a full-genome rolling-hexamer pass PER CALL, which
        # profiled as the dominant cost of self-training (8 calls x
        # ~0.17 s on the 3.3 Mbp bench contig)
        from ._native import native_hexamer_counts

        native = native_hexamer_counts(codes, spans)
        if native is not None:
            return native
    # ONE rolling-hexamer pass over the whole sequence, then one
    # bincount over the concatenated in-frame span positions (a
    # per-span ufunc.at loop cost more than the native ORF scan on
    # genome-sized training passes)
    n = len(codes)
    if n < 6:
        return counts
    seg = codes.astype(numpy.int64)
    h_all = (
        seg[:-5] * 1024 + seg[1:-4] * 256 + seg[2:-3] * 64
        + seg[3:-2] * 16 + seg[4:-1] * 4 + seg[5:]
    )
    valid = codes >= 0
    ok_all = (valid[:-5] & valid[1:-4] & valid[2:-3]
              & valid[3:-2] & valid[4:-1] & valid[5:])
    span_arr = numpy.asarray(spans, dtype=numpy.int64).reshape(-1, 2)
    begins = span_arr[:, 0]
    stops = numpy.minimum(span_arr[:, 1], n) - 5
    lens = numpy.maximum((stops - begins + 2) // 3, 0)
    total = int(lens.sum())
    if total:
        offsets = numpy.repeat(begins, lens)
        bases = numpy.repeat(numpy.cumsum(lens) - lens, lens)
        idx = offsets + 3 * (numpy.arange(total, dtype=numpy.int64) - bases)
        idx = idx[ok_all[idx]]
        counts += numpy.bincount(h_all[idx], minlength=4096)
    return counts


class _StrandData:
    """One strand of a training/inference sequence, with candidates."""

    __slots__ = ("seq5", "codes", "cands", "strand", "_up_codes")

    def upstream_codes(self) -> "numpy.ndarray":
        """``[n_cands, W_UP_WINDOW]`` encoded upstream windows (cached).

        Right-aligned (column ``W-1`` = position −1); missing/N
        positions hold −1, which the positional scorer maps to 0.
        """
        if self._up_codes is None:
            W = W_UP_WINDOW
            out = numpy.full((len(self.cands), W), -1, dtype=numpy.int8)
            for i, c in enumerate(self.cands):
                lo = max(0, c.start - W)
                seg = self.codes[lo : c.start]
                if len(seg):
                    out[i, W - len(seg):] = seg
            self._up_codes = out
        return self._up_codes

    def __init__(self, seq5: str, strand: int, mask: bool) -> None:
        self.seq5 = seq5
        self.strand = strand
        self.codes = _encode(seq5)
        cands = _find_orfs(self.codes, strand, len(seq5))
        if mask:
            spans = _mask_spans(self.codes)
            if spans:
                begins = [b for b, _ in spans]
                ends = [e for _, e in spans]

                def overlaps(c: _Candidate) -> bool:
                    i = bisect.bisect_right(begins, c.end - 1) - 1
                    return i >= 0 and ends[i] > c.start

                cands = [c for c in cands if not overlaps(c)]
        for c in cands:
            if not c.partial_begin:
                c.codon = seq5[c.start: c.start + 3]
            # both bounds clamped: a negative stop would wrap and scan
            # (nearly) the whole contig for edge candidates
            upstream = seq5[max(0, c.start - 15): max(0, c.start - 4)]
            for b, motif in enumerate(_RBS_MOTIFS):
                if motif in upstream:
                    c.rbs = b
                    break
            c.upstream = seq5[max(0, c.start - W_UP_WINDOW): c.start]
        self.cands = cands
        self._up_codes = None


class _Model:
    """A fitted gene model: hexamer log-odds + learned start statistics.

    ``upstream_lo`` is an optional positional upstream base log-odds
    matrix ``[W_UPSTREAM, 4]`` — the analog of Prodigal's ``uscore``
    (upstream composition model, the start signal it falls back to for
    genomes that do not use Shine-Dalgarno motifs).  The preset
    trainer fits it; the self-trainer leaves it off (the RBS bins carry
    the signal for SD-using genomes).
    """

    __slots__ = ("log_odds", "codon_lo", "rbs_lo", "upstream_lo")

    def __init__(self, log_odds, codon_lo, rbs_lo, upstream_lo=None) -> None:
        self.log_odds = log_odds
        self.codon_lo = codon_lo      # {codon: log-odds}
        self.rbs_lo = rbs_lo          # numpy [len(_RBS_MOTIFS)+1], last = no-RBS
        self.upstream_lo = upstream_lo

    def start_bonus(self, c: _Candidate) -> float:
        if c.partial_begin:
            return 0.0
        bonus = (
            W_START * self.codon_lo.get(c.codon, -2.0)
            + W_RBS * float(self.rbs_lo[c.rbs])
        )
        if self.upstream_lo is not None and c.upstream is not None:
            lo = self.upstream_lo
            w = lo.shape[0]
            u = c.upstream[-w:]
            offset = w - len(u)
            bonus += W_UPSTREAM * float(sum(
                lo[offset + i, _BASE[ch]] for i, ch in enumerate(u)
                if ch in _BASE
            ))
        return bonus

    def start_bonus_batch(self, strand_data: "_StrandData") -> "numpy.ndarray":
        """Vectorized :meth:`start_bonus` over one strand's candidates."""
        cands = strand_data.cands
        out = numpy.array([
            0.0 if c.partial_begin else (
                W_START * self.codon_lo.get(c.codon, -2.0)
                + W_RBS * float(self.rbs_lo[c.rbs])
            )
            for c in cands
        ])
        if self.upstream_lo is not None and cands:
            codes = strand_data.upstream_codes()       # [n, W], -1 = pad/N
            lo = numpy.zeros((codes.shape[1], 5))
            lo[:, :4] = self.upstream_lo
            scores = lo[numpy.arange(codes.shape[1])[None, :], codes].sum(axis=1)
            complete = numpy.array([not c.partial_begin for c in cands])
            out += W_UPSTREAM * scores * complete
        return out


#: contigs at least this long self-train in metagenome mode (enough
#: statistics to beat any preset; Prodigal's own guidance is >=100 kb
#: of sequence for training) — shorter contigs score the preset bank
SELF_TRAIN_MIN = 100_000


class ScanFinder(ORFFinder):
    """Six-frame gene finder with DP gene selection.

    In metagenome mode, short contigs are scored against a bank of
    PRETRAINED models and the best-fitting one is kept — Prodigal's
    metagenome design (``gecco/orf.py:75``,
    ``GeneFinder(meta=True)`` over ~50 preset training files; the
    winner appears in its GFF output as ``model="36|Ralstonia_..."``).
    Contigs of at least ``SELF_TRAIN_MIN`` bp train on themselves
    instead (two-pass self-training, the Prodigal single-mode scheme),
    as does ``metagenome=False`` over the joined input.
    """

    def __init__(self, metagenome: bool = True, mask: bool = False, cpus: int = 0,
                 translation_table: int = 11, presets: Optional[Sequence] = None) -> None:
        self.metagenome = metagenome
        self.mask = mask
        self.cpus = cpus
        self.translation_table = translation_table
        self._presets = presets          # None = lazy-load embedded bank
        self._preset_cache: Optional[List[Tuple[str, _Model, float]]] = None

    def _preset_models(self) -> List[Tuple[str, _Model, float]]:
        if self._preset_cache is None:
            if self._presets is None:
                from .presets import load_presets

                self._presets = load_presets()
            self._preset_cache = [
                (preset.name, _Model(
                    preset.log_odds,
                    dict(zip(_STARTS, preset.codon_lo.tolist())),
                    preset.rbs_lo,
                    getattr(preset, "upstream_lo", None),
                ), float(preset.gc))
                for preset in self._presets
            ]
        return self._preset_cache

    # -- scoring ------------------------------------------------------------

    @staticmethod
    def _seed_log_odds(strands: Sequence[_StrandData]) -> "numpy.ndarray":
        """Hexamer log-odds from long-ORF seeds vs whole-sequence background."""
        seeds = {
            s.strand: [(c.start, c.end - 3) for c in s.cands if c.end - c.start >= 500]
            for s in strands
        }
        if not any(seeds.values()):
            for s in strands:
                seeds[s.strand] = sorted(
                    ((c.start, c.end - 3) for c in s.cands),
                    key=lambda span: span[0] - span[1],
                )[: max(3, len(s.cands) // 10)]
        coding = numpy.zeros(4096)
        background = numpy.zeros(4096)
        for s in strands:
            coding += _hexamer_counts(s.codes, seeds.get(s.strand, []))
            background += _hexamer_counts(s.codes, [(0, len(s.codes))])
        log_odds = numpy.log(coding / coding.sum()) - numpy.log(background / background.sum())
        return numpy.clip(log_odds, -4.0, 4.0)

    @staticmethod
    def _positional_log_odds(strands: Sequence[_StrandData]) -> "numpy.ndarray":
        """``[3, 4]`` codon-position base log-odds from long-ORF seeds.

        The robust counterpart of the hexamer model for contigs too
        short to estimate 4096 dicodon parameters: universal amino-acid
        composition skews each codon position's base distribution away
        from the genomic background (the signal behind Fickett's
        TESTCODE statistic), and 12 parameters are estimable from a
        handful of long ORFs.  Crucially the model discriminates
        *frames of the same locus* almost composition-free — the exact
        decision the held-out preset-bank failure got wrong
        (docs/parity.md, held-out BGC0001866 measurements).
        """
        pos_counts = numpy.ones((3, 4))
        bg_counts = numpy.ones(4)
        for s in strands:
            codes = s.codes
            bg_counts += numpy.bincount(codes[codes >= 0], minlength=4)
            seeds = [c for c in s.cands if c.end - c.start >= 500]
            if not seeds:
                seeds = sorted(s.cands, key=lambda c: c.start - c.end)
                seeds = seeds[: max(3, len(s.cands) // 10)]
            for c in seeds:
                seg = codes[c.start: c.end - 3]
                for p in range(3):
                    sub = seg[p::3]
                    sub = sub[sub >= 0]
                    pos_counts[p] += numpy.bincount(sub, minlength=4)
        pos_f = pos_counts / pos_counts.sum(axis=1, keepdims=True)
        bg_f = bg_counts / bg_counts.sum()
        return numpy.log(pos_f / bg_f[None, :])

    @staticmethod
    def _positional_scores(s: _StrandData, lo: "numpy.ndarray") -> "numpy.ndarray":
        """Positional-model score of every candidate on one strand.

        One cumulative sum per frame makes each candidate O(1): a
        candidate starting at ``b`` reads frame ``b % 3``, where
        position ``i`` holds codon position ``(i - b) % 3``.
        """
        codes = s.codes
        n = len(codes)
        valid = codes >= 0
        clamped = numpy.where(valid, codes, 0)
        cs = numpy.zeros((3, n + 1))
        idx = numpy.arange(n)
        for f in range(3):
            vals = numpy.where(valid, lo[(idx - f) % 3, clamped], 0.0)
            numpy.cumsum(vals, out=cs[f, 1:])
        out = numpy.empty(len(s.cands))
        for i, c in enumerate(s.cands):
            f = c.start % 3
            out[i] = cs[f, c.end - 3] - cs[f, c.start]
        return out

    def _score_batch(self, codes, candidates: List[_Candidate], log_odds) -> "numpy.ndarray":
        """Coding score + length prior for every candidate (native or numpy)."""
        from ._native import native_scores

        if not candidates:
            return numpy.zeros(0)
        starts = numpy.array([c.start for c in candidates], dtype=numpy.int32)
        ends = numpy.array([c.end - 3 for c in candidates], dtype=numpy.int32)
        coding = native_scores(codes, log_odds, starts, ends)
        if coding is None:
            coding = numpy.array([
                self._score_coding(codes, int(b), int(e), log_odds)
                for b, e in zip(starts, ends)
            ])
        lengths = numpy.maximum(ends + 3 - starts, 1)
        return coding + 0.5 * numpy.log(lengths / 90.0)

    @staticmethod
    def _score_coding(codes, begin: int, end: int, log_odds) -> float:
        seg = codes[begin:end]
        if len(seg) < 6:
            return 0.0
        h = (
            seg[:-5] * 1024 + seg[1:-4] * 256 + seg[2:-3] * 64
            + seg[3:-2] * 16 + seg[4:-1] * 4 + seg[5:]
        )
        valid = seg >= 0
        ok = (
            valid[:-5] & valid[1:-4] & valid[2:-3]
            & valid[3:-2] & valid[4:-1] & valid[5:]
        )
        h_inframe = h[::3][ok[::3]]
        return float(log_odds[h_inframe].sum())

    @staticmethod
    def _static_start_bonus(candidate: _Candidate) -> float:
        """Pass-1 start prior (bacterial consensus), before self-training."""
        if candidate.partial_begin:
            return -1.0
        bonus = _START_BONUS.get(candidate.codon, -2.0)
        if candidate.rbs >= 0:
            bonus += _RBS_BONUS.get(len(_RBS_MOTIFS[candidate.rbs]), 1.0)
        return bonus

    def _fit_model(self, strands: Sequence[_StrandData]) -> _Model:
        """Two-pass self-training: seed model -> provisional genes -> retrain.

        The second pass recomputes hexamer statistics on the provisional
        gene set and learns the start-codon and RBS-bin usage of selected
        genes against the candidate background (the Prodigal paper's
        iterative start training, re-implemented from scratch).
        """
        log_odds = self._seed_log_odds(strands)
        provisional: List[_Candidate] = []
        for s in strands:
            scores = self._score_batch(s.codes, s.cands, log_odds)
            for c, coding in zip(s.cands, scores):
                c.score = float(coding) + self._static_start_bonus(c)
            provisional.extend(self._select_local(s))
        if not provisional:
            return _Model(log_odds, dict(_START_BONUS), numpy.zeros(len(_RBS_MOTIFS) + 1))

        # retrained hexamer statistics from the provisional genes
        coding = numpy.zeros(4096)
        background = numpy.zeros(4096)
        selected_ids = {id(c) for c in provisional}
        for s in strands:
            spans = [(c.start, c.end - 3) for c in s.cands if id(c) in selected_ids]
            coding += _hexamer_counts(s.codes, spans)
            background += _hexamer_counts(s.codes, [(0, len(s.codes))])
        log_odds2 = numpy.clip(
            numpy.log(coding / coding.sum()) - numpy.log(background / background.sum()),
            -4.0, 4.0,
        )

        # learned start model: selected usage vs candidate background
        all_cands = [c for s in strands for c in s.cands]
        codon_lo = {}
        for codon in _STARTS:
            sel = sum(1 for c in provisional if c.codon == codon) + 1.0
            bg = sum(1 for c in all_cands if c.codon == codon) + 1.0
            codon_lo[codon] = float(
                numpy.log(sel / (len(provisional) + 3.0))
                - numpy.log(bg / (len(all_cands) + 3.0))
            )
        rbs_lo = numpy.zeros(len(_RBS_MOTIFS) + 1)
        for b in list(range(len(_RBS_MOTIFS))) + [-1]:
            sel = sum(1 for c in provisional if c.rbs == b) + 1.0
            bg = sum(1 for c in all_cands if c.rbs == b) + 1.0
            rbs_lo[b] = float(
                numpy.log(sel / (len(provisional) + 7.0))
                - numpy.log(bg / (len(all_cands) + 7.0))
            )
        return _Model(log_odds2, codon_lo, rbs_lo)

    # -- selection ----------------------------------------------------------

    def _select_local(self, s: _StrandData) -> List[_Candidate]:
        """Select a compatible set on one strand (training passes only)."""
        return self._select(list(s.cands))

    @staticmethod
    def _select(candidates: List[_Candidate],
                floor: Optional[float] = None) -> List[_Candidate]:
        """Max-weight compatible subset (bounded overlap) via DP."""
        if floor is None:
            floor = MIN_SCORE
        positive = [c for c in candidates if c.score > floor]
        positive.sort(key=lambda c: c.end)
        if not positive:
            return []
        ends = [c.end for c in positive]
        best = [0.0] * (len(positive) + 1)  # best[i] = best using first i, prefix max
        take_score = [0.0] * len(positive)
        parent = [-1] * len(positive)
        for i, candidate in enumerate(positive):
            limit = candidate.start + MAX_OVERLAP
            j = bisect.bisect_right(ends, limit, 0, i)  # predecessors ending before limit
            take_score[i] = best[j] + candidate.score
            parent[i] = j
            best[i + 1] = max(best[i], take_score[i])
        # traceback
        selected: List[_Candidate] = []
        i = len(positive)
        while i > 0:
            if best[i] == best[i - 1] and take_score[i - 1] < best[i]:
                i -= 1
                continue
            if take_score[i - 1] == best[i]:
                selected.append(positive[i - 1])
                i = parent[i - 1]
            else:
                i -= 1
        selected.reverse()
        return selected

    def _compete(
        self,
        models: Sequence[_Model],
        strands: Sequence[_StrandData],
        merged: List[_Candidate],
        assign: Callable[[Sequence["numpy.ndarray"]], None],
    ) -> List[_Candidate]:
        """Score the contig under each model; best-total selection wins.

        The Prodigal meta-mode contract (``gecco/orf.py:75``):
        all models share one scoring form (hexamer log-odds + learned
        start bonuses, both log-likelihood ratios against the contig
        background), so selected-set totals are comparable.
        """
        best_total = -numpy.inf
        winner: List[Tuple[_Candidate, float]] = []
        for m in models:
            assign([
                self._score_batch(s.codes, s.cands, m.log_odds)
                + m.start_bonus_batch(s)
                for s in strands
            ])
            chosen = self._select(merged)
            total = sum(c.score for c in chosen)
            if total > best_total:
                best_total = total
                winner = [(c, c.score) for c in chosen]
        for candidate, value in winner:
            candidate.score = value
        return [c for c, _v in winner]

    def _call_short_contig(
        self,
        seq: str,
        strands: Sequence[_StrandData],
        views: dict,
        merged: List[_Candidate],
        assign: Callable[[Sequence["numpy.ndarray"]], None],
    ) -> List[_Candidate]:
        """Metagenome-mode calling for one short contig.

        GC-compatible presets (within :data:`GC_GATE`) compete as in
        Prodigal's meta mode; the de-novo positional fallback
        (:meth:`_call_short_denovo`) always runs alongside, and the
        preset winner is kept only while its selected genes hold at
        least ``1 / FIT_MARGIN`` of the fallback's total
        positional-model score.  The positional total is the neutral
        yardstick between the two scoring families: it is estimated
        from the contig itself and free of any preset's codon-usage
        assumptions, so a preset that tiles the contig with wrong-frame
        calls shows up as a large positional deficit (measured on the
        planted-cluster genome: ratio 2.39 vs 1.00-1.04 for good fits).
        """
        gc = _gc_percent(strands[0].codes)
        bank = [m for _name, m, preset_gc in self._preset_models()
                if abs(preset_gc - gc) <= GC_GATE]
        pos_lo = self._positional_log_odds(strands)
        pos_scores = [self._positional_scores(s, pos_lo) for s in strands]
        fallback = self._call_short_denovo(
            seq, strands, merged, assign, pos_scores)
        if not bank:
            return fallback
        # the preset competition reassigns every view's score; snapshot
        # the fallback winners' scores so a fallback return hands back
        # the values it was actually selected under
        fallback_scores = [(c, c.score) for c in fallback]
        preset_sel = self._compete(bank, strands, merged, assign)
        pos_of = {
            id(view): float(value)
            for s, values in zip(strands, pos_scores)
            for view, value in zip(views[s.strand], values)
        }
        preset_total = sum(pos_of[id(c)] for c in preset_sel)
        fallback_total = sum(pos_of[id(c)] for c in fallback)
        if fallback_total > max(preset_total, 0.0) * FIT_MARGIN:
            for candidate, value in fallback_scores:
                candidate.score = value
            return fallback
        return preset_sel

    def _call_short_denovo(
        self,
        seq: str,
        strands: Sequence[_StrandData],
        merged: List[_Candidate],
        assign: Callable[[Sequence["numpy.ndarray"]], None],
        pos_scores: Optional[Sequence["numpy.ndarray"]] = None,
    ) -> List[_Candidate]:
        """De-novo calling for short contigs with no GC-compatible preset.

        Two passes, both measured on held-out BGC0001866 (the flagship
        genome with every preset trained on it removed — see
        docs/parity.md):

        1. the 12-parameter positional model selects a seed gene set
           (21/23 golden stops, 2 spurious at ``POS_MIN_SCORE``) —
           hexamer statistics are not estimable de novo at this size,
           and a *mismatched* preset's hexamers actively invert the
           frame ranking;
        2. one supervised retraining pass on the seed (the preset
           trainer with the seed standing in for the annotation) adds
           in-genome hexamer statistics and a learned start model, and
           the composite score (hexamer + positional + start bonus)
           re-selects at the normal floor.
        """
        if pos_scores is None:
            pos_lo = self._positional_log_odds(strands)
            pos_scores = [self._positional_scores(s, pos_lo) for s in strands]
        assign(pos_scores)
        seed = self._select(merged, floor=POS_MIN_SCORE)
        if not seed:
            return []
        from .presets import train_preset

        genes = [(c.start + 1, c.end, c.strand) for c in seed]
        preset = train_preset(seq, genes, name="fallback",
                              strands=tuple(strands))
        m = _Model(
            preset.log_odds,
            dict(zip(_STARTS, preset.codon_lo.tolist())),
            preset.rbs_lo,
            preset.upstream_lo,
        )
        assign([
            self._score_batch(s.codes, s.cands, m.log_odds)
            + m.start_bonus_batch(s) + pos
            for s, pos in zip(strands, pos_scores)
        ])
        refined = self._select(merged)
        return refined if refined else seed

    # -- public API ---------------------------------------------------------

    def find_genes(
        self,
        records: Iterable[SeqRecord],
        progress: Optional[Callable[[SeqRecord, int], None]] = None,
    ) -> Iterator[Gene]:
        _progress = (lambda x, y: None) if progress is None else progress
        records = list(records)

        shared: Optional[_Model] = None
        if not self.metagenome:
            # single mode: one model from all contigs joined with linkers
            # (reference orf.py:77-85), then applied per contig
            joined = _LINKER.join(str(r.seq).upper() for r in records)
            strands = [
                _StrandData(joined, 1, self.mask),
                _StrandData(reverse_complement(joined), -1, self.mask),
            ]
            shared = self._fit_model(strands)

        def process(record: SeqRecord) -> List[Gene]:
            return list(self._find_in_record(record, shared))

        # threads pay off only for contigs whose work is dominated by
        # the GIL-releasing native scan — the self-training (>=100 kb)
        # path.  Short contigs run the Python-heavy preset/fallback
        # path, where a thread pool CONVOYS on the GIL (measured on a
        # 68-contig metagenome, 2 cores: 1.38 s serial vs 2.5 s with 2
        # threads) — the reference threads everything because pyrodigal
        # releases the GIL wholesale (orf.py:95,128-130)
        cpus = self.cpus if self.cpus > 0 else (os.cpu_count() or 1)
        large = [i for i, r in enumerate(records)
                 if len(r.seq) >= SELF_TRAIN_MIN]
        if cpus > 1 and len(large) > 1:
            # large contigs run in the pool while the main thread works
            # through the short ones in between; results stream in
            # input order (each get() blocks only for its own record)
            with ThreadPool(min(cpus, len(large))) as pool:
                pending = {
                    i: pool.apply_async(process, (records[i],))
                    for i in large
                }
                for i, record in enumerate(records):
                    genes = (pending[i].get() if i in pending
                             else process(record))
                    _progress(record, len(genes))
                    yield from genes
        else:
            for record in records:
                genes = process(record)
                _progress(record, len(genes))
                yield from genes

    def _find_in_record(
        self, record: SeqRecord, model: Optional[_Model] = None
    ) -> Iterator[Gene]:
        seq = str(record.seq).upper()
        n = len(seq)
        if n < MIN_GENE:
            return
        forward = _StrandData(seq, 1, self.mask)
        reverse = _StrandData(reverse_complement(seq), -1, self.mask)
        strands = (forward, reverse)

        # forward-coordinate selection VIEWS; the originals stay
        # strand-local so score components can be (re)computed at any
        # stage (the fallback path needs a second scoring pass)
        views = {}
        for s in strands:
            view_list = []
            for c in s.cands:
                if s.strand == -1:
                    b, e = n - c.end, n - c.start
                else:
                    b, e = c.start, c.end
                view_list.append(_Candidate(
                    b, e, s.strand,
                    partial_begin=c.partial_begin, partial_end=c.partial_end))
            views[s.strand] = view_list
        merged: List[_Candidate] = views[1] + views[-1]

        def assign(per_strand_scores: Sequence["numpy.ndarray"]) -> None:
            for s, values in zip(strands, per_strand_scores):
                for view, value in zip(views[s.strand], values):
                    view.score = float(value)

        if model is not None:
            selected = self._compete([model], strands, merged, assign)
        elif n < SELF_TRAIN_MIN:
            selected = self._call_short_contig(
                seq, strands, views, merged, assign)
        else:
            selected = self._compete(
                [self._fit_model(strands)], strands, merged, assign)
        selected.sort(key=lambda c: (c.start, c.end))
        for i, candidate in enumerate(selected):
            if candidate.strand == 1:
                nucleotides = seq[candidate.start : candidate.end]
            else:
                nucleotides = reverse_complement(seq[candidate.start : candidate.end])
            protein_seq = translate(nucleotides, table=self.translation_table)
            # Prodigal conventions, shared with the resume path
            # (_common.assign_sources): the trailing stop '*' is kept,
            # and the initiator codon renders as M for complete genes
            # (edge partials keep the literal translation)
            if (not candidate.partial_begin and protein_seq
                    and nucleotides[:3] in _STARTS):
                protein_seq = "M" + protein_seq[1:]
            protein = Protein(id=f"{record.id}_{i+1}", seq=Seq(protein_seq))
            yield Gene(
                source=record,
                start=candidate.start + 1,
                end=candidate.end,
                strand=Strand(candidate.strand),
                protein=protein,
                qualifiers={
                    "inference": ["ab initio prediction:gecco-tpu-scan"],
                    "transl_table": [str(self.translation_table)],
                },
            )
