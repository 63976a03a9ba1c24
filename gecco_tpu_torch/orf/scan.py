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
``ThreadPool(cpus).imap`` (``orf.py:95,128-130``).  The candidates are
arrays from enumeration to selection, and the loops over nucleotides and
candidates (enumeration, each candidate's start codon and RBS bin,
hexamer scoring, the selection DP) run in the native core
(``csrc/host/orfscan.cpp``), whose ctypes calls release the GIL for the
duration of the native execution — which is why ``cpus > 1`` gives real
per-contig parallelism.

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
from ..profiling import TIMER
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
    return table[numpy.minimum(raw, 127)]


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


#: candidate flag bits, as the native core writes them (``orfscan.cpp``)
PARTIAL_BEGIN = 2
PARTIAL_END = 4
#: codon class of a start codon outside :data:`_STARTS` (class ``i`` < 3 is
#: ``_STARTS[i]``, -1 a partial begin, which has none)
_OTHER = len(_STARTS)


def _codon_table(values: Iterable[float]) -> "numpy.ndarray":
    """A start-codon log-odds per codon class: ``_STARTS`` in order, then -2.0
    for any other codon."""
    return numpy.array([*values, -2.0], dtype=numpy.float64)


#: pass-1 priors (bacterial consensus) per codon class and RBS bin (-1 = none)
_STATIC_CODON = _codon_table(_START_BONUS[codon] for codon in _STARTS)
_STATIC_RBS = numpy.array(
    [_RBS_BONUS.get(len(motif), 1.0) for motif in _RBS_MOTIFS] + [0.0])

MAX_STARTS = 16


def _find_orfs(codes: "numpy.ndarray") -> Tuple["numpy.ndarray", "numpy.ndarray", "numpy.ndarray"]:
    """Enumerate candidate genes on one strand of an encoded sequence.

    ``codes`` must already be the strand's 5'→3' encoding; the candidates'
    ``start`` (inclusive) and ``end`` (exclusive, stop included) are int32
    in that orientation, and ``flags`` holds :data:`PARTIAL_BEGIN` and
    :data:`PARTIAL_END`.  Uses the native core (``csrc/host/orfscan.cpp``)
    when built; the pure Python path below is the reference fallback
    (tested equal).
    """
    from ._native import native_candidates

    native = native_candidates(codes, MIN_GENE, MAX_STARTS)
    if native is not None:
        return native
    n = len(codes)
    stop_set = {tuple(_BASE[c] for c in s) for s in _STOPS}
    start_set = {tuple(_BASE[c] for c in s) for s in _STARTS}
    found: List[Tuple[int, int, int]] = []
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
            if region[0] == frame:
                # region touches the contig begin: allow a partial gene
                starts = [region[0]] + [s for s in starts if s != region[0]]
            for s in starts[:MAX_STARTS]:  # cap alternative starts per stop
                if gene_end - s < MIN_GENE:
                    continue
                flags = 0 if is_real_stop else PARTIAL_END
                if s == region[0] and (codes[s], codes[s + 1], codes[s + 2]) not in start_set:
                    flags |= PARTIAL_BEGIN
                found.append((s, gene_end, flags))
    table = numpy.array(found, dtype=numpy.int32).reshape(-1, 3)
    return table[:, 0].copy(), table[:, 1].copy(), table[:, 2].astype(numpy.uint8)


def _annotate(codes: "numpy.ndarray", starts: "numpy.ndarray",
              flags: "numpy.ndarray") -> Tuple["numpy.ndarray", "numpy.ndarray"]:
    """Each candidate's start-codon class and RBS bin (int8 arrays).

    The codon class indexes :data:`_STARTS` (:data:`_OTHER` for any other
    codon, -1 for a partial begin).  The RBS bin is the first motif of
    :data:`_RBS_MOTIFS`, in list order, that occurs anywhere in
    ``[max(0, start - 15), max(0, start - 4))``; -1 when none does.  Native
    core when built, else :func:`_annotate_python` (tested equal).
    """
    from ._native import native_annotate

    native = native_annotate(codes, starts, flags)
    if native is not None:
        return native
    return _annotate_python(codes, starts, flags)


def _annotate_python(codes: "numpy.ndarray", starts: "numpy.ndarray",
                     flags: "numpy.ndarray") -> Tuple["numpy.ndarray", "numpy.ndarray"]:
    """The numpy twin of the native ``orfscan_annotate``."""
    n = len(codes)
    starts = numpy.asarray(starts, dtype=numpy.int64)
    codon = numpy.full(len(starts), -1, dtype=numpy.int8)
    complete = (numpy.asarray(flags) & PARTIAL_BEGIN) == 0
    at = starts[complete]
    classes = numpy.full(len(at), _OTHER, dtype=numpy.int8)
    if len(at):
        tail = (codes[at + 1] == _BASE["T"]) & (codes[at + 2] == _BASE["G"])
        for k, start_codon in enumerate(_STARTS):
            classes[tail & (codes[at] == _BASE[start_codon[0]])] = k
    codon[complete] = classes
    lo = numpy.maximum(starts - 15, 0)
    hi = numpy.maximum(starts - 4, 0)
    rbs = numpy.full(len(starts), -1, dtype=numpy.int8)
    for b, motif in enumerate(_RBS_MOTIFS):
        places = n - len(motif) + 1          # where the motif can begin
        if places <= 0:
            continue
        match = numpy.ones(places, dtype=bool)
        for k, base in enumerate(motif):
            match &= codes[k : k + places] == _BASE[base]
        seen = numpy.concatenate(([0], numpy.cumsum(match)))   # matches before p
        last = numpy.minimum(hi - len(motif) + 1, places)      # begins in [lo, last)
        first = numpy.minimum(lo, places)
        hit = (last > first) & (seen[numpy.maximum(last, first)] > seen[first])
        rbs[(rbs < 0) & hit] = b
    return codon, rbs


def _upstream_codes(codes: "numpy.ndarray", starts: "numpy.ndarray") -> "numpy.ndarray":
    """``[len(starts), W_UP_WINDOW]`` int8 codes of the windows before each start.

    Right-aligned (column ``W-1`` = position −1); positions before the
    sequence and N positions hold −1, which the positional scorer maps to 0.
    """
    at = (numpy.asarray(starts, dtype=numpy.int64)[:, None]
          - W_UP_WINDOW + numpy.arange(W_UP_WINDOW)[None, :])
    return numpy.where(at >= 0, codes[numpy.maximum(at, 0)], -1).astype(numpy.int8)


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
    """One strand of a training/inference sequence, with its candidates as arrays.

    ``start``/``end`` (int32, 0-based half-open, strand-oriented), ``flags``
    (:data:`PARTIAL_BEGIN`, :data:`PARTIAL_END`), ``codon`` and ``rbs`` (int8,
    see :func:`_annotate`): one entry per candidate, in enumeration order.
    """

    __slots__ = ("codes", "strand", "start", "end", "flags", "codon", "rbs", "_up_codes")

    def __init__(self, seq5: str, strand: int, mask: bool) -> None:
        self.strand = strand
        self.codes = _encode(seq5)
        start, end, flags = _find_orfs(self.codes)
        TIMER.count("orf.candidates", len(start))
        if mask:
            spans = numpy.array(_mask_spans(self.codes), dtype=numpy.int64).reshape(-1, 2)
            if len(spans):
                # the last masked span beginning before the candidate's end
                i = numpy.searchsorted(spans[:, 0], end - 1, side="right") - 1
                keep = ~((i >= 0) & (spans[numpy.maximum(i, 0), 1] > start))
                start, end, flags = start[keep], end[keep], flags[keep]
        self.start, self.end, self.flags = start, end, flags
        self.codon, self.rbs = _annotate(self.codes, start, flags)
        self._up_codes: Optional["numpy.ndarray"] = None

    def __len__(self) -> int:
        return len(self.start)

    @property
    def complete(self) -> "numpy.ndarray":
        """True for candidates that begin at a start codon."""
        return (self.flags & PARTIAL_BEGIN) == 0

    def upstream_codes(self) -> "numpy.ndarray":
        """:func:`_upstream_codes` of every candidate (cached)."""
        if self._up_codes is None:
            self._up_codes = _upstream_codes(self.codes, self.start)
        return self._up_codes


class _Views:
    """Both strands' candidates in forward coordinates, the table the selection
    runs on: the forward strand's, then the reverse strand's ``(n - end, n -
    start)``, each in enumeration order.  The strand-local originals stay, so
    score components can be (re)computed at any stage."""

    __slots__ = ("start", "end", "strand", "flags")

    def __init__(self, forward: _StrandData, reverse: _StrandData, n: int) -> None:
        self.start = numpy.concatenate((forward.start, n - reverse.end)).astype(numpy.int32)
        self.end = numpy.concatenate((forward.end, n - reverse.start)).astype(numpy.int32)
        self.strand = numpy.repeat(numpy.array([1, -1], dtype=numpy.int8),
                                   (len(forward), len(reverse)))
        self.flags = numpy.concatenate((forward.flags, reverse.flags))


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
        self.codon_lo = codon_lo      # numpy, per codon class (_codon_table)
        self.rbs_lo = rbs_lo          # numpy [len(_RBS_MOTIFS)+1], last = no-RBS
        self.upstream_lo = upstream_lo

    def start_bonus_batch(self, strand_data: "_StrandData") -> "numpy.ndarray":
        """The learned start bonus of each of one strand's candidates
        (0 for a partial begin)."""
        complete = strand_data.complete
        out = numpy.where(
            complete,
            W_START * self.codon_lo[strand_data.codon] + W_RBS * self.rbs_lo[strand_data.rbs],
            0.0,
        )
        if self.upstream_lo is not None and len(strand_data):
            codes = strand_data.upstream_codes()       # [n, W], -1 = pad/N
            lo = numpy.zeros((codes.shape[1], 5))
            lo[:, :4] = self.upstream_lo
            scores = lo[numpy.arange(codes.shape[1])[None, :], codes].sum(axis=1)
            out += W_UPSTREAM * scores * complete
        return out


#: contigs at least this long self-train in metagenome mode (enough
#: statistics to beat any preset; Prodigal's own guidance is >=100 kb
#: of sequence for training) — shorter contigs score the preset bank
SELF_TRAIN_MIN = 100_000


def _start_log_odds(
    codon_sel: "numpy.ndarray", rbs_sel: "numpy.ndarray",
    codon_all: "numpy.ndarray", rbs_all: "numpy.ndarray",
) -> Tuple[List[float], "numpy.ndarray"]:
    """Start-codon log-odds (one per :data:`_STARTS`) and RBS-bin log-odds
    (``[len(_RBS_MOTIFS) + 1]``, last = no RBS) of the selected candidates'
    classes against all candidates', each count plus one."""
    n_sel, n_all = len(codon_sel), len(codon_all)
    sel_codons = numpy.bincount(codon_sel[codon_sel >= 0], minlength=_OTHER + 1)
    all_codons = numpy.bincount(codon_all[codon_all >= 0], minlength=_OTHER + 1)
    codon_lo = [
        float(numpy.log((int(sel_codons[k]) + 1.0) / (n_sel + 3.0))
              - numpy.log((int(all_codons[k]) + 1.0) / (n_all + 3.0)))
        for k in range(len(_STARTS))
    ]
    # bin b counted at b + 1, no RBS (-1) at 0
    sel_bins = numpy.bincount(rbs_sel.astype(numpy.intp) + 1, minlength=len(_RBS_MOTIFS) + 1)
    all_bins = numpy.bincount(rbs_all.astype(numpy.intp) + 1, minlength=len(_RBS_MOTIFS) + 1)
    rbs_lo = numpy.zeros(len(_RBS_MOTIFS) + 1)
    for b in list(range(len(_RBS_MOTIFS))) + [-1]:
        rbs_lo[b] = (
            numpy.log((int(sel_bins[b + 1]) + 1.0) / (n_sel + 7.0))
            - numpy.log((int(all_bins[b + 1]) + 1.0) / (n_all + 7.0))
        )
    return codon_lo, rbs_lo


def _select_python(start: "numpy.ndarray", end: "numpy.ndarray", scores: "numpy.ndarray",
                   floor: float, max_overlap: int) -> "numpy.ndarray":
    """The plain twin of the native ``orfscan_select``: max-weight compatible
    subset (bounded overlap) of the candidates scoring above ``floor``, as
    indices in order of end."""
    positive = numpy.flatnonzero(scores > floor)
    order = positive[numpy.argsort(end[positive], kind="stable")]
    if not len(order):
        return order
    ends = end[order].tolist()
    starts = start[order].tolist()
    values = scores[order].tolist()
    best = [0.0] * (len(order) + 1)  # best[i] = best using first i, prefix max
    take_score = [0.0] * len(order)
    parent = [-1] * len(order)
    for i, value in enumerate(values):
        limit = starts[i] + max_overlap
        j = bisect.bisect_right(ends, limit, 0, i)  # predecessors ending before limit
        take_score[i] = best[j] + value
        parent[i] = j
        best[i + 1] = max(best[i], take_score[i])
    # traceback
    selected: List[int] = []
    i = len(order)
    while i > 0:
        if best[i] == best[i - 1] and take_score[i - 1] < best[i]:
            i -= 1
            continue
        if take_score[i - 1] == best[i]:
            selected.append(i - 1)
            i = parent[i - 1]
        else:
            i -= 1
    selected.reverse()
    return order[numpy.array(selected, dtype=numpy.intp)]


def _phase_counts(codes: "numpy.ndarray", begins: "numpy.ndarray",
                  ends: "numpy.ndarray") -> "numpy.ndarray":
    """``[3, 4]`` int64 counts of each base at each codon position (the
    offset from the span's begin, mod 3) over the spans ``[begin, end)``.

    ``seen[r, b, i]`` counts the positions ``j < i`` with ``j % 3 == r``
    holding base ``b``, so a span reads each codon position in O(1)."""
    n = len(codes)
    at = numpy.flatnonzero(codes >= 0)
    marks = numpy.zeros((3, 4, n + 1), dtype=numpy.int64)
    marks[at % 3, codes[at], at + 1] = 1
    seen = numpy.cumsum(marks, axis=2)
    begins = numpy.asarray(begins, dtype=numpy.int64)
    ends = numpy.asarray(ends, dtype=numpy.int64)
    counts = numpy.zeros((3, 4), dtype=numpy.int64)
    for p in range(3):
        r = (begins + p) % 3
        counts[p] = (seen[r, :, ends] - seen[r, :, begins]).sum(axis=0)
    return counts


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

    Candidates live in arrays (:class:`_StrandData`, :class:`_Views`);
    a selection is an index array into the table it ran on.
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
                    _codon_table(preset.codon_lo.tolist()),
                    preset.rbs_lo,
                    getattr(preset, "upstream_lo", None),
                ), float(preset.gc))
                for preset in self._presets
            ]
        return self._preset_cache

    # -- scoring ------------------------------------------------------------

    @staticmethod
    def _seeds(s: _StrandData) -> "numpy.ndarray":
        """Indices of one strand's candidates of at least 500 nt."""
        return numpy.flatnonzero(s.end - s.start >= 500)

    @staticmethod
    def _longest(s: _StrandData) -> "numpy.ndarray":
        """Indices of the longest tenth (at least 3) of one strand's
        candidates, longest first, ties in enumeration order."""
        return numpy.argsort(s.start - s.end, kind="stable")[: max(3, len(s) // 10)]

    @staticmethod
    def _coding_spans(s: _StrandData, idx: "numpy.ndarray") -> "numpy.ndarray":
        """``[k, 2]`` coding spans ``(start, end - 3)`` (stop excluded)."""
        return numpy.stack((s.start[idx], s.end[idx] - 3), axis=1)

    @classmethod
    def _seed_log_odds(cls, strands: Sequence[_StrandData]) -> "numpy.ndarray":
        """Hexamer log-odds from long-ORF seeds vs whole-sequence background."""
        seeds = {s.strand: cls._seeds(s) for s in strands}
        if not any(len(idx) for idx in seeds.values()):
            seeds = {s.strand: cls._longest(s) for s in strands}
        coding = numpy.zeros(4096)
        background = numpy.zeros(4096)
        for s in strands:
            coding += _hexamer_counts(s.codes, cls._coding_spans(s, seeds[s.strand]))
            background += _hexamer_counts(s.codes, [(0, len(s.codes))])
        log_odds = numpy.log(coding / coding.sum()) - numpy.log(background / background.sum())
        return numpy.clip(log_odds, -4.0, 4.0)

    @classmethod
    def _positional_log_odds(cls, strands: Sequence[_StrandData]) -> "numpy.ndarray":
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
            seeds = cls._seeds(s)
            if not len(seeds):
                seeds = cls._longest(s)
            # integer counts: exact whatever the order of the additions
            pos_counts += _phase_counts(codes, s.start[seeds], s.end[seeds] - 3)
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
        frame = s.start % 3
        return cs[frame, s.end - 3] - cs[frame, s.start]

    def _score_batch(self, s: _StrandData, log_odds) -> "numpy.ndarray":
        """Coding score + length prior for every candidate (native or numpy)."""
        from ._native import native_scores

        if not len(s):
            return numpy.zeros(0)
        starts = s.start
        ends = s.end - 3
        coding = native_scores(s.codes, log_odds, starts, ends)
        if coding is None:
            coding = numpy.array([
                self._score_coding(s.codes, int(b), int(e), log_odds)
                for b, e in zip(starts, ends)
            ])
        lengths = numpy.maximum(ends + 3 - starts, 1)
        return coding + 0.5 * numpy.log(lengths / 90.0)

    @staticmethod
    def _score_coding(codes, begin: int, end: int, log_odds) -> float:
        seg = codes[begin:end].astype(numpy.int64)
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
    def _static_start_bonus(s: _StrandData) -> "numpy.ndarray":
        """Pass-1 start prior (bacterial consensus), before self-training."""
        return numpy.where(s.complete, _STATIC_CODON[s.codon] + _STATIC_RBS[s.rbs], -1.0)

    def _fit_model(self, strands: Sequence[_StrandData]) -> _Model:
        """Two-pass self-training: seed model -> provisional genes -> retrain.

        The second pass recomputes hexamer statistics on the provisional
        gene set and learns the start-codon and RBS-bin usage of selected
        genes against the candidate background (the Prodigal paper's
        iterative start training, re-implemented from scratch).
        """
        log_odds = self._seed_log_odds(strands)
        # one provisional selection per strand, in strand coordinates
        provisional = [
            self._select(s.start, s.end,
                         self._score_batch(s, log_odds) + self._static_start_bonus(s))
            for s in strands
        ]
        chosen = sum(len(idx) for idx in provisional)
        if not chosen:
            return _Model(log_odds, _STATIC_CODON.copy(), numpy.zeros(len(_RBS_MOTIFS) + 1))

        # retrained hexamer statistics from the provisional genes
        coding = numpy.zeros(4096)
        background = numpy.zeros(4096)
        for s, idx in zip(strands, provisional):
            coding += _hexamer_counts(s.codes, self._coding_spans(s, idx))
            background += _hexamer_counts(s.codes, [(0, len(s.codes))])
        log_odds2 = numpy.clip(
            numpy.log(coding / coding.sum()) - numpy.log(background / background.sum()),
            -4.0, 4.0,
        )

        # learned start model: selected usage vs candidate background
        codon_lo, rbs_lo = _start_log_odds(
            numpy.concatenate([s.codon[idx] for s, idx in zip(strands, provisional)]),
            numpy.concatenate([s.rbs[idx] for s, idx in zip(strands, provisional)]),
            numpy.concatenate([s.codon for s in strands]),
            numpy.concatenate([s.rbs for s in strands]),
        )
        return _Model(log_odds2, _codon_table(codon_lo), rbs_lo)

    # -- selection ----------------------------------------------------------

    @staticmethod
    def _select(start: "numpy.ndarray", end: "numpy.ndarray", scores: "numpy.ndarray",
                floor: Optional[float] = None) -> "numpy.ndarray":
        """Max-weight compatible subset (bounded overlap) via DP: indices
        of the candidates taken, in order of end (native core when built,
        else :func:`_select_python`)."""
        from ._native import native_select

        if floor is None:
            floor = MIN_SCORE
        chosen = native_select(start, end, scores, floor, MAX_OVERLAP)
        if chosen is not None:
            TIMER.count("orf.select.native")
            return chosen
        TIMER.count("orf.select.python")
        return _select_python(start, end, scores, floor, MAX_OVERLAP)

    def _compete(
        self,
        models: Sequence[_Model],
        strands: Sequence[_StrandData],
        table: _Views,
    ) -> "numpy.ndarray":
        """Score the contig under each model; best-total selection wins.

        The Prodigal meta-mode contract (``gecco/orf.py:75``):
        all models share one scoring form (hexamer log-odds + learned
        start bonuses, both log-likelihood ratios against the contig
        background), so selected-set totals are comparable.  Totals are
        summed left to right in the selection's order, as Python's ``sum``.
        """
        best_total = -numpy.inf
        winner = numpy.zeros(0, dtype=numpy.intp)
        for m in models:
            scores = numpy.concatenate([
                self._score_batch(s, m.log_odds) + m.start_bonus_batch(s)
                for s in strands
            ])
            chosen = self._select(table.start, table.end, scores)
            total = sum(scores[chosen].tolist())
            if total > best_total:
                best_total = total
                winner = chosen
        return winner

    def _call_short_contig(
        self,
        seq: str,
        strands: Sequence[_StrandData],
        table: _Views,
    ) -> "numpy.ndarray":
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
        fallback = self._call_short_denovo(seq, strands, table, pos_scores)
        if not bank:
            return fallback
        preset_sel = self._compete(bank, strands, table)
        positional = numpy.concatenate(pos_scores)
        # left-to-right sums, as Python's ``sum`` over the selections
        preset_total = sum(positional[preset_sel].tolist())
        fallback_total = sum(positional[fallback].tolist())
        if fallback_total > max(preset_total, 0.0) * FIT_MARGIN:
            return fallback
        return preset_sel

    def _call_short_denovo(
        self,
        seq: str,
        strands: Sequence[_StrandData],
        table: _Views,
        pos_scores: Optional[Sequence["numpy.ndarray"]] = None,
    ) -> "numpy.ndarray":
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
        seed = self._select(table.start, table.end, numpy.concatenate(pos_scores),
                            floor=POS_MIN_SCORE)
        if not len(seed):
            return seed
        from .presets import train_preset

        genes = numpy.stack(
            (table.start[seed] + 1, table.end[seed], table.strand[seed]), axis=1)
        preset = train_preset(seq, genes, name="fallback",
                              strands=tuple(strands))
        m = _Model(
            preset.log_odds,
            _codon_table(preset.codon_lo.tolist()),
            preset.rbs_lo,
            preset.upstream_lo,
        )
        refined = self._select(table.start, table.end, numpy.concatenate([
            self._score_batch(s, m.log_odds)
            + m.start_bonus_batch(s) + pos
            for s, pos in zip(strands, pos_scores)
        ]))
        return refined if len(refined) else seed

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
        # the GIL-releasing native calls — the self-training (>=100 kb)
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
        table = _Views(forward, reverse, n)

        if model is not None:
            selected = self._compete([model], strands, table)
        elif n < SELF_TRAIN_MIN:
            selected = self._call_short_contig(seq, strands, table)
        else:
            selected = self._compete([self._fit_model(strands)], strands, table)
        selected = selected[numpy.lexsort((table.end[selected], table.start[selected]))]
        for i, (start, end, strand, flags) in enumerate(zip(
                table.start[selected].tolist(), table.end[selected].tolist(),
                table.strand[selected].tolist(), table.flags[selected].tolist())):
            if strand == 1:
                nucleotides = seq[start:end]
            else:
                nucleotides = reverse_complement(seq[start:end])
            protein_seq = translate(nucleotides, table=self.translation_table)
            # Prodigal conventions, shared with the resume path
            # (_common.assign_sources): the trailing stop '*' is kept,
            # and the initiator codon renders as M for complete genes
            # (edge partials keep the literal translation)
            if (not flags & PARTIAL_BEGIN and protein_seq
                    and nucleotides[:3] in _STARTS):
                protein_seq = "M" + protein_seq[1:]
            protein = Protein(id=f"{record.id}_{i+1}", seq=Seq(protein_seq))
            yield Gene(
                source=record,
                start=start + 1,
                end=end,
                strand=Strand(strand),
                protein=protein,
                qualifiers={
                    "inference": ["ab initio prediction:gecco-tpu-scan"],
                    "transl_table": [str(self.translation_table)],
                },
            )
