"""The port's gene finder (``orf/scan.py``) against the JAX package's, and its
native core against its Python twins.

The port keeps the candidate table in arrays and runs the per-candidate
annotation and the selection DP in its C++ core; the JAX package's
``ScanFinder`` (one ``_Candidate`` object a candidate, a Python DP) is the
same algorithm, so every call must agree gene for gene.  Inputs are made
here from a seed: bacterial-shaped genomes with a ribosome binding site
before each gene.
"""

import numpy
import pytest

from gecco_tpu.orf.scan import ScanFinder as JaxScanFinder
from gecco_tpu.seq import Seq as JaxSeq, SeqRecord as JaxSeqRecord

from gecco_tpu_torch.orf import _native, scan
from gecco_tpu_torch.orf.scan import ScanFinder
from gecco_tpu_torch.profiling import TIMER
from gecco_tpu_torch.seq import Seq, SeqRecord, reverse_complement

_BASES = numpy.array(list("ACGT"))
_STOPS = {"TAA", "TAG", "TGA"}


def _bases(rng, size, gc):
    """``size`` random bases at G+C share ``gc``."""
    p = numpy.array([1 - gc, gc, gc, 1 - gc]) / 2
    return "".join(_BASES[rng.choice(4, size=size, p=p)])


def _body(rng, codons, gc3):
    """``codons`` sense codons: the first two positions skewed as in bacterial
    genes (ACGT 30:20:35:15 and 30:22:18:30), the third at G+C ``gc3``."""
    out = []
    while len(out) < codons:
        first = rng.choice(4, size=2 * codons, p=[0.3, 0.2, 0.35, 0.15])
        second = rng.choice(4, size=2 * codons, p=[0.3, 0.22, 0.18, 0.3])
        third = rng.choice(4, size=2 * codons, p=numpy.array([1 - gc3, gc3, gc3, 1 - gc3]) / 2)
        for a, b, c in zip(first, second, third):
            codon = _BASES[a] + _BASES[b] + _BASES[c]
            if codon not in _STOPS:
                out.append(codon)
    return "".join(out[:codons])


def _genome(seed, genes, gc3, spacer_gc, long_codons=()):
    """A contig of ``genes`` genes (lognormal lengths, median 280 codons) on
    both strands, each behind AGGAGG and a 7-base gap, plus one gene of each
    of ``long_codons`` codons; start codons ATG, GTG, TTG at 80:15:5."""
    rng = numpy.random.default_rng(seed)
    lengths = list(numpy.maximum(rng.lognormal(numpy.log(280), 0.5, size=genes), 60).astype(int))
    for codons in long_codons:
        lengths.insert(int(rng.integers(len(lengths) + 1)), codons)
    parts = [_bases(rng, int(rng.integers(50, 250)), spacer_gc)]
    for codons in lengths:
        start = rng.choice(["ATG", "GTG", "TTG"], p=[0.8, 0.15, 0.05])
        stop = rng.choice(sorted(_STOPS))
        unit = "AGGAGG" + _bases(rng, 7, spacer_gc) + start + _body(rng, codons, gc3) + stop
        parts.append(unit if rng.random() < 0.5 else reverse_complement(unit))
        parts.append(_bases(rng, int(rng.integers(20, 200)), spacer_gc))
    return "".join(parts)


def _with_n_runs(seq, seed, runs):
    """``seq`` with ``runs`` (length) stretches of N at seeded places."""
    rng = numpy.random.default_rng(seed)
    out = list(seq)
    for length in runs:
        at = int(rng.integers(0, len(seq) - length))
        out[at : at + length] = "N" * length
    return "".join(out)


def _calls(finder, contigs, record, seq):
    return [
        (g.source.id, g.protein.id, g.start, g.end, g.strand.sign,
         # partial begin: no initiator M; partial end: no trailing stop
         not str(g.protein.seq).startswith("M"), not str(g.protein.seq).endswith("*"),
         str(g.protein.seq))
        for g in finder.find_genes([record(id=name, seq=seq(s)) for name, s in contigs])
    ]


def _both(contigs, **options):
    ours = _calls(ScanFinder(**options), contigs, SeqRecord, Seq)
    theirs = _calls(JaxScanFinder(**options), contigs, JaxSeqRecord, JaxSeq)
    return ours, theirs


CASES = {
    # Streptomyces-like: high G+C, long low-stop shadow ORFs, a megasynthase gene
    "gc_rich": (lambda: [("gc_rich", _genome(1, 900, 0.92, 0.72, long_codons=(6000,)))], {}),
    "coli_like": (lambda: [("coli", _genome(2, 1000, 0.52, 0.5))], {}),
    # under SELF_TRAIN_MIN: G+C near a preset (the preset competition beside
    # the fallback: near_50 keeps the fallback, near_72 a preset), and far
    # from every preset (the fallback alone)
    "short_contigs": (lambda: [
        ("near_50", _genome(3, 30, 0.5, 0.5)),
        ("near_72", _genome(4, 20, 0.99, 0.85)),
        ("far_35", _genome(5, 25, 0.05, 0.2)),
        ("tiny", _genome(6, 1, 0.5, 0.5)[:400]),
    ], {"cpus": 1}),
    "mask": (lambda: [
        ("masked_long", _with_n_runs(_genome(7, 200, 0.6, 0.55), 7, [50, 120, 49, 300, 10])),
        ("masked_short", _with_n_runs(_genome(8, 20, 0.5, 0.5), 8, [60, 30])),
    ], {"mask": True, "cpus": 1}),
    "single_mode": (lambda: [
        ("one", _genome(9, 120, 0.8, 0.65)),
        ("two", _genome(10, 15, 0.8, 0.65)),
    ], {"metagenome": False, "cpus": 1}),
    "thread_pool": (lambda: [
        ("pool_a", _genome(11, 110, 0.55, 0.5)),
        ("pool_short", _genome(12, 10, 0.55, 0.5)),
        ("pool_b", _genome(13, 120, 0.9, 0.7)),
        ("pool_c", _genome(14, 115, 0.7, 0.6)),
    ], {"cpus": 3}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_finder_matches_jax(case):
    make, options = CASES[case]
    contigs = make()
    ours, theirs = _both(contigs, **options)
    assert ours, "no gene called"
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a == b


def test_scan_finder_without_native_core_matches(monkeypatch):
    """The whole Python fallback (no g++) calls the same genes as the native core."""
    contigs = [("fallback_short", _genome(15, 12, 0.5, 0.5)),
               ("fallback_masked", _with_n_runs(_genome(16, 10, 0.9, 0.7), 16, [80]))]
    native = _calls(ScanFinder(cpus=1, mask=True), contigs, SeqRecord, Seq)
    before = dict(TIMER.counters)
    monkeypatch.setattr(_native, "load", lambda: None)
    python = _calls(ScanFinder(cpus=1, mask=True), contigs, SeqRecord, Seq)
    assert python == native
    assert TIMER.counters.get("orf.select.python", 0) > before.get("orf.select.python", 0)
    assert TIMER.counters.get("orf.select.native", 0) == before.get("orf.select.native", 0)


def test_counters_on_a_self_training_contig():
    seq = _genome(17, 110, 0.7, 0.6)
    assert len(seq) >= scan.SELF_TRAIN_MIN
    codes = [scan._encode(s) for s in (seq, reverse_complement(seq))]
    enumerated = sum(len(scan._find_orfs(c)[0]) for c in codes)
    before = dict(TIMER.counters)
    genes = list(ScanFinder(cpus=1).find_genes([SeqRecord(id="c", seq=Seq(seq))]))
    assert genes
    delta = {k: v - before.get(k, 0) for k, v in TIMER.counters.items()
             if k.startswith("orf.") and v != before.get(k, 0)}
    # one provisional DP a strand, then the fitted model's
    assert delta == {"orf.candidates": enumerated, "orf.select.native": 3}


def _abutting_n(seed):
    """Genes whose start codon directly follows a run of N, and whose stop
    codon directly precedes one: a masked span that only touches a
    candidate leaves it in."""
    rng = numpy.random.default_rng(seed)
    parts = []
    for _ in range(6):
        parts += ["N" * 60, "ATG" + _body(rng, 150, 0.6) + "TAA", "N" * 55, _bases(rng, 300, 0.5)]
    return "".join(parts)


STRAND_CASES = {
    "gc_rich": lambda: _genome(20, 40, 0.92, 0.72),
    "edges_and_n": lambda: _abutting_n(21),
}


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("case", sorted(STRAND_CASES))
def test_candidates_and_scores_match_jax(case, mask):
    """Per strand, the candidate table, its classes and every term of the
    scores equal the JAX package's candidate objects, bit for bit."""
    from gecco_tpu.orf import scan as jax_scan

    seq = STRAND_CASES[case]()
    strands = ((seq, 1), (reverse_complement(seq), -1))
    ours = [scan._StrandData(s, strand, mask) for s, strand in strands]
    theirs = [jax_scan._StrandData(s, strand, mask) for s, strand in strands]
    classes = {None: -1, "ATG": 0, "GTG": 1, "TTG": 2}
    for o, t in zip(ours, theirs):
        assert o.start.tolist() == [c.start for c in t.cands]
        assert o.end.tolist() == [c.end for c in t.cands]
        assert ((o.flags & scan.PARTIAL_BEGIN) != 0).tolist() == [c.partial_begin for c in t.cands]
        assert ((o.flags & scan.PARTIAL_END) != 0).tolist() == [c.partial_end for c in t.cands]
        assert o.codon.tolist() == [classes.get(c.codon, scan._OTHER) for c in t.cands]
        assert o.rbs.tolist() == [c.rbs for c in t.cands]
        assert numpy.array_equal(o.upstream_codes(), t.upstream_codes())
        assert numpy.array_equal(
            ScanFinder._static_start_bonus(o),
            [jax_scan.ScanFinder._static_start_bonus(c) for c in t.cands])
    assert any(len(o) for o in ours)

    finder, jax_finder = ScanFinder(), jax_scan.ScanFinder()
    lo = ScanFinder._positional_log_odds(ours)
    assert numpy.array_equal(lo, jax_scan.ScanFinder._positional_log_odds(theirs))
    for o, t in zip(ours, theirs):
        assert numpy.array_equal(ScanFinder._positional_scores(o, lo),
                                 jax_scan.ScanFinder._positional_scores(t, lo))
    for (_, m, _), (_, jm, _) in zip(finder._preset_models(), jax_finder._preset_models()):
        for o, t in zip(ours, theirs):
            assert numpy.array_equal(m.start_bonus_batch(o), jm.start_bonus_batch(t))
            assert numpy.array_equal(finder._score_batch(o, m.log_odds),
                                     jax_finder._score_batch(t.codes, t.cands, jm.log_odds))
    fitted, jax_fitted = finder._fit_model(ours), jax_finder._fit_model(theirs)
    assert numpy.array_equal(fitted.log_odds, jax_fitted.log_odds)
    assert fitted.codon_lo.tolist() == [jax_fitted.codon_lo.get(c, -2.0)
                                        for c in ("ATG", "GTG", "TTG", "other")]
    assert numpy.array_equal(fitted.rbs_lo, jax_fitted.rbs_lo)


def test_train_preset_matches_jax():
    from gecco_tpu.orf.presets import train_preset as jax_train_preset
    from gecco_tpu_torch.orf.presets import train_preset

    seq = _genome(22, 30, 0.8, 0.65)
    genes = [(g.start, g.end, 1 if g.strand.sign == "+" else -1)
             for g in JaxScanFinder(cpus=1).find_genes([JaxSeqRecord(id="g", seq=JaxSeq(seq))])]
    # an annotation may name genes that are no candidate, or lie off the contig
    genes += [(5, 400, 1), (len(seq) - 300, len(seq) + 9, 1)]
    ours = train_preset(seq, genes, name="p")
    theirs = jax_train_preset(seq, genes, name="p")
    assert len(genes) > 10
    for field in ("log_odds", "codon_lo", "rbs_lo", "upstream_lo"):
        assert numpy.array_equal(getattr(ours, field), getattr(theirs, field)), field
    assert ours.gc == theirs.gc
    # the same genes as an array
    again = train_preset(seq, numpy.array(genes), name="p")
    assert all(numpy.array_equal(getattr(again, f), getattr(ours, f))
               for f in ("log_odds", "codon_lo", "rbs_lo", "upstream_lo"))


# -- the native core against its Python twins -------------------------------


def _annotate_by_strings(seq, starts, flags):
    """Each candidate's codon class and RBS bin, by string slices and ``in``."""
    codon, rbs = [], []
    for s, f in zip(starts.tolist(), flags.tolist()):
        codon.append(-1 if f & scan.PARTIAL_BEGIN
                     else {"ATG": 0, "GTG": 1, "TTG": 2}.get(seq[s : s + 3], scan._OTHER))
        window = seq[max(0, s - 15) : max(0, s - 4)]
        rbs.append(next((b for b, m in enumerate(scan._RBS_MOTIFS) if m in window), -1))
    return numpy.array(codon, dtype=numpy.int8), numpy.array(rbs, dtype=numpy.int8)


ANNOTATE_CASES = {
    # several motifs in one window: list order decides, not the leftmost match
    "several_motifs": ("CCGAGGCAGGAGGTTTTATGAAACCC", [17, 18, 0, 3], [0, 0, 2, 0]),
    "leftmost_is_later_motif": ("GAGGTAGGAGTTTTTATGCCC", [15], [0]),
    # window clamped at the contig begin, and a motif flush with its far end
    "contig_begin": ("AGGAGGATGCCCTTGAAAAGGAGGCCCCGTGAAA", [0, 3, 6, 12, 28, 29], [2, 0, 0, 0, 0, 0]),
    # a candidate ending at the contig end; N in the window hides a motif
    "contig_end_and_n": ("TTAGGNGGTTTTTGTGCGAGGNNNNNTTGTAA", [13, 26, 29], [4, 0, 4]),
    "other_codon": ("AGGAGGAAAAAACCCGGG", [12, 15], [0, 0]),
    "empty": ("ACGT", [], []),
}


@pytest.mark.parametrize("case", sorted(ANNOTATE_CASES))
def test_annotate_native_and_twin_agree(case):
    seq, starts, flags = ANNOTATE_CASES[case]
    codes = scan._encode(seq)
    starts = numpy.array(starts, dtype=numpy.int32)
    flags = numpy.array(flags, dtype=numpy.uint8)
    expected = _annotate_by_strings(seq, starts, flags)
    native = _native.native_annotate(codes, starts, flags)
    twin = scan._annotate_python(codes, starts, flags)
    assert native is not None
    for got in (native, twin):
        assert got[0].dtype == got[1].dtype == numpy.int8
        assert got[0].tolist() == expected[0].tolist()
        assert got[1].tolist() == expected[1].tolist()


def test_annotate_native_and_twin_agree_on_a_genome():
    seq = _with_n_runs(_genome(18, 60, 0.8, 0.65), 18, [55, 3, 8])
    for strand_seq in (seq, reverse_complement(seq)):
        codes = scan._encode(strand_seq)
        starts, _, flags = scan._find_orfs(codes)
        expected = _annotate_by_strings(strand_seq, starts, flags)
        for got in (_native.native_annotate(codes, starts, flags),
                    scan._annotate_python(codes, starts, flags)):
            assert numpy.array_equal(got[0], expected[0])
            assert numpy.array_equal(got[1], expected[1])
        assert (expected[1] >= 0).any() and (expected[0] == -1).any()


def _select_table(seed, n, length=20_000):
    rng = numpy.random.default_rng(seed)
    start = rng.integers(0, length - 90, size=n)
    # ends rounded up to a hundred: many candidates share an end
    end = numpy.minimum((start + rng.integers(90, 3000, size=n) + 99) // 100 * 100, length)
    # coarse scores: many exact ties, in scores and in totals
    scores = numpy.round(rng.normal(30, 15, size=n) * 2) / 2
    # both contig edges
    start[:3], end[-3:] = 0, length
    return start.astype(numpy.int32), end.astype(numpy.int32), scores


SELECT_CASES = {
    "random": _select_table(19, 4000),
    "ties": (numpy.array([0, 0, 100, 100, 200, 5], dtype=numpy.int32),
             numpy.array([150, 150, 300, 300, 400, 150], dtype=numpy.int32),
             numpy.array([30.0, 30.0, 30.0, 30.0, 60.0, 30.0])),
    # identical candidates: the traceback takes the last in the stable order
    "identical": (numpy.array([0] * 40 + [400] * 40, dtype=numpy.int32),
                  numpy.array([300] * 40 + [700] * 40, dtype=numpy.int32),
                  numpy.full(80, 25.0)),
    "equal_ends": (numpy.array([0, 10, 20, 30, 130], dtype=numpy.int32),
                   numpy.array([100, 100, 100, 100, 400], dtype=numpy.int32),
                   numpy.array([40.0, 45.0, 45.0, 23.0, 50.0])),
    "overlap_limit": (numpy.array([0, 70, 71, 200], dtype=numpy.int32),
                      numpy.array([100, 300, 301, 500], dtype=numpy.int32),
                      numpy.array([25.0, 25.0, 26.0, 24.0])),
    "below_floor": (numpy.array([0, 50], dtype=numpy.int32),
                    numpy.array([90, 200], dtype=numpy.int32),
                    numpy.array([22.0, -5.0])),
    "empty": (numpy.zeros(0, dtype=numpy.int32), numpy.zeros(0, dtype=numpy.int32),
              numpy.zeros(0)),
}


def _select_by_objects(start, end, scores, floor, max_overlap):
    """The JAX package's object DP on the same table, as indices."""
    from gecco_tpu.orf import scan as jax_scan

    cands = [jax_scan._Candidate(s, e, 1, score=v)
             for s, e, v in zip(start.tolist(), end.tolist(), scores.tolist())]
    index = {id(c): i for i, c in enumerate(cands)}
    assert max_overlap == jax_scan.MAX_OVERLAP
    return [index[id(c)] for c in jax_scan.ScanFinder._select(cands, floor=floor)]


@pytest.mark.parametrize("floor", [scan.MIN_SCORE, scan.POS_MIN_SCORE])
@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_select_native_and_twin_agree(case, floor):
    start, end, scores = SELECT_CASES[case]
    expected = _select_by_objects(start, end, scores, floor, scan.MAX_OVERLAP)
    native = _native.native_select(start, end, scores, floor, scan.MAX_OVERLAP)
    twin = scan._select_python(start, end, scores, floor, scan.MAX_OVERLAP)
    assert native is not None
    assert native.tolist() == expected
    assert twin.tolist() == expected
