"""Plain reference of the CRF decode, cluster refinement and type prediction.

The embedded model is a copy of the shipped one (``data/crf_model.npz``:
the state and transition weights of GECCO's linear-chain CRF in protein
mode, window 20, step 1; ``data/forest.npz``: the type classifier's trees),
stored without pickled objects.  Semantics are GECCO's
(``gecco/crf/__init__.py``, ``gecco/refine.py``, ``gecco/types``): one
feature set per gene (the names of its domains), contigs shorter than the
window padded with empty genes (half before, the rest after), the marginal
of label "1" over every window, max-pooled per gene; clusters are runs of
genes over the threshold, trimmed of unannotated edge genes and kept with at
least ``cds`` annotated genes; a cluster's type is every class whose forest
probability exceeds 0.5 over its domain composition (``1 - p-value`` per
domain, L1-normalised).

The marginals are a scaled forward-backward in log space, float64 (the port
decodes in probability space, CRFsuite's form); ``hmm.Arithmetic`` rounds
every stored row for the control.
"""

import os
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy

from .hmm import Arithmetic

HERE = os.path.dirname(os.path.abspath(__file__))


class Gene(NamedTuple):
    contig: str
    protein_id: str
    start: int
    end: int
    domains: Tuple[Tuple[str, float], ...]   # (accession, p-value), sorted by position


class Cluster(NamedTuple):
    contig: str
    cluster_id: str
    start: int
    end: int
    type: str
    probabilities: Dict[str, float]


class Model:
    def __init__(self) -> None:
        crf = numpy.load(os.path.join(HERE, "data", "crf_model.npz"))
        self.index = {str(a): i for i, a in enumerate(crf["attr_names"])}
        self.state = crf["state"]
        self.trans = crf["trans"]
        self.window = int(crf["window_size"])
        self.step = int(crf["window_step"])
        self.positive = [str(x) for x in crf["label_names"]].index("1")
        forest = numpy.load(os.path.join(HERE, "data", "forest.npz"))
        self.forest = {k: forest[k] for k in forest.files}
        self.classes = [str(x) for x in forest["classes"]]
        self.domains = [str(x) for x in forest["domains"]]

    def probabilities(self, genes: Sequence[Gene], q: Arithmetic) -> Dict[str, float]:
        """Each gene's probability of lying in a cluster, by protein id."""
        contigs: Dict[str, List[Gene]] = {}
        for g in sorted(genes, key=lambda g: (g.contig, g.start)):
            contigs.setdefault(g.contig, []).append(g)
        out: Dict[str, float] = {}
        for contig in contigs.values():
            emissions = numpy.zeros((len(contig), self.state.shape[1]))
            for t, g in enumerate(contig):
                for name in {name for name, _ in g.domains}:
                    i = self.index.get(name)
                    if i is not None:
                        emissions[t] += self.state[i]
            delta = max(0, self.window - len(contig))
            emissions = numpy.concatenate([
                numpy.zeros((delta // 2, emissions.shape[1])), emissions,
                numpy.zeros(((delta + 1) // 2, emissions.shape[1]))])
            starts = range(0, len(emissions) - self.window + 1, self.step)
            windows = numpy.stack([emissions[s : s + self.window] for s in starts])
            marginal = _marginals(windows, self.trans, q)[:, :, self.positive]
            pooled = numpy.zeros(len(emissions))
            for b, s in enumerate(starts):
                pooled[s : s + self.window] = numpy.maximum(pooled[s : s + self.window], marginal[b])
            for g, p in zip(contig, pooled[delta // 2 :]):
                out[g.protein_id] = float(p)
        return out

    def clusters(self, genes: Sequence[Gene], probability: Dict[str, float], *,
                 threshold: float = 0.8, cds: int = 3) -> List[Cluster]:
        out = []
        by_contig: Dict[str, List[Gene]] = {}
        for g in sorted(genes, key=lambda g: (g.contig, g.start, g.end)):
            by_contig.setdefault(g.contig, []).append(g)
        for contig, ordered in sorted(by_contig.items()):
            runs, run = [], []
            for g in ordered + [None]:
                if g is not None and probability[g.protein_id] > threshold:
                    run.append(g)
                elif run:
                    runs.append(run)
                    run = []
            for i, run in enumerate(runs):
                while run and not run[0].domains:
                    run = run[1:]
                while run and not run[-1].domains:
                    run = run[:-1]
                if sum(1 for g in run if g.domains) < cds:
                    continue
                kind, probabilities = self.type_of(run)
                out.append(Cluster(contig, f"{contig}_cluster_{i + 1}",
                                   min(g.start for g in run), max(g.end for g in run),
                                   kind, probabilities))
        return out

    def type_of(self, genes: Sequence[Gene]) -> Tuple[str, Dict[str, float]]:
        totals: Dict[str, float] = {}
        for g in genes:
            for name, pvalue in g.domains:
                totals[name] = totals.get(name, 0.0) + (1.0 - pvalue)
        x = numpy.array([totals.get(name, 0.0) for name in self.domains])
        x = (x / (x.sum() or 1.0)).astype(numpy.float32)
        f = self.forest
        offsets = f["tree_offsets"]
        total = numpy.zeros(f["value"].shape[1])
        for t in range(len(offsets) - 1):
            node = int(offsets[t])
            while f["children_left"][node] != -1:
                if x[f["feature"][node]] <= f["threshold"][node]:
                    node = int(f["children_left"][node])
                else:
                    node = int(f["children_right"][node])
            total += f["value"][node]
        positive = 1.0 - total / (len(offsets) - 1)
        names = sorted(c for c, p in zip(self.classes, positive) if p > 0.5)
        return (";".join(names) or "Unknown"), dict(zip(self.classes, positive.tolist()))


def _marginals(windows: "numpy.ndarray", trans: "numpy.ndarray", q: Arithmetic) -> "numpy.ndarray":
    """Posterior marginals ``[B, W, L]`` of a linear-chain CRF: forward and
    backward in log space, each step normalised by the forward step's
    log-sum (the scaled recursion), so every stored row stays near 0."""
    B, W, L = windows.shape
    e, t = q(windows), q(trans)
    lse = numpy.logaddexp.reduce
    alpha = numpy.empty((B, W, L))
    beta = numpy.empty((B, W, L))
    scale = numpy.empty((B, W))
    a = e[:, 0]
    for i in range(W):
        if i:
            a = e[:, i] + lse(alpha[:, i - 1, :, None] + t[None], axis=1)
        scale[:, i] = lse(a, axis=1)
        alpha[:, i] = q(a - scale[:, i, None])
    beta[:, W - 1] = 0.0
    for i in range(W - 2, -1, -1):
        b = lse(t[None] + (e[:, i + 1] + beta[:, i + 1])[:, None, :], axis=2)
        beta[:, i] = q(b - scale[:, i + 1, None])
    return q(numpy.exp(alpha + beta))
