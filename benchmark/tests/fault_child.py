"""``benchmark.child`` with the timed path broken underneath, for the fault
tests: ``GECCO_BENCH_FAULT`` names the fault.

* ``pvalue``: every domain's p-value altered where the search produces it;
* ``half``: half of the proteins left out of the search;
* ``crf``: every gene's probability altered where the CRF produces it;
* ``crf_half``: half of the genes left out where the CRF returns them;
* ``genes``: every other gene left out where gene calling produces them;
* ``shift``: every gene's last codon cut off where gene calling produces it.
"""

import os
import sys

from benchmark import child


def _patch(fault: str) -> None:
    if fault in ("pvalue", "half"):
        from gecco_tpu_torch.hmm.pipeline import SearchPipeline

        search = SearchPipeline.search

        def broken(self, sequences):
            if fault == "half":
                return search(self, list(sequences)[: len(sequences) // 2])
            hits = search(self, sequences)
            for hit in hits:
                for dom in hit.domains:
                    dom.pvalue *= 10.0
            return hits

        SearchPipeline.search = broken
    elif fault in ("crf", "crf_half"):
        from gecco_tpu_torch.crf import ClusterCRF

        predict = ClusterCRF.predict_probabilities

        def broken(self, genes, **kwargs):
            genes = predict(self, genes, **kwargs)
            if fault == "crf_half":
                return genes[: len(genes) // 2]
            return [g.with_probability(0.9 * (g.average_probability or 0.0) + 0.05) for g in genes]

        ClusterCRF.predict_probabilities = broken
    elif fault in ("genes", "shift"):
        from gecco_tpu_torch.model import Gene
        from gecco_tpu_torch.orf.scan import ScanFinder

        find = ScanFinder.find_genes

        def broken(self, *args, **kwargs):
            genes = list(find(self, *args, **kwargs))
            if fault == "genes":
                return genes[::2]
            return [Gene(g.source, g.start, g.end - 3, g.strand, g.protein, g.qualifiers)
                    if g.strand.sign == "+" else
                    Gene(g.source, g.start + 3, g.end, g.strand, g.protein, g.qualifiers)
                    for g in genes]

        ScanFinder.find_genes = broken
    else:
        raise ValueError(f"unknown fault {fault!r}")


if __name__ == "__main__":
    _patch(os.environ["GECCO_BENCH_FAULT"])
    sys.exit(child.main())
