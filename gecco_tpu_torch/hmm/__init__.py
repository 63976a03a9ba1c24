"""Domain annotation of proteins with profile HMM libraries, on PyTorch.

Port of ``gecco_tpu.hmm.ProfileHMMAnnotator``: the library loading,
whitelist and relabelling are inherited; the search runs on
:class:`gecco_tpu_torch.hmm.pipeline.SearchPipeline` on an explicit
device.
"""

from typing import Callable, Container, Dict, Iterable, List, Optional

from gecco_tpu.hmm import HMM, DomainAnnotator, embedded_hmms
from gecco_tpu.hmm import ProfileHMMAnnotator as _JaxAnnotator
from gecco_tpu.hmm.io import encode_sequence
from gecco_tpu.hmm.profile import SearchProfile
from gecco_tpu.interpro import InterPro
from gecco_tpu.model import Domain, Gene

from .pipeline import SearchPipeline

__all__ = ["HMM", "DomainAnnotator", "ProfileHMMAnnotator", "embedded_hmms"]


class ProfileHMMAnnotator(_JaxAnnotator):
    """Annotates genes by searching the library with the port's pipeline."""

    def __init__(
        self,
        hmm: HMM,
        cpus: Optional[int] = None,
        whitelist: Optional[Container[str]] = None,
        *,
        device,
        backend: str = "cuda",
    ) -> None:
        super().__init__(hmm, cpus=cpus, whitelist=whitelist)
        self.device = device
        self.backend = backend

    def run(
        self,
        genes: Iterable[Gene],
        progress: Optional[Callable[[SearchProfile, int], None]] = None,
        bit_cutoffs: Optional[str] = None,
    ) -> List[Gene]:
        gene_index = list(genes)
        sequences = [encode_sequence(str(g.protein.seq)) for g in gene_index]
        pipeline = SearchPipeline(
            self._load_profiles(),
            device=self.device,
            Z=self.hmm.size,
            domZ=self.hmm.size,
            bit_cutoffs=bit_cutoffs,
            backend=self.backend,
        )
        interpro = InterPro.load()
        for hit in pipeline.search(sequences):
            accession = self.hmm.relabel(hit.profile.accession or hit.profile.name)
            entry = interpro.lookup(accession)
            for dom in hit.domains:
                qualifiers: Dict[str, List[str]] = {
                    "inference": ["protein motif"],
                    "db_xref": ["{}:{}".format(self.hmm.id.upper(), accession)],
                    "note": [
                        "e-value: {}".format(dom.i_evalue),
                        "p-value: {}".format(dom.pvalue),
                    ],
                }
                if entry is not None:
                    qualifiers["function"] = [entry.name]
                    qualifiers["db_xref"].append("InterPro:{}".format(entry.accession))
                    go_terms = entry.go_terms
                    go_functions = entry.go_functions
                else:
                    go_terms = []
                    go_functions = []
                gene_index[hit.sequence_index].protein.domains.append(
                    Domain(
                        accession,
                        dom.target_from,
                        dom.target_to,
                        self.hmm.id,
                        dom.i_evalue,
                        dom.pvalue,
                        go_terms=go_terms,
                        go_functions=go_functions,
                        qualifiers=qualifiers,
                    )
                )
        return gene_index
