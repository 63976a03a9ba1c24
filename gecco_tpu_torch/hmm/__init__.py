"""Domain annotation of proteins with profile HMM libraries, on PyTorch.

Port of ``gecco_tpu.hmm``: the ``HMM`` library descriptor, the
``DomainAnnotator`` base, ``embedded_hmms`` and the library loading,
whitelist and relabelling of ``ProfileHMMAnnotator`` are copied as
they are; the search runs on
:class:`gecco_tpu_torch.hmm.pipeline.SearchPipeline` on an explicit
device, with the JAX annotator's ``use_accelerator``, ``backend`` and
``devices`` passed on.
"""

import abc
import configparser
import os
import re
import typing
from typing import Any, Callable, Container, Dict, Iterable, Iterator, List, Optional

from .._meta import UniversalContainer
from ..interpro import InterPro
from ..model import Domain, Gene
from ..profiling import TIMER
from .io import encode_sequence, parse_hmmer3
from .pipeline import SearchPipeline
from .profile import SearchProfile, configure_local

__all__ = ["HMM", "DomainAnnotator", "ProfileHMMAnnotator", "embedded_hmms"]

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")


class HMM(typing.NamedTuple):
    """A profile HMM library descriptor (mirrors the reference ``HMM``)."""

    id: str
    version: str
    url: str
    path: str
    size: Optional[int] = None
    relabel_with: Optional[str] = None
    md5: Optional[str] = None

    def relabel(self, domain: str) -> str:
        """Apply the ``s/regex/replacement/`` accession rewrite, if any."""
        if self.relabel_with is None:
            return domain
        match = re.match("^s/(.*)/(.*)/$", self.relabel_with)
        if match is None:
            raise ValueError(f"invalid relabel pattern: {self.relabel_with!r}")
        before, after = match.groups()
        return re.sub(before, after, domain)


class DomainAnnotator(metaclass=abc.ABCMeta):
    """An abstract annotator of genes with protein domains."""

    def __init__(
        self,
        hmm: HMM,
        cpus: Optional[int] = None,
        whitelist: Optional[Container[str]] = None,
    ) -> None:
        super().__init__()
        self.hmm = hmm
        self.cpus = cpus
        self.whitelist = UniversalContainer() if whitelist is None else whitelist

    @abc.abstractmethod
    def run(self, genes: Iterable[Gene]) -> List[Gene]:
        """Annotate the proteins of ``genes`` in place and return them."""
        return NotImplemented


class ProfileHMMAnnotator(DomainAnnotator):
    """Annotates genes by searching the library with the port's pipeline."""

    def __init__(
        self,
        hmm: HMM,
        cpus: Optional[int] = None,
        whitelist: Optional[Container[str]] = None,
        use_accelerator: bool = True,
        backend: str = "auto",
        devices=None,
        *,
        device,
    ) -> None:
        super().__init__(hmm, cpus=cpus, whitelist=whitelist)
        self.use_accelerator = use_accelerator
        self.backend = backend
        self.devices = devices
        self.device = device
        self._profiles: Optional[List[SearchProfile]] = None

    def _load_profiles(self) -> List[SearchProfile]:
        if self._profiles is None:
            with TIMER.span("read-profiles"):
                raws = [
                    raw for raw in parse_hmmer3(self.hmm.path)
                    if raw.accession is None
                    or self.hmm.relabel(raw.accession) in self.whitelist
                ]
            with TIMER.span("configure-profiles"):
                self._profiles = [configure_local(raw) for raw in raws]
        return self._profiles

    def run(
        self,
        genes: Iterable[Gene],
        progress: Optional[Callable[[SearchProfile, int], None]] = None,
        bit_cutoffs: Optional[str] = None,
    ) -> List[Gene]:
        gene_index = list(genes)
        with TIMER.span("encode-sequences"):
            sequences = [encode_sequence(str(g.protein.seq)) for g in gene_index]
        pipeline = SearchPipeline(
            self._load_profiles(),
            device=self.device,
            Z=self.hmm.size,
            domZ=self.hmm.size,
            bit_cutoffs=bit_cutoffs,
            use_accelerator=self.use_accelerator,
            backend=self.backend,
            devices=self.devices,
        )
        hits = pipeline.search(sequences)
        with TIMER.span("report-hits"):
            self._report(gene_index, hits)
        for key, value in pipeline.stage_counts.items():
            TIMER.count(f"funnel.{key}", value)
        TIMER.count("host_pairs", pipeline.host_pairs)
        return gene_index

    def _report(self, gene_index: List[Gene], hits) -> None:
        """Append each reported domain to its gene's protein."""
        interpro = InterPro.load()
        for hit in hits:
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


def embedded_hmms(directory: Optional[str] = None) -> Iterator[HMM]:
    """Discover embedded HMM libraries described by ``*.ini`` sidecars.

    Each ``NAME.ini`` must sit next to a ``NAME.hmm`` (HMMER3 ASCII,
    possibly gzipped as ``NAME.hmm.gz``) or a pressed binary
    ``NAME.h3m`` — the layout the reference ships
    (``setup.py:344-372``), so a reference-built data
    directory drops in directly; ``io.parse_hmmer3`` handles both
    formats.
    """
    directory = directory or _DATA_DIR
    for filename in sorted(os.listdir(directory)):
        if not filename.endswith(".ini"):
            continue
        cfg = configparser.ConfigParser()
        cfg.read(os.path.join(directory, filename))
        args: Dict[str, Any] = dict(cfg.items("hmm"))
        size = int(args.pop("size", 0))
        stem = os.path.join(directory, filename[:-4])
        for suffix in (".hmm", ".hmm.gz", ".h3m", ".h3m.gz"):
            if os.path.exists(stem + suffix):
                yield HMM(path=stem + suffix, size=size, **args)
                break
        else:
            raise FileNotFoundError(
                f"{filename}: no {stem + '.hmm'!r} (or .hmm.gz / .h3m / .h3m.gz) next "
                "to it — build the embedded library with "
                "tools/build_data.py, or pass --hmm with your own HMMER3 "
                "file"
            )
