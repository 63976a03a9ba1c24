"""Gene cluster probabilities with the linear-chain CRF, decoded in PyTorch.

Port of ``gecco_tpu.crf.ClusterCRF.predict_probabilities``: model
loading, weights, features and the window/padding/max-pooling contract
are inherited unchanged; window batches of ``_TORCH_BATCH_THRESHOLD``
or more (where the JAX package used ``marginals_jax``) are decoded by
:func:`~gecco_tpu_torch.crf.decode.marginals_torch` on the given
device, smaller ones by the same float64 host engine as the JAX package.
"""

import itertools
import operator
import warnings
from typing import Callable, Dict, Iterable, List, Optional

import numpy

from gecco_tpu._meta import sliding_window
from gecco_tpu.crf import ClusterCRF as _JaxClusterCRF
from gecco_tpu.crf import NotFittedError
from gecco_tpu.crf import features as _features
from gecco_tpu.crf.decode import marginals_numpy
from gecco_tpu.model import Gene

from .decode import marginals_torch

__all__ = ["ClusterCRF", "NotFittedError"]

#: window batches at least this large are decoded on the device
_TORCH_BATCH_THRESHOLD = 512


class ClusterCRF(_JaxClusterCRF):
    """A linear-chain CRF whose batch decode runs on a torch device."""

    def predict_probabilities(
        self,
        genes: Iterable[Gene],
        *,
        device,
        pad: bool = True,
        batch_decode: Optional[bool] = None,
        progress: Optional[Callable[[int, int], None]] = None,
    ) -> List[Gene]:
        """Predict the probability of each gene being inside a cluster.

        Same contract as ``gecco_tpu.crf.ClusterCRF.predict_probabilities``;
        ``batch_decode`` forces (True) or forbids (False) the device decode.
        """
        _progress = progress or (lambda x, y: None)
        if not self.fitted:
            raise NotFittedError("This ClusterCRF instance is not fitted yet.")

        if self.feature_type == "protein":
            extract_features = _features.extract_features_protein
            annotate = _features.annotate_probabilities_protein
        else:
            extract_features = _features.extract_features_domain
            annotate = _features.annotate_probabilities_domain

        genes = sorted(genes, key=operator.attrgetter("source.id", "start"))
        for gene in genes:
            gene.protein.domains.sort(key=operator.attrgetter("start"))

        contigs: Dict[str, List[Gene]] = {}
        for contig_id, group in itertools.groupby(genes, key=operator.attrgetter("source.id")):
            contigs[contig_id] = list(group)

        window, step = self.window_size, self.window_step
        chains: Dict[str, "numpy.ndarray"] = {}
        deltas: Dict[str, int] = {}
        for contig_id, contig in contigs.items():
            feats = extract_features(contig)
            deltas[contig_id] = 0
            if len(feats) < window:
                if pad:
                    unit = self.feature_type if window - len(feats) == 1 else f"{self.feature_type}s"
                    warnings.warn(
                        f"Contig {contig[0].source.id!r} does not contain enough"
                        f" {self.feature_type}s ({len(contig)}) for sliding window"
                        f" of size {window}, padding with"
                        f" {window - len(feats)} {unit}"
                    )
                    delta = window - len(feats)
                    deltas[contig_id] = delta
                    feats = [{}] * (delta // 2) + feats + [{}] * ((delta + 1) // 2)
                else:
                    warnings.warn(
                        f"Contig {contig[0].source.id!r} does not contain enough"
                        f" {self.feature_type}s ({len(contig)}) for sliding window"
                        f" of size {window}"
                    )
                    continue
            chains[contig_id] = self._emissions(feats)

        spans: List[tuple] = []  # (contig_id, start)
        batches: List["numpy.ndarray"] = []
        for contig_id, emissions in chains.items():
            for win in sliding_window(len(emissions), window, step):
                spans.append((contig_id, win.start))
                batches.append(emissions[win])
        total = len(spans)
        _progress(0, total)

        if total:
            stacked = numpy.stack(batches)
            on_device = batch_decode if batch_decode is not None else (
                total >= _TORCH_BATCH_THRESHOLD)
            if on_device:
                marginals = marginals_torch(stacked, self.trans, device=device)
                marginals = marginals.cpu().numpy().astype(numpy.float64)
            else:
                marginals = marginals_numpy(stacked, self.trans)
            positive = marginals[:, :, self._positive]
        else:
            positive = numpy.zeros((0, window))

        pooled: Dict[str, "numpy.ndarray"] = {
            contig_id: numpy.zeros(len(emissions)) for contig_id, emissions in chains.items()
        }
        for b, (contig_id, start) in enumerate(spans):
            segment = pooled[contig_id][start : start + window]
            numpy.maximum(segment, positive[b], out=segment)
            _progress(b + 1, total)

        predicted: List[Gene] = []
        for contig_id, contig in contigs.items():
            if contig_id not in chains:
                predicted.extend(contig)
                continue
            probabilities = pooled[contig_id][deltas[contig_id] // 2 :]
            count = len(contig) if self.feature_type == "protein" else len(probabilities)
            predicted.extend(annotate(contig, probabilities[:count]))

        return [
            gene.with_protein(
                gene.protein.with_domains(
                    domain.with_cluster_weight(self.state_weight(domain.name, "1"))
                    for domain in gene.protein.domains
                )
            )
            for gene in predicted
        ]
