"""Gene cluster probabilities with the linear-chain CRF, decoded in PyTorch.

Port of ``gecco_tpu.crf.ClusterCRF``: model loading, weights, features
and the window/padding/max-pooling contract are copied as they are;
window batches of ``_TORCH_BATCH_THRESHOLD`` or more (where the JAX
package used ``marginals_jax``) are decoded by
:func:`~gecco_tpu_torch.crf.decode.marginals_torch` on the given
device, smaller ones by the same float64 host engine as the JAX package
(:func:`~gecco_tpu_torch.crf.decode.marginals_numpy`).  Training is not
ported yet: :meth:`ClusterCRF.fit` raises.
"""

import hashlib
import itertools
import operator
import os
import warnings
from typing import Callable, Dict, FrozenSet, Iterable, List, Optional, Union

import numpy

from .._meta import sliding_window
from ..model import Gene
from . import features as _features
from .decode import marginals_numpy, marginals_torch

__all__ = ["ClusterCRF", "NotFittedError"]

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
_FILENAME = "crf_model.npz"
#: window batches at least this large are decoded on the device
_TORCH_BATCH_THRESHOLD = 512


class NotFittedError(RuntimeError):
    """Raised when predicting with an unfitted `ClusterCRF`."""


class ClusterCRF(object):
    """A linear-chain CRF whose batch decode runs on a torch device."""

    @classmethod
    def trained(cls, model_path: Optional[Union[str, "os.PathLike[str]"]] = None) -> "ClusterCRF":
        """Load a pre-trained model.

        Accepts either this package's native ``crf_model.npz`` directory
        layout (with a ``.sha256`` integrity sidecar), or a *reference*
        GECCO model directory containing ``model.pkl`` (imported through
        `gecco_tpu_torch.crf._crfsuite`).  `None` loads the embedded model.
        """
        directory = _DATA_DIR if model_path is None else os.fspath(model_path)
        npz_path = os.path.join(directory, _FILENAME)
        if os.path.exists(npz_path):
            digest_path = npz_path + ".sha256"
            if os.path.exists(digest_path):
                with open(digest_path) as f:
                    expected = f.read().strip()
                hasher = hashlib.sha256()
                with open(npz_path, "rb") as f:
                    for chunk in iter(lambda: f.read(1 << 20), b""):
                        hasher.update(chunk)
                if hasher.hexdigest() != expected:
                    raise ValueError("SHA256 hash of model data does not match signature")
            payload = numpy.load(npz_path, allow_pickle=True)
            crf = cls(
                feature_type=str(payload["feature_type"]),
                algorithm=str(payload["algorithm"]),
                window_size=int(payload["window_size"]),
                window_step=int(payload["window_step"]),
                c1=float(payload["c1"]),
                c2=float(payload["c2"]),
            )
            crf._set_weights(
                [str(x) for x in payload["attr_names"]],
                [str(x) for x in payload["label_names"]],
                payload["state"].astype(numpy.float64),
                payload["trans"].astype(numpy.float64),
            )
            sig_names = payload["sig_names"]
            if len(sig_names):
                crf.significance = {
                    str(k): float(v)
                    for k, v in zip(sig_names, payload["sig_pvalues"])
                }
            return crf
        pkl_path = os.path.join(directory, "model.pkl")
        if os.path.exists(pkl_path):
            from ._crfsuite import load_reference_pickle

            data = load_reference_pickle(pkl_path)
            crf = cls(
                feature_type=data["feature_type"],
                algorithm=data["algorithm"],
                window_size=data["window_size"],
                window_step=data["window_step"],
                c1=data["c1"],
                c2=data["c2"],
            )
            crf._set_weights(
                data["attr_names"], data["label_names"], data["state"], data["trans"]
            )
            crf.significance = data["significance"] or None
            return crf
        raise FileNotFoundError(f"no CRF model found under {directory!r}")

    def __init__(
        self,
        feature_type: str = "protein",
        algorithm: str = "lbfgs",
        window_size: int = 5,
        window_step: int = 1,
        **options: object,
    ) -> None:
        if feature_type not in {"protein", "domain"}:
            raise ValueError(f"invalid feature type: {feature_type!r}")
        if window_size <= 0:
            raise ValueError("Window size must be strictly positive")
        if window_step <= 0 or window_step > window_size:
            raise ValueError("Window step must be strictly positive and under `window_size`")
        self.feature_type = feature_type
        self.algorithm = algorithm
        self.window_size = window_size
        self.window_step = window_step
        self.significance: Optional[Dict[str, float]] = None
        self.significant_features: Optional[FrozenSet[str]] = None
        self._options = dict(options)
        # fitted weights
        self.attr_names: Optional[List[str]] = None
        self.label_names: Optional[List[str]] = None
        self.state: Optional["numpy.ndarray"] = None   # [A, L]
        self.trans: Optional["numpy.ndarray"] = None   # [L, L]
        self._attr_index: Dict[str, int] = {}
        self._positive: int = 1

    # ------------------------------------------------------------------

    def _set_weights(self, attr_names, label_names, state, trans) -> None:
        self.attr_names = list(attr_names)
        self.label_names = list(label_names)
        self.state = numpy.asarray(state, dtype=numpy.float64)
        self.trans = numpy.asarray(trans, dtype=numpy.float64)
        self._attr_index = {name: i for i, name in enumerate(self.attr_names)}
        self._positive = self.label_names.index("1") if "1" in self.label_names else 1

    @property
    def fitted(self) -> bool:
        return self.state is not None

    def state_weight(self, attr: str, label: str = "1") -> Optional[float]:
        """Weight of a (attribute, label) state feature, `None` if absent.

        Matches ``state_features_.get((domain.name, '1'))`` in the
        reference (``crf/__init__.py:264``): stored CRFsuite features are
        exactly the nonzero ones.
        """
        index = self._attr_index.get(attr)
        if index is None or self.state is None:
            return None
        weight = self.state[index, self.label_names.index(label)]
        return float(weight) if weight != 0.0 else None

    def _emissions(self, feats: List[Dict[str, bool]]) -> "numpy.ndarray":
        """Per-position state scores: sum of known attribute weight rows."""
        assert self.state is not None
        out = numpy.zeros((len(feats), self.state.shape[1]), dtype=numpy.float64)
        index = self._attr_index
        state = self.state
        for t, feat in enumerate(feats):
            for name in feat:
                i = index.get(name)
                if i is not None:
                    out[t] += state[i]
        return out

    # ------------------------------------------------------------------

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

    # ------------------------------------------------------------------

    def fit(self, genes: Iterable[Gene], **options: object) -> None:
        """Not ported yet: CRF training is item 11 of ROADMAP.md Queue 1."""
        raise NotImplementedError(
            "ClusterCRF.fit is not ported to PyTorch yet (ROADMAP.md, Queue 1 "
            "item 11: CRF training); train with the gecco_tpu package")

    def save(self, model_path: Union[str, "os.PathLike[str]"]) -> None:
        """Write ``crf_model.npz`` (+ SHA256 sidecar) into a directory."""
        if not self.fitted:
            raise NotFittedError("cannot save an unfitted model")
        os.makedirs(model_path, exist_ok=True)
        out = os.path.join(os.fspath(model_path), _FILENAME)
        significance = self.significance or {}
        sig_names = numpy.array(sorted(significance), dtype=object)
        numpy.savez_compressed(
            out,
            attr_names=numpy.array(self.attr_names, dtype=object),
            label_names=numpy.array(self.label_names, dtype=object),
            state=self.state,
            trans=self.trans,
            sig_names=sig_names,
            sig_pvalues=numpy.array([significance[k] for k in sig_names], dtype=numpy.float64),
            feature_type=numpy.array(self.feature_type),
            window_size=numpy.array(self.window_size),
            window_step=numpy.array(self.window_step),
            algorithm=numpy.array(self.algorithm),
            c1=numpy.array(float(self._options.get("c1", 0.0))),
            c2=numpy.array(float(self._options.get("c2", 0.0))),
        )
        hasher = hashlib.sha256()
        with open(out, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                hasher.update(chunk)
        with open(out + ".sha256", "w") as f:
            f.write(hasher.hexdigest())
