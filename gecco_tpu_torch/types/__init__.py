"""Biosynthetic type classification of predicted clusters.

Behavioral reference: ``gecco/types/__init__.py`` —
``TypeClassifier.trained`` re-fits a ``RandomForestClassifier(random_state=0)``
on the embedded MIBiG compositions at every load (:48-92); here the
fitted forest ships frozen as an open asset and inference runs in-package
(``forest.py``).  ``predict_types`` (:114-138): per-cluster weighted
domain composition → positive-class probabilities → threshold 0.5 →
multi-label ``ClusterType``.  ``TypeBinarizer``: ``types/binarizer.py:13-33``.
"""

import os
import typing
from typing import Iterable, List, Optional, Sequence, Union

import numpy

from ..model import Cluster, ClusterType
from .forest import Forest, train_forest

__all__ = ["TypeClassifier", "TypeBinarizer"]

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")


class TypeBinarizer:
    """Multi-label binarizer over `ClusterType` values."""

    def __init__(self, classes: List[str]) -> None:
        self.classes_ = list(classes)

    def transform(self, y: List[ClusterType]) -> "numpy.ndarray":
        matrix = numpy.zeros((len(y), len(self.classes_)))
        for i, label in enumerate(y):
            for j, cls in enumerate(self.classes_):
                matrix[i, j] = cls in label.names
        return matrix

    def inverse_transform(self, yt: "numpy.ndarray") -> List[ClusterType]:
        return [
            ClusterType(*(cls for j, cls in enumerate(self.classes_) if row[j]))
            for row in yt
        ]


class TypeClassifier(object):
    """Predicts the biosynthetic type(s) of clusters with a random forest."""

    @classmethod
    def trained(cls, model_path: Optional[Union[str, "os.PathLike[str]"]] = None) -> "TypeClassifier":
        """Load a trained classifier.

        `None` loads the embedded frozen forest.  A model directory may
        contain either a ``forest.npz`` (this package's ``gecco train``
        output) or the reference trio ``domains.tsv``/``types.tsv``/
        ``compositions.npz``, in which case a forest is trained from that
        data on the fly with the built-in trainer.
        """
        directory = _DATA_DIR if model_path is None else os.fspath(model_path)
        forest_path = os.path.join(directory, "forest.npz")
        if os.path.exists(forest_path):
            forest = Forest.load(forest_path)
        else:
            compositions, y, classes, domains = _load_reference_training_data(directory)
            forest = train_forest(compositions, y, classes, domains)
        classifier = cls(classes=forest.classes)
        classifier.forest = forest
        classifier.attributes_ = forest.domains
        return classifier

    def __init__(self, classes: Iterable[str] = ()) -> None:
        self.binarizer = TypeBinarizer(list(classes))
        self.forest: Optional[Forest] = None
        self.attributes_: List[str] = []

    @property
    def classes_(self) -> List[str]:
        return self.binarizer.classes_

    _S = typing.TypeVar("_S", bound=Sequence["Cluster"])

    def predict_types(self, clusters: "_S") -> "_S":
        """Annotate clusters with predicted types and their probabilities."""
        if self.forest is None:
            raise RuntimeError("this TypeClassifier instance is not fitted yet")
        compositions = numpy.array(
            [c.domain_composition(self.attributes_) for c in clusters]
        )
        if len(compositions) == 0:
            return clusters
        positive = self.forest.predict_proba(compositions)
        types = self.binarizer.inverse_transform(positive > 0.5)
        for cluster, probabilities, ty in zip(clusters, positive, types):
            cluster.type = ty
            cluster.type_probabilities = dict(zip(self.binarizer.classes_, probabilities))
        return clusters

    def fit(
        self,
        compositions: "numpy.ndarray",
        types: List[ClusterType],
        domains: Sequence[str],
        seed: int = 0,
    ) -> "TypeClassifier":
        """Train the forest on composition vectors and multi-label types."""
        classes = sorted({name for ty in types for name in ty.names})
        self.binarizer = TypeBinarizer(classes)
        y = self.binarizer.transform(types)
        self.forest = train_forest(
            numpy.asarray(compositions), y, classes, list(domains), seed=seed
        )
        self.attributes_ = list(domains)
        return self

    def save(self, model_path: Union[str, "os.PathLike[str]"]) -> None:
        if self.forest is None:
            raise RuntimeError("cannot save an unfitted TypeClassifier")
        os.makedirs(model_path, exist_ok=True)
        self.forest.save(os.path.join(os.fspath(model_path), "forest.npz"))


def _load_reference_training_data(directory: str):
    """Read a reference-format model dir (domains/types/compositions)."""
    import scipy.sparse

    compositions = scipy.sparse.load_npz(os.path.join(directory, "compositions.npz")).toarray()
    with open(os.path.join(directory, "domains.tsv")) as f:
        domains = [line.strip() for line in f]
    types: List[set] = []
    unique: set = set()
    with open(os.path.join(directory, "types.tsv")) as f:
        for line in f:
            names = set(filter(None, line.split("\t")[1].strip().split(";")))
            unique.update(names)
            types.append(names)
    classes = sorted(unique)
    y = numpy.zeros((len(types), len(classes)))
    for i, names in enumerate(types):
        for j, cls in enumerate(classes):
            y[i, j] = cls in names
    return compositions, y, classes, domains
