"""Cross-validation splitters for CRF training.

Behavioral reference: ``gecco/crf/cv.py:16-94`` —
multi-label Leave-One-Group-Out where hybrid samples (more than one
label) are excluded from the test side of every fold and from the
train side of their own labels' folds.
"""

from typing import Any, Iterable, Iterator, List, Set, Tuple

import numpy

__all__ = ["LeaveOneGroupOut", "kfold"]


class LeaveOneGroupOut:
    """Leave-one-group-out over multi-label groups.

    Example:
        >>> loto = LeaveOneGroupOut()
        >>> groups = [["a"], ["b"], ["c"], ["a", "b"]]
        >>> [(trn.tolist(), tst.tolist()) for trn, tst in loto.split(range(4), groups=groups)]
        [([1, 2], [0]), ([0, 2], [1]), ([0, 1, 3], [2])]

    """

    def get_n_splits(self, X: object = None, y: object = None, groups: Any = None) -> int:
        """Number of folds = number of unique labels.

        Example:
            >>> LeaveOneGroupOut().get_n_splits(groups=[["Terpene"], ["NRP"], ["RiPP"], ["Terpene", "NRP"]])
            3

        """
        if groups is None:
            raise ValueError("The 'groups' parameter should not be None")
        return len({label for labels in groups for label in labels})

    def split(
        self, X: Any, y: Any = None, groups: Any = None
    ) -> Iterator[Tuple["numpy.ndarray", "numpy.ndarray"]]:
        if groups is None:
            raise ValueError("The 'groups' parameter should not be None")
        group_lists: List[List[object]] = [list(g) for g in groups]
        unique = {label for labels in group_lists for label in labels}
        indices = numpy.arange(len(list(X)))
        for label in sorted(unique):  # type: ignore[type-var]
            test_mask = numpy.array([g == [label] for g in group_lists])
            train_mask = numpy.array([label not in g for g in group_lists])
            yield indices[train_mask], indices[test_mask]


def kfold(n: int, k: int = 10, seed: int = 42) -> Iterator[Tuple["numpy.ndarray", "numpy.ndarray"]]:
    """Plain shuffled k-fold split over ``n`` samples."""
    rng = numpy.random.default_rng(seed)
    order = rng.permutation(n)
    folds = numpy.array_split(order, k)
    for i in range(k):
        test = numpy.sort(folds[i])
        train = numpy.sort(numpy.concatenate([folds[j] for j in range(k) if j != i]))
        yield train, test
