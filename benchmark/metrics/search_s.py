"""The annotator and search: the search's spans, ``pack-sequences``,
``bias-null`` (the composition-bias null of the F2 and F3 gates, on the
host) and the stages ``filter``, ``viterbi``, ``forward`` and
``domains``."""

from ._tree import mean_spans


def read(run):
    return mean_spans(run, "pack-sequences", "bias-null", "filter", "viterbi", "forward",
                      "domains")
