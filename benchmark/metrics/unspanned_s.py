"""CLI and process start: a call's wall less the union of the program's
root spans, the time no span of the tree covers (the interpreter before
the package's import, argument parsing, the exit and the CUDA context's
teardown, and whatever runs between the root spans)."""

from ._tree import covered, trees


def read(run):
    values = [call.wall - covered((s["start_ns"], s["end_ns"]) for s in tree["spans"]
                                  if s["parent"] is None) / 1e9
              for call, tree in trees(run)]
    return sum(values) / len(values) if values else None
