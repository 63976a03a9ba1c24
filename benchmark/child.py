"""One call of the benchmark: ``gecco_tpu_torch.cli.main(argv)`` in a process
of its own, as ``python -m gecco_tpu_torch <argv>`` runs it.

    python -m benchmark.child RECORD.json ARGV...

After the call it writes ``RECORD.json``: the exit code, the stage spans
(``profiling.TIMER.records``, each with the wall-clock time it ended at),
the kernel launches the program counted (``_build.launches``), the top-level
names of every loaded module, ``torch.cuda.is_available()`` and
``torch.cuda.device_count()``, the card's name and its peak of allocated
memory when the call used a card, and the wall-clock times (seconds since
the epoch) around the call.
"""

import json
import sys
import time


class _Stamped(list):
    """The timer's record list, noting when each span was appended (its end)."""

    def __init__(self) -> None:
        super().__init__()
        self.ends = []

    def append(self, item) -> None:
        super().append(item)
        self.ends.append(time.time())

    def clear(self) -> None:
        super().clear()
        self.ends.clear()


def main() -> int:
    record_path, argv = sys.argv[1], sys.argv[2:]
    from gecco_tpu_torch.cli import main as cli_main
    from gecco_tpu_torch.profiling import TIMER

    TIMER.records = _Stamped()
    began = time.time()
    code = cli_main(argv)
    ended = time.time()
    record = {
        "code": code,
        "spans": [[name, seconds, end] for (name, seconds), end
                  in zip(TIMER.records, TIMER.records.ends)],
        "modules": sorted({name.split(".")[0] for name in sys.modules}),
        "began": began,
        "ended": ended,
    }
    build = sys.modules.get("gecco_tpu_torch._build")
    if build is not None:
        record["launches"] = dict(build.launches)
    torch = sys.modules.get("torch")
    if torch is not None:
        record["cuda"] = [torch.cuda.is_available(), torch.cuda.device_count()]
    if torch is not None and torch.cuda.is_initialized():
        record["device"] = torch.cuda.get_device_name()
        record["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    with open(record_path, "w") as f:
        json.dump(record, f)
    return code


if __name__ == "__main__":
    sys.exit(main())
