"""Console logging for the CLI (two verbosity tiers, quietable).

Behavioral reference: ``gecco/cli/_log.py`` — a concise
logger by default, a full logger (timestamp/host/pid) at ``-vv``,
``warnings.showwarning`` redirected into the logger.  Implemented
without the rich dependency.
"""

import datetime
import os
import socket
import sys
from typing import Any, Optional, TextIO

__all__ = ["ConsoleLogger", "make_logger"]


class ConsoleLogger:
    """Leveled logger writing to a text stream."""

    def __init__(self, stream: Optional[TextIO] = None, verbosity: int = 0, full: bool = False) -> None:
        self.stream = stream if stream is not None else sys.stderr
        self.verbosity = verbosity
        self.full = full

    def _emit(self, kind: str, *message: Any, level: int = 0) -> None:
        if level > self.verbosity:
            return
        text = " ".join(str(part) for part in message)
        if self.full:
            stamp = datetime.datetime.now().isoformat(timespec="seconds")
            prefix = f"{stamp} {socket.gethostname()} {os.getpid()} {kind:<8}"
        else:
            prefix = f"{kind:<8}"
        print(f"{prefix} {text}", file=self.stream)

    def info(self, *message: Any, level: int = 0) -> None:
        self._emit("INFO", *message, level=level)

    def success(self, *message: Any, level: int = 0) -> None:
        self._emit("OK", *message, level=level)

    def warn(self, *message: Any, level: int = 0) -> None:
        self._emit("WARN", *message, level=level)

    def error(self, *message: Any, level: int = 0) -> None:
        self._emit("FAIL", *message, level=level)

    def showwarnings(self, message, category, filename, lineno, file=None, line=None) -> None:
        self.warn(f"{category.__name__}: {message}")


def make_logger(stream: Optional[TextIO], verbosity: int, quiet: int) -> ConsoleLogger:
    effective = -1 if quiet else verbosity
    return ConsoleLogger(stream, verbosity=effective, full=verbosity >= 2)
