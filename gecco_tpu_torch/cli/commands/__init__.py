"""The port's CLI command tree and its dependency-injected ``main``.

Port of ``gecco_tpu.cli.commands.main`` with its six subcommands.
``--profile DIR`` wraps the command in a ``torch.profiler`` trace
(:func:`gecco_tpu_torch.profiling.device_trace`) where the JAX CLI takes
an XLA trace; unlike the JAX CLI it sets up no compilation cache.
"""

import argparse
import signal
import warnings
from typing import Callable, Dict, Iterable, Optional, TextIO, Type

from ... import __version__
from .._log import make_logger
from . import _common
from . import annotate, convert, cv, predict, run, train

__all__ = ["configure_parser", "main"]

_COMMANDS = {
    "annotate": (annotate, "Annotate protein features of one or several contigs."),
    "run": (run, "Predict gene clusters from one or several contigs."),
    "predict": (predict, "Predict gene clusters on contigs that have been annotated."),
    "train": (train, "Train a new CRF model on pre-generated tables."),
    "cv": (cv, "Train and evaluate a model using cross-validation."),
    "convert": (convert, "Convert output files to a different format."),
}


def configure_parser(
    program: str, version: str, defaults: Dict[str, object],
) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=program,
        description="Biosynthetic Gene Cluster prediction with Conditional "
                    "Random Fields (PyTorch + CUDA).",
    )
    parser.add_argument("-V", "--version", action="version", version=f"{program} {version}")
    parser.add_argument("-v", "--verbose", action="count", default=0, dest="main_verbose",
                        help="Increase verbosity (-v, -vv).")
    parser.add_argument("-q", "--quiet", action="count", default=0, dest="main_quiet",
                        help="Silence most of the log output.")
    commands = parser.add_subparsers(required=True, metavar="COMMAND", dest="command")
    for name, (module, help_text) in _COMMANDS.items():
        subparser = commands.add_parser(name, help=help_text)
        module.configure_parser(subparser, defaults)
        subparser.set_defaults(run=module.run)
    return parser


def main(
    argv: Optional[Iterable[str]] = None,
    stream: Optional[TextIO] = None,
    *,
    crf_type: Optional[Type] = None,
    classifier_type: Optional[Type] = None,
    default_hmms: Optional[Callable] = None,
    defaults: Optional[Dict[str, object]] = None,
    program: str = "gecco-tpu-torch",
    version: str = __version__,
) -> int:
    """Run the command line interface; returns a POSIX exit code."""
    from ...crf import ClusterCRF
    from ...profiling import TIMER, device_trace
    from ...types import TypeClassifier

    crf_type = crf_type or ClusterCRF
    classifier_type = classifier_type or TypeClassifier
    default_hmms = default_hmms or _common.default_hmms
    parser = configure_parser(program, version, defaults or {})
    if stream is not None:
        def _patch(target: argparse.ArgumentParser) -> None:
            target._print_message = lambda message, file=None: (  # type: ignore[assignment]
                stream.write(message) if message else None
            )
            for action in target._actions:
                if isinstance(action, argparse._SubParsersAction):
                    for sub in action.choices.values():
                        _patch(sub)

        _patch(parser)
    try:
        args = parser.parse_args(list(argv) if argv is not None else None)
    except SystemExit as exit:
        return int(exit.code or 0)

    logger = make_logger(
        stream,
        getattr(args, "verbose", 0) + getattr(args, "main_verbose", 0),
        getattr(args, "quiet", 0) + getattr(args, "main_quiet", 0),
    )
    previous_showwarning = warnings.showwarning
    warnings.showwarning = logger.showwarnings  # type: ignore[assignment]
    try:
        TIMER.reset()
        with device_trace(getattr(args, "profile", None)):
            code = args.run(args, logger, crf_type, classifier_type, default_hmms)
        for name, (calls, total) in TIMER.summary().items():
            logger.info(f"timing: {name}: {total:.3f}s ({calls} calls)", level=2)
        return code
    except KeyboardInterrupt:
        logger.error("Interrupted")
        return -signal.SIGINT
    except OSError as err:
        logger.error("OS error:", err)
        return err.errno or 1
    except Exception as err:  # noqa: BLE001
        logger.error(f"{type(err).__name__}: {err}")
        return 1
    finally:
        warnings.showwarning = previous_showwarning
