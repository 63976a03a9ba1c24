"""Argument groups of the port's CLI that differ from ``gecco_tpu``'s.

Every other group is ``gecco_tpu.cli.commands._parser``'s own.  The
annotation group replaces ``--backend {auto,pallas,xla}`` and
``--devices`` with an explicit ``--device {cuda,cpu}`` and ``--backend
{cuda,torch}``; the common group has no ``--profile`` (the XLA trace).
"""

import argparse
import pathlib
from typing import Dict

__all__ = ["configure_common", "group_annotation"]


def configure_common(parser: argparse.ArgumentParser, defaults: Dict[str, object]) -> None:
    parser.add_argument(
        "-j", "--jobs", type=int, default=defaults.get("--jobs", 0),
        help="The number of jobs to use for multithreaded host stages (0 = all CPUs).",
    )
    parser.add_argument("-v", "--verbose", action="count", default=0,
                        help="Increase verbosity (-v, -vv).")
    parser.add_argument("-q", "--quiet", action="count", default=0,
                        help="Silence most of the log output.")


def group_annotation(parser, defaults: Dict[str, object]) -> None:
    group = parser.add_argument_group("Domain Annotation")
    group.add_argument("--hmm", dest="hmms", action="append", type=pathlib.Path, default=[],
                       help="Use a custom HMM library file instead of the embedded one (repeatable).")
    group.add_argument("-e", "--e-filter", type=float, default=defaults.get("--e-filter", None),
                       help="Exclude domains with an i-evalue over this value.")
    group.add_argument("-p", "--p-filter", type=float, default=defaults.get("--p-filter", 1e-9),
                       help="Exclude domains with a p-value over this value.")
    group.add_argument("--bit-cutoffs", choices=("noise", "gathering", "trusted"),
                       default=defaults.get("--bit-cutoffs", None),
                       help="Use HMM-specific bit score cutoffs instead of e-value reporting thresholds.")
    group.add_argument("--disentangle", action="store_true",
                       default=defaults.get("--disentangle", False),
                       help="Keep only the most significant domain among overlapping annotations.")
    group.add_argument("--device", choices=("cuda", "cpu"),
                       default=defaults.get("--device", "cuda"),
                       help="Device for the profile-HMM search and the CRF decode "
                            "(cuda fails when no card is present).")
    group.add_argument("--backend", choices=("cuda", "torch"),
                       default=defaults.get("--backend", "cuda"),
                       help="Search engine: the CUDA kernels (plain PyTorch on a "
                            "cpu device), or plain PyTorch everywhere.")
