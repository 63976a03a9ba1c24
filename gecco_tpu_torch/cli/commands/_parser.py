"""Argument groups of the port's CLI.

Copies of the ``gecco_tpu.cli.commands._parser`` groups (reference:
``gecco/cli/commands/_parser.py``), with the same flags and defaults
(``-W 5``, ``--c1 0.15``, ``--c2 0.15``, ``--seed 42``).  What differs:

* the annotation group names the engines ``--backend {auto,cuda,torch}``
  (``auto``: the CUDA kernels on a card, plain PyTorch on the CPU) where
  JAX names ``{auto,pallas,xla}``;
* it adds ``--device {cuda,cpu}`` (default ``cuda``), the device of the
  search and the CRF, which ``predict``, ``train`` and ``cv`` take too
  (:func:`group_device`); ``--devices all|N`` takes the first N cards of
  the machine, and is refused with ``--device cpu``;
* ``--profile DIR`` records a ``torch.profiler`` trace, not an XLA one.
"""

import argparse
import pathlib
from typing import Dict

__all__ = [
    "configure_common",
    "group_input_sequences",
    "group_input_tables",
    "group_gene_calling",
    "group_annotation",
    "group_device",
    "group_filtering",
    "group_output",
    "group_predict",
    "group_segmentation",
    "group_training_data",
    "group_training_parameters",
]


def configure_common(parser: argparse.ArgumentParser, defaults: Dict[str, object]) -> None:
    parser.add_argument(
        "-j", "--jobs", type=int, default=defaults.get("--jobs", 0),
        help="The number of jobs to use for multithreaded host stages (0 = all CPUs).",
    )
    parser.add_argument("-v", "--verbose", action="count", default=0,
                        help="Increase verbosity (-v, -vv).")
    parser.add_argument("-q", "--quiet", action="count", default=0,
                        help="Silence most of the log output.")
    parser.add_argument("--profile", metavar="DIR", default=defaults.get("--profile"),
                        help="Record a PyTorch profiler trace of the whole command into DIR.")


def group_input_sequences(parser, defaults: Dict[str, object], short: bool = True,
                          shard: bool = True) -> None:
    group = parser.add_argument_group("Input Sequences")
    names = ["-g", "--genome"] if short else ["--genome"]
    group.add_argument(*names, required=True, type=pathlib.Path,
                       help="A genomic file containing one or more sequences (FASTA/GenBank/EMBL).")
    fmt = ["-f", "--format"] if short else ["--format"]
    group.add_argument(*fmt, default=None,
                       help="The format of the input file (detected automatically when omitted).")
    if shard:
        group.add_argument("--shard", default=defaults.get("--shard"), metavar="K/N",
                           help="Process only the K-th of N deterministic, length-balanced "
                                "contig shards (multi-host runs; merge the per-shard tables afterwards).")


def group_input_tables(parser, defaults: Dict[str, object], clusters: bool = True) -> None:
    group = parser.add_argument_group("Input Tables")
    group.add_argument("-f", "--features", type=pathlib.Path, action="append", required=True,
                       help="The path to a domain annotation table (repeatable).")
    group.add_argument("-g", "--genes", type=pathlib.Path, required=True,
                       help="The path to a gene coordinate table.")
    if clusters:
        group.add_argument("-c", "--clusters", type=pathlib.Path, required=True,
                           help="The path to a cluster annotation table.")


def group_gene_calling(parser, defaults: Dict[str, object]) -> None:
    group = parser.add_argument_group("Gene Calling")
    group.add_argument("-M", "--mask", action="store_true", default=defaults.get("--mask", False),
                       help="Mask unknown regions to stop genes from stretching across them.")
    group.add_argument("--cds-feature", default=defaults.get("--cds-feature", None),
                       help="Extract genes from existing record features of this type instead of calling ORFs.")
    group.add_argument("--locus-tag", default=defaults.get("--locus-tag", "locus_tag"),
                       help="The name of the feature qualifier to use for naming extracted genes.")
    group.add_argument("--gff-file", type=pathlib.Path, default=None,
                       help="Extract genes from a GFF3 sidecar file instead of calling ORFs.")


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
    _add_device(group, defaults, "the profile-HMM search and the CRF decode")
    group.add_argument("--backend", choices=("auto", "cuda", "torch"),
                       default=defaults.get("--backend", "auto"),
                       help="Search engine (auto: the CUDA kernels on a card, plain "
                            "PyTorch on the CPU; torch: plain PyTorch everywhere).")
    group.add_argument("--devices", type=_devices_value,
                       default=defaults.get("--devices", None),
                       help="Shard the search batch over the machine's cards: "
                            "'all', or a positive card count (data parallelism "
                            "within one process; default: one device).")


def _devices_value(value: str):
    """``--devices`` argument: 'all' or a positive integer."""
    if value == "all":
        return value
    try:
        count = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected 'all' or a positive integer, got {value!r}")
    if count < 1:
        raise argparse.ArgumentTypeError(
            f"expected 'all' or a positive integer, got {value!r}")
    return count


def _add_device(group, defaults: Dict[str, object], what: str) -> None:
    group.add_argument("--device", choices=("cuda", "cpu"),
                       default=defaults.get("--device", "cuda"),
                       help=f"Device for {what} (cuda fails when no card is present).")


def group_device(parser, defaults: Dict[str, object]) -> None:
    group = parser.add_argument_group("Device")
    _add_device(group, defaults, "the CRF fit and decode")


def group_filtering(parser, defaults: Dict[str, object]) -> None:
    group = parser.add_argument_group("Domain Filtering")
    group.add_argument("-e", "--e-filter", type=float, default=defaults.get("--e-filter", None),
                       help="Exclude domains with an i-evalue over this value.")
    group.add_argument("-p", "--p-filter", type=float, default=defaults.get("--p-filter", 1e-9),
                       help="Exclude domains with a p-value over this value.")


def group_output(parser, defaults: Dict[str, object], merge: bool = True) -> None:
    group = parser.add_argument_group("Output")
    group.add_argument("-o", "--output-dir", type=pathlib.Path,
                       default=pathlib.Path(defaults.get("--output-dir", ".")),
                       help="The directory to write the output files to.")
    group.add_argument("--force-tsv", action="store_true",
                       help="Always write TSV output files, even when no genes or clusters are found.")
    if merge:
        group.add_argument("--merge-gbk", action="store_true",
                           help="Write a single GenBank file with every cluster instead of one file each.")
        group.add_argument("--antismash-sideload", action="store_true",
                           help="Write an AntiSMASH v6 sideload JSON file next to the output files.")


def group_predict(parser, defaults: Dict[str, object]) -> None:
    group = parser.add_argument_group("Cluster Detection")
    group.add_argument("--model", type=pathlib.Path, default=defaults.get("--model", None),
                       help="The path to an alternative prediction model directory.")
    group.add_argument("--no-pad", action="store_false", dest="pad",
                       help="Disable padding of gene sequences smaller than the CRF window.")


def group_segmentation(parser, defaults: Dict[str, object]) -> None:
    group = parser.add_argument_group("Cluster Segmentation")
    group.add_argument("-c", "--cds", type=int, default=defaults.get("--cds", 3),
                       help="The minimum number of annotated genes a valid cluster must contain.")
    group.add_argument("-m", "--threshold", type=float, default=defaults.get("--threshold", 0.8),
                       help="The probability threshold for cluster detection.")
    group.add_argument("--postproc", choices=("gecco", "antismash"),
                       default=defaults.get("--postproc", "gecco"),
                       help="The criterion to use when validating clusters.")
    group.add_argument("-E", "--edge-distance", type=int,
                       default=defaults.get("--edge-distance", 0),
                       help="The minimum number of annotated genes between a cluster and the contig edge.")
    if defaults.get("--trim", True):
        group.add_argument("--no-trim", action="store_false", dest="trim",
                           help="Keep unannotated edge genes in predicted clusters.")
    else:
        group.add_argument("--trim", action="store_true", dest="trim",
                           help="Trim unannotated edge genes from predicted clusters.")


def group_training_data(parser, defaults: Dict[str, object]) -> None:
    group = parser.add_argument_group("Training Data")
    group.add_argument("--no-shuffle", action="store_false", dest="shuffle",
                       help="Disable shuffling of the contigs before fitting.")
    group.add_argument("--seed", type=int, default=defaults.get("--seed", 42),
                       help="The seed for the random number generator.")


def group_training_parameters(parser, defaults: Dict[str, object]) -> None:
    group = parser.add_argument_group("Training Parameters")
    group.add_argument("-W", "--window-size", type=int, default=defaults.get("--window-size", 5),
                       help="The length of the sliding window for CRF predictions.")
    group.add_argument("--window-step", type=int, default=defaults.get("--window-step", 1),
                       help="The step of the sliding window for CRF predictions.")
    group.add_argument("--c1", type=float, default=defaults.get("--c1", 0.15),
                       help="The strength of the L1 regularization.")
    group.add_argument("--c2", type=float, default=defaults.get("--c2", 0.15),
                       help="The strength of the L2 regularization.")
    group.add_argument("--feature-type", choices=("protein", "domain"),
                       default=defaults.get("--feature-type", "protein"),
                       help="The level at which features are extracted for the CRF.")
    group.add_argument("--select", type=float, default=defaults.get("--select", None),
                       help="The fraction of most significant features to select before training.")
    group.add_argument("--correction", default=defaults.get("--correction", None),
                       help="The multiple-testing correction method for feature selection.")
