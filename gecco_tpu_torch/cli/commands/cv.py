"""``gecco-tpu-torch cv`` — cross-validated training/evaluation of the CRF.

Port of ``gecco_tpu.cli.commands.cv`` (reference:
``gecco/cli/commands/cv.py``), each fold fitted and predicted on
``--device``: group genes by contig (+ shuffle, with the global
``random`` seeded by ``seed_rng``, so that the folds are the JAX CLI's),
LOTO (multi-label-aware) or k-fold splits, per-fold fit + predict on
probability-stripped test data, appended fold table with ``fold`` and
``is_cluster`` columns, AUROC/AUPR per fold and overall.  Unlike the
JAX CLI, each gene's ``is_cluster`` label and its metrics pair with its
own prediction (see ``run``).
"""

import argparse
import itertools
import operator
import pathlib
import random

from ..._device import resolve_device
from . import _common, _parser

__all__ = ["configure_parser", "run"]


def configure_parser(parser: argparse.ArgumentParser, defaults) -> None:
    _parser.configure_common(parser, defaults)
    _parser.group_input_tables(parser, defaults, clusters=True)
    _parser.group_filtering(parser, defaults)
    _parser.group_training_data(parser, defaults)
    _parser.group_training_parameters(parser, defaults)
    _parser.group_device(parser, defaults)
    group = parser.add_argument_group("Cross-Validation")
    group.add_argument("--loto", action="store_true",
                       help="Use a leave-one-type-out split instead of k-fold.")
    group.add_argument("--splits", type=int, default=defaults.get("--splits", 10),
                       help="The number of folds for k-fold cross-validation.")
    group.add_argument("-o", "--output", type=pathlib.Path,
                       default=pathlib.Path(defaults.get("--output", "cv.tsv")),
                       help="The output file for the cross-validation table.")


def _group_genes(logger, genes, *, shuffle):
    logger.info("Grouping", "genes by source sequence")
    groups = itertools.groupby(genes, key=operator.attrgetter("source.id"))
    seqs = [sorted(group, key=operator.attrgetter("start")) for _, group in groups]
    if shuffle:
        logger.info("Shuffling", "training data sequences")
        random.shuffle(seqs)
    return seqs


def _loto_splits(logger, seqs, *, clusters):
    from ...crf.cv import LeaveOneGroupOut
    from ...model import ClusterType

    table = _common.load_clusters(logger, clusters)
    index = {}
    for i in range(len(table)):
        index[table.sequence_id[i]] = table.type[i] if "type" in table.columns else ""
    if len(index) != len(table):
        raise ValueError("Training data contains several clusters per sequence")

    groups = []
    for cluster in seqs:
        ty = next((index.get(g.source.id) for g in cluster if g.source.id in index), None)
        if ty is None:
            seq_id = next(gene.source.id for gene in cluster)
            logger.warn("Failed", f"to find type of cluster in {seq_id!r}")
            parsed = ClusterType()
        else:
            parsed = ClusterType(*(n for n in str(ty).split(";") if n and n != "Unknown"))
        groups.append([str(t) for t in parsed.unpack()])
    return list(LeaveOneGroupOut().split(seqs, groups=groups))


def _write_fold(logger, fold, truth, predicted, output, append=False):
    from ...model import GeneTable

    table = GeneTable.from_genes(predicted)
    lines = table.dumps().decode().split("\r\n")
    truth_flags = ["true" if (g.average_probability or 0) > 0.5 else "false" for g in truth]
    with open(output, "a" if append else "w") as out:
        if not append:
            out.write(lines[0] + "\tfold\tis_cluster\r\n")
        for row_line, flag in zip(lines[1:], truth_flags):
            if row_line:
                out.write(f"{row_line}\t{fold}\t{flag}\r\n")


def _report_fold(logger, fold, truth, predicted):
    from ...crf.metrics import average_precision_score, roc_auc_score

    probas = [gene.average_probability for gene in predicted]
    labels = [(gene.average_probability or 0) > 0.5 for gene in truth]
    if not any(labels) or all(labels):
        # a degenerate fold (e.g. LOTO leaving a test side with no
        # labelled cluster genes) has no defined AUROC/AUPR — report
        # and let the overall metrics cover it instead of crashing
        what = f"Fold {fold}" if fold else "The pooled cross-validation set"
        logger.warn(f"{what} has single-class labels; skipping its metrics")
        return None, None
    aupr = average_precision_score(labels, probas)
    auroc = roc_auc_score(labels, probas)
    if fold:
        logger.info(f"Finished training fold {fold} (AUROC={auroc:.3f}, AUPR={aupr:.3f})")
    else:
        logger.info(f"Finished cross validation (AUROC={auroc:.3f}, AUPR={aupr:.3f})")
    return auroc, aupr


def run(args, logger, crf_type, classifier_type, default_hmms) -> int:
    from ...model import Gene

    device = resolve_device(args.device)
    _common.seed_rng(logger, args.seed)
    genes = list(_common.load_genes(logger, args.genes))
    features = _common.load_features(logger, args.features)
    genes = _common.annotate_genes(logger, genes, features)
    genes.sort(key=operator.attrgetter("source.id", "start", "end"))
    genes = _common.filter_domains(
        logger, genes, e_filter=args.e_filter, p_filter=args.p_filter
    )
    clusters = _common.load_clusters(logger, args.clusters)
    genes = _common.label_genes(logger, genes, clusters)

    seqs = _group_genes(logger, genes, shuffle=args.shuffle)
    logger.success("Grouped", "genes into", len(seqs), "sequences")

    if args.loto:
        splits = _loto_splits(logger, seqs, clusters=args.clusters)
    else:
        from ...crf.cv import kfold

        splits = list(kfold(len(seqs), k=args.splits, seed=args.seed))

    logger.info("Performing cross-validation")
    predicted_all = []
    truth_all = []
    for i, (train_indices, test_indices) in enumerate(splits):
        train_data = [gene for t in train_indices for gene in seqs[t]]
        truth = [gene for t in test_indices for gene in seqs[t]]
        test_data = [
            Gene(g.source, g.start, g.end, g.strand, g.protein.with_domains(
                [d.with_probability(None) for d in g.protein.domains]
            ), dict(g.qualifiers), None)
            for g in truth
        ]
        crf = _common.fit_model(
            logger, train_data,
            feature_type=args.feature_type, c1=args.c1, c2=args.c2,
            window_size=args.window_size, window_step=args.window_step,
            shuffle=args.shuffle, select=args.select, correction=args.correction,
            seed=args.seed, jobs=args.jobs, crf_type=crf_type, device=device,
        )
        new_genes = crf.predict_probabilities(test_data, device=device)
        # predict_probabilities returns the genes sorted by contig and
        # start, and the folds hold their contigs in shuffled order: pair
        # each prediction with its own gene's label (the JAX CLI pairs
        # them by position, so its is_cluster column and its metrics
        # mismatch whenever a fold's contigs are out of order)
        by_id = {gene.protein.id: gene for gene in truth}
        truth = [by_id[gene.protein.id] for gene in new_genes]
        _write_fold(logger, i + 1, truth, new_genes, output=args.output, append=i > 0)
        _report_fold(logger, i + 1, truth, new_genes)
        predicted_all.extend(new_genes)
        truth_all.extend(truth)
    _report_fold(logger, None, truth_all, predicted_all)
    return 0
