"""``gecco-tpu-torch train`` — fit a CRF model + type-classifier data from tables.

Port of ``gecco_tpu.cli.commands.train`` (reference:
``gecco/cli/commands/train.py``): seed RNG, load gene/feature/cluster
tables, join + label, fit the CRF on ``--device``, save the model directory with
transition/state weight TSVs and the type-classifier training data
(``domains.tsv``/``types.tsv``/``compositions.npz``).  Additionally the
frozen type-classifier forest is trained and saved (``forest.npz``) so
the output directory is directly usable as ``--model`` for
``run``/``predict``.
"""

import argparse
import collections
import csv
import itertools
import operator
import os

from . import _common, _parser

__all__ = ["configure_parser", "run"]


def configure_parser(parser: argparse.ArgumentParser, defaults) -> None:
    _parser.configure_common(parser, defaults)
    _parser.group_input_tables(parser, defaults, clusters=True)
    _parser.group_output(parser, defaults, merge=False)
    _parser.group_filtering(parser, defaults)
    _parser.group_training_data(parser, defaults)
    _parser.group_training_parameters(parser, defaults)
    _parser.group_device(parser, defaults)


def _save_transitions(logger, crf, output_dir) -> None:
    logger.info("Writing", "CRF transition weights")
    with open(os.path.join(output_dir, "model.trans.tsv"), "w") as f:
        writer = csv.writer(f, dialect="excel-tab")
        writer.writerow(["from", "to", "weight"])
        for i, src in enumerate(crf.label_names):
            for j, dst in enumerate(crf.label_names):
                if crf.trans[i, j] != 0.0:
                    writer.writerow([src, dst, crf.trans[i, j]])


def _save_weights(logger, crf, output_dir) -> None:
    logger.info("Writing", "state weights")
    with open(os.path.join(output_dir, "model.state.tsv"), "w") as f:
        writer = csv.writer(f, dialect="excel-tab")
        writer.writerow(["attr", "label", "weight"])
        for a, attr in enumerate(crf.attr_names):
            for j, label in enumerate(crf.label_names):
                if crf.state[a, j] != 0.0:
                    writer.writerow([attr, label, crf.state[a, j]])


def _assign_clusters(logger, genes, clusters):
    from ...model import Cluster, ClusterType

    cluster_types = {}
    cluster_by_seq = collections.defaultdict(list)
    for i in range(len(clusters)):
        seq_id = clusters.sequence_id[i]
        cluster_id = clusters.cluster_id[i]
        cluster_by_seq[seq_id].append((clusters.start[i], clusters.end[i], cluster_id))
        if "type" not in clusters.columns:
            cluster_types[cluster_id] = None
        elif clusters.type[i] == "Unknown" or clusters.type[i] is None:
            cluster_types[cluster_id] = ClusterType()
        else:
            cluster_types[cluster_id] = ClusterType(*clusters.type[i].split(";"))

    logger.info("Extracting", "genes belonging to clusters")
    genes_by_cluster = collections.defaultdict(list)
    for seq_id, seq_genes in itertools.groupby(genes, key=operator.attrgetter("source.id")):
        for gene in seq_genes:
            for start, end, cluster_id in cluster_by_seq[seq_id]:
                if start <= gene.end and gene.start <= end:
                    genes_by_cluster[cluster_id].append(gene)

    return [
        Cluster(cluster_id, genes_by_cluster[cluster_id], cluster_types[cluster_id])
        for cluster_id in sorted(filter(None, clusters.cluster_id))
        if genes_by_cluster[cluster_id]
    ]


def _save_domain_compositions(logger, all_possible, clusters, *, output_dir) -> None:
    import numpy
    import scipy.sparse

    logger.info("Saving", "training matrix labels for type classifier")
    with open(os.path.join(output_dir, "domains.tsv"), "w") as out:
        out.writelines(f"{domain}\n" for domain in all_possible)
    with open(os.path.join(output_dir, "types.tsv"), "w") as out:
        writer = csv.writer(out, dialect="excel-tab")
        for cluster in clusters:
            writer.writerow([cluster.id, ";".join(sorted(cluster.type.names))])

    logger.info("Building", "new domain composition matrix")
    comp = numpy.array([c.domain_composition(all_possible) for c in clusters])
    comp_out = os.path.join(output_dir, "compositions.npz")
    logger.info("Saving", "new domain composition matrix to file", repr(comp_out))
    scipy.sparse.save_npz(comp_out, scipy.sparse.coo_matrix(comp))
    return comp


def run(args, logger, crf_type, classifier_type, default_hmms) -> int:
    device = _common.init_device(args.device)
    _common.make_output_directory(logger, args.output_dir, [])
    _common.seed_rng(logger, args.seed)

    genes = list(_common.load_genes(logger, args.genes))
    features = _common.load_features(logger, args.features)
    genes = _common.annotate_genes(logger, genes, features)

    genes.sort(key=operator.attrgetter("source.id", "start", "end"))
    for gene in genes:
        gene.protein.domains.sort(key=operator.attrgetter("start", "end"))
    genes = _common.filter_domains(
        logger, genes, e_filter=args.e_filter, p_filter=args.p_filter
    )

    clusters = _common.load_clusters(logger, args.clusters)
    genes = _common.label_genes(logger, genes, clusters)

    crf = _common.fit_model(
        logger, genes,
        feature_type=args.feature_type, c1=args.c1, c2=args.c2,
        window_size=args.window_size, window_step=args.window_step,
        shuffle=args.shuffle, select=args.select, correction=args.correction,
        seed=args.seed, jobs=args.jobs, crf_type=crf_type, device=device,
    )

    logger.info("Saving", f"CRF model to {str(args.output_dir)!r}")
    crf.save(args.output_dir)
    _save_transitions(logger, crf, output_dir=args.output_dir)
    _save_weights(logger, crf, output_dir=args.output_dir)

    logger.info("Finding", "the array of possible protein domains", level=2)
    if crf.significant_features is not None:
        all_possible = sorted(crf.significant_features)
    else:
        all_possible = sorted({d.name for g in genes for d in g.protein.domains})

    assigned = _assign_clusters(logger, genes, clusters)
    compositions = _save_domain_compositions(
        logger, all_possible, assigned, output_dir=args.output_dir
    )

    # freeze a type-classifier forest trained on the new compositions
    types = [c.type for c in assigned]
    if any(ty and len(ty.names) for ty in types):
        logger.info("Training", "type classifier forest on new compositions")
        classifier = classifier_type()
        classifier.fit(compositions, types, all_possible, seed=0)
        classifier.save(args.output_dir)

    logger.success("Finished", "training new CRF model", level=0)
    return 0
