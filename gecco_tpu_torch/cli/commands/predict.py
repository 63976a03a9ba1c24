"""``gecco-tpu-torch predict`` — resume prediction from precomputed tables.

Port of ``gecco_tpu.cli.commands.predict`` (reference:
``gecco/cli/commands/predict.py:45-153``): load genes + features,
re-attach source sequences and re-translate, filter domains, then the
same tail as ``run`` (CRF on ``--device`` → refine → types → outputs).
"""

import argparse
import operator

from ..._device import resolve_device
from . import _common, _parser

__all__ = ["configure_parser", "run"]


def configure_parser(parser: argparse.ArgumentParser, defaults) -> None:
    _parser.configure_common(parser, defaults)
    _parser.group_input_sequences(parser, defaults, short=False, shard=False)
    _parser.group_input_tables(parser, defaults, clusters=False)
    _parser.group_output(parser, defaults)
    _parser.group_filtering(parser, defaults)
    _parser.group_predict(parser, defaults)
    _parser.group_segmentation(parser, defaults)
    _parser.group_device(parser, defaults)


def run(args, logger, crf_type, classifier_type, default_hmms) -> int:
    device = resolve_device(args.device)
    base = _common._base_name(args.genome)
    outputs = [f"{base}.features.tsv", f"{base}.genes.tsv", f"{base}.clusters.tsv"]
    if args.antismash_sideload:
        outputs.append(f"{base}.sideload.json")
    if args.merge_gbk:
        outputs.append(f"{base}.clusters.gbk")
    _common.make_output_directory(logger, args.output_dir, outputs)

    genes = list(_common.load_genes(logger, args.genes))
    features = _common.load_features(logger, args.features)
    genes = _common.annotate_genes(logger, genes, features)

    sequences = _common.load_sequences(logger, args.genome, format=args.format)
    genes = list(_common.assign_sources(logger, sequences, genes, genome=args.genome))

    genes.sort(key=operator.attrgetter("source.id", "start", "end"))
    for gene in genes:
        gene.protein.domains.sort(key=operator.attrgetter("start", "end"))
    genes = _common.filter_domains(
        logger, genes, e_filter=args.e_filter, p_filter=args.p_filter
    )

    genes = _common.predict_probabilities(
        logger, genes, model=args.model, pad=args.pad, crf_type=crf_type,
        device=device,
    )
    _common.write_genes_table(logger, genes, genome=args.genome, output_dir=args.output_dir)
    _common.write_feature_table(logger, genes, genome=args.genome, output_dir=args.output_dir)

    clusters = _common.extract_clusters(
        logger, genes,
        threshold=args.threshold, postproc=args.postproc, cds=args.cds,
        edge_distance=args.edge_distance, trim=args.trim,
    )
    if not clusters:
        logger.warn("No gene clusters were found")
        if args.force_tsv:
            _common.write_cluster_table(logger, clusters, genome=args.genome, output_dir=args.output_dir)
        return 0
    logger.success("Found", len(clusters), "potential gene clusters", level=1)

    classifier = _common.load_type_classifier(
        logger, model=args.model, classifier_type=classifier_type
    )
    if len(classifier.classes_) > 1:
        clusters = _common.predict_types(logger, clusters, classifier=classifier)

    _common.write_cluster_table(logger, clusters, genome=args.genome, output_dir=args.output_dir)
    _common.write_clusters(
        logger, clusters, merge=args.merge_gbk, genome=args.genome, output_dir=args.output_dir
    )
    if args.antismash_sideload:
        configuration = _common.sideload_configuration(args)
        _common.write_sideload_json(
            logger, clusters, genome=args.genome, output_dir=args.output_dir,
            configuration=configuration,
        )
    return 0
