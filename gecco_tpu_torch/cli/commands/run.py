"""``gecco-tpu-torch run`` — the end-to-end prediction command.

Port of ``gecco_tpu.cli.commands.run``: sequences → genes → gene table →
classifier whitelist → domain annotation (on ``--device``) → CRF
probabilities (on ``--device``) → tables → cluster extraction → type
prediction → cluster table + GenBank files.
"""

import argparse

from ..._device import resolve_device
from . import _common
from . import _parser

__all__ = ["configure_parser", "run"]


def configure_parser(parser: argparse.ArgumentParser, defaults) -> None:
    _parser.configure_common(parser, defaults)
    _parser.group_input_sequences(parser, defaults)
    _parser.group_gene_calling(parser, defaults)
    _parser.group_output(parser, defaults)
    _parser.group_annotation(parser, defaults)
    _parser.group_predict(parser, defaults)
    _parser.group_segmentation(parser, defaults)


def run(args, logger, crf_type, classifier_type, default_hmms) -> int:
    device = resolve_device(args.device)
    base = _common._base_name(args.genome)
    outputs = [f"{base}.features.tsv", f"{base}.genes.tsv", f"{base}.clusters.tsv"]
    if args.antismash_sideload:
        outputs.append(f"{base}.sideload.json")
    if args.merge_gbk:
        outputs.append(f"{base}.clusters.gbk")
    _common.make_output_directory(logger, args.output_dir, outputs)

    sequences = list(_common.load_sequences(logger, args.genome, format=args.format))
    sequences = _common.shard_sequences(logger, sequences, shard=args.shard)
    genes = _common.extract_genes(
        logger, sequences,
        gff_file=args.gff_file, cds_feature=args.cds_feature,
        locus_tag=args.locus_tag, mask=args.mask, jobs=args.jobs,
    )

    _common.write_genes_table(logger, genes, genome=args.genome, output_dir=args.output_dir)
    if genes:
        logger.success("Found", "a total of", len(genes), "genes", level=1)
    else:
        if args.force_tsv:
            _common.write_feature_table(logger, [], genome=args.genome, output_dir=args.output_dir)
            _common.write_cluster_table(logger, [], genome=args.genome, output_dir=args.output_dir)
        logger.warn("No genes were found")
        return 0

    classifier = _common.load_type_classifier(
        logger, model=args.model, classifier_type=classifier_type
    )
    whitelist = _common.load_model_domains(logger, classifier)

    genes = _common.annotate_domains(
        logger, genes,
        hmm_paths=args.hmms, default_hmms=default_hmms(),
        device=device, backend=args.backend, devices=args.devices,
        whitelist=whitelist, disentangle=args.disentangle, jobs=args.jobs,
        bit_cutoffs=args.bit_cutoffs, e_filter=args.e_filter, p_filter=args.p_filter,
    )

    genes = _common.predict_probabilities(
        logger, genes, model=args.model, pad=args.pad, crf_type=crf_type, device=device,
    )
    _common.write_genes_table(logger, genes, genome=args.genome, output_dir=args.output_dir)
    _common.write_feature_table(logger, genes, genome=args.genome, output_dir=args.output_dir)

    clusters = _common.extract_clusters(
        logger, genes,
        threshold=args.threshold, postproc=args.postproc, cds=args.cds,
        edge_distance=args.edge_distance, trim=args.trim,
    )
    if clusters:
        logger.success("Found", len(clusters), "potential gene clusters", level=1)
    else:
        logger.warn("No gene clusters were found")
        if args.force_tsv:
            _common.write_cluster_table(logger, clusters, genome=args.genome, output_dir=args.output_dir)
        return 0

    if len(classifier.classes_) > 1:
        clusters = _common.predict_types(logger, clusters, classifier=classifier)

    logger.info("Writing", "result files to folder", repr(str(args.output_dir)), level=1)
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
    unit = "cluster" if len(clusters) == 1 else "clusters"
    logger.success("Found", len(clusters), "gene", unit, level=0)
    return 0
