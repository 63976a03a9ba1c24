"""``gecco-tpu-torch annotate`` — the front half of ``run``: genes + domains only.

Port of ``gecco_tpu.cli.commands.annotate`` (reference:
``gecco/cli/commands/annotate.py:55-127``), with the domain annotation
on ``--device``.
"""

import argparse

from ..._device import resolve_device
from . import _common, _parser

__all__ = ["configure_parser", "run"]


def configure_parser(parser: argparse.ArgumentParser, defaults) -> None:
    _parser.configure_common(parser, defaults)
    _parser.group_input_sequences(parser, defaults)
    _parser.group_gene_calling(parser, defaults)
    _parser.group_output(parser, defaults, merge=False)
    _parser.group_annotation(parser, defaults)


def run(args, logger, crf_type, classifier_type, default_hmms) -> int:
    device = resolve_device(args.device)
    base = _common._base_name(args.genome)
    outputs = [f"{base}.features.tsv", f"{base}.genes.tsv"]
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
        logger.warn("No genes were found")
        return 0

    genes = _common.annotate_domains(
        logger, genes,
        hmm_paths=args.hmms, default_hmms=default_hmms(),
        device=device, backend=args.backend, devices=args.devices,
        whitelist=None, disentangle=args.disentangle, jobs=args.jobs,
        bit_cutoffs=args.bit_cutoffs, e_filter=args.e_filter, p_filter=args.p_filter,
    )
    _common.write_genes_table(logger, genes, genome=args.genome, output_dir=args.output_dir)
    _common.write_feature_table(logger, genes, genome=args.genome, output_dir=args.output_dir)
    count = sum(len(gene.protein.domains) for gene in genes)
    logger.success("Found", count, "protein domains", level=0)
    return 0
