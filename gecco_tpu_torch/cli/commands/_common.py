"""Shared pipeline plumbing of the port's CLI.

A copy of ``gecco_tpu.cli.commands._common`` (reference:
``gecco/cli/commands/_common.py`` — table writers (:47-120),
sequence/table loaders with strict coordinate cross-validation on resume
(:133-262), source re-attachment (:265-292), cluster labelling
(:308-341), gene extraction dispatch (:347-388), domain annotation with
disentangling and e/p filtering (:419-550), probability prediction
(:565-592), cluster extraction (:595-625), type prediction (:644-670),
training helpers (:676-724)).  The device-bound steps,
:func:`annotate_domains`, :func:`predict_probabilities` and
:func:`fit_model`, take an explicit ``device``.
"""

import collections
import itertools
import json
import math
import operator
import os
import random
from typing import Iterable, Iterator, List, Optional, Set

import numpy

from ... import __version__
from ..._meta import zopen
from ...profiling import TIMER, timed

__all__ = []  # internal module


@TIMER.span("init-device")
def init_device(device):
    """``--device`` resolved and checked (``_device.resolve_device``)."""
    from ..._device import resolve_device

    return resolve_device(device)


# --- Output files -------------------------------------------------------------

def make_output_directory(logger, output_dir, outputs: List[str]) -> None:
    logger.info("Using", "output folder", repr(str(output_dir)), level=1)
    os.makedirs(output_dir, exist_ok=True)
    for output in outputs:
        if os.path.isfile(os.path.join(output_dir, output)):
            logger.warn("Output folder contains files that will be overwritten")
            break


def _base_name(genome) -> str:
    base, _ = os.path.splitext(os.path.basename(str(genome)))
    return base


@TIMER.span("write-outputs")
def write_genes_table(logger, genes, *, genome, output_dir) -> None:
    from ...model import GeneTable

    path = os.path.join(output_dir, f"{_base_name(genome)}.genes.tsv")
    logger.info("Writing", "gene table to", repr(path), level=1)
    with open(path, "wb") as f:
        GeneTable.from_genes(genes).dump(f)


@TIMER.span("write-outputs")
def write_feature_table(logger, genes, *, genome, output_dir) -> None:
    from ...model import FeatureTable

    path = os.path.join(output_dir, f"{_base_name(genome)}.features.tsv")
    logger.info("Writing", "feature table to", repr(path), level=1)
    with open(path, "wb") as f:
        FeatureTable.from_genes(genes).dump(f)


@TIMER.span("write-outputs")
def write_cluster_table(logger, clusters, *, genome, output_dir) -> None:
    from ...model import ClusterTable

    path = os.path.join(output_dir, f"{_base_name(genome)}.clusters.tsv")
    logger.info("Writing", "cluster table to", repr(path), level=1)
    with open(path, "wb") as f:
        ClusterTable.from_clusters(clusters).dump(f)


@TIMER.span("write-outputs")
def write_clusters(logger, clusters, *, genome, output_dir, merge: bool = False) -> None:
    from ... import seqio

    if merge:
        path = os.path.join(output_dir, f"{_base_name(genome)}.clusters.gbk")
        logger.info("Writing", "all clusters to", repr(path), level=1)
        with open(path, "w") as f:
            seqio.write_genbank((c.to_seq_record() for c in clusters), f)
    else:
        for cluster in clusters:
            path = os.path.join(output_dir, f"{cluster.id}.gbk")
            logger.info("Writing", "cluster", cluster.id, "to", repr(path), level=1)
            with open(path, "w") as f:
                seqio.write_genbank([cluster.to_seq_record()], f)


def sideload_configuration(args) -> dict:
    """The 8-key antiSMASH sideload configuration block (one source of
    truth for run and predict; predict has no gene calling so ``mask``
    reports False there)."""
    return {
        "cds": str(args.cds),
        "e-filter": str(args.e_filter),
        "edge-distance": str(args.edge_distance),
        "mask": str(getattr(args, "mask", False)),
        "no-pad": str(not args.pad),
        "p-filter": str(args.p_filter),
        "postproc": repr(args.postproc),
        "threshold": str(args.threshold),
    }


@TIMER.span("write-outputs")
def write_sideload_json(logger, clusters, *, genome, output_dir, configuration=None) -> None:
    """AntiSMASH v6 sideload JSON (layout per the reference golden
    ``tests/test_cli/data/BGC0001866.sideload.json``)."""
    records = collections.defaultdict(list)
    for cluster in clusters:
        details = {
            f"{name.lower()}_probability": f"{value:.3f}"
            for name, value in sorted(cluster.type_probabilities.items(), key=lambda kv: kv[0].casefold())
        }
        details["average_p"] = f"{cluster.average_probability:.3f}"
        details["max_p"] = f"{cluster.maximum_probability:.3f}"
        records[cluster.source.id].append({
            "details": dict(sorted(details.items())),
            "end": cluster.end,
            "label": str(cluster.type) if cluster.type is not None else "Unknown",
            "start": cluster.start,
        })
    payload = {
        "records": [
            {"name": name, "subregions": subregions}
            for name, subregions in records.items()
        ],
        "tool": {
            "configuration": configuration or {},
            "description": "Biosynthetic Gene Cluster prediction with Conditional Random Fields.",
            "name": "GECCO-TPU",
            "version": __version__,
        },
    }
    path = os.path.join(output_dir, f"{_base_name(genome)}.sideload.json")
    logger.info("Writing", "sideload JSON to", repr(path), level=1)
    with open(path, "w") as f:
        json.dump(payload, f, indent=4, sort_keys=True)


# --- Load input ---------------------------------------------------------------

@TIMER.span("read-inputs")
def load_sequences(logger, genome, *, format: Optional[str]) -> List:
    from ... import seqio

    if format is not None:
        format = format.lower()
        logger.info("Using", "user-provided sequence format", repr(format), level=2)
    else:
        format = seqio.guess_sequences_format(str(genome))
        if format is None:
            raise RuntimeError(f"Failed to detect format of {str(genome)!r}")
        logger.success("Detected", "format of input as", repr(format), level=2)
    logger.info("Loading", "sequences from genomic file", repr(str(genome)), level=1)
    records = list(seqio.parse(str(genome), format))
    logger.success(f"Loaded {len(records)} sequences from {str(genome)!r}", level=1)
    return records


def shard_sequences(logger, sequences: List, *, shard: Optional[str]) -> List:
    """Keep only this process's deterministic contig shard (``--shard K/N``)."""
    from ...parallel.hosts import contig_shard, parse_shard

    index, count = parse_shard(shard)
    if count == 1:
        return sequences
    keep = contig_shard([len(r.seq) for r in sequences], index, count)
    logger.info(
        "Sharding:", f"processing {len(keep)} of {len(sequences)} contigs "
        f"(shard {index + 1}/{count})", level=1,
    )
    return [sequences[i] for i in keep]


@TIMER.span("read-inputs")
def load_genes(logger, table_path) -> List:
    from ...model import GeneTable

    logger.info("Loading", "genes table from file", repr(str(table_path)))
    with zopen(str(table_path)) as f:
        table = GeneTable.load(f)
    return list(table.to_genes())


@TIMER.span("read-inputs")
def load_features(logger, table_paths):
    from ...model import FeatureTable

    features = FeatureTable()
    for filename in table_paths:
        logger.info("Loading", "features table from file", repr(str(filename)))
        with zopen(str(filename)) as f:
            features += FeatureTable.load(f)
    logger.success("Loaded", "a total of", len(features), "features", level=1)
    return features


def annotate_genes(logger, genes: List, features) -> List:
    """Join features.tsv domains onto genes with strict coordinate checks.

    Domains are rebuilt with the same InterPro metadata and qualifiers a
    live annotation run attaches (``gecco_tpu_torch/hmm/__init__.py``;
    reference ``gecco/hmmer/__init__.py:155-176``), so the resume path
    writes the same GenBank records as a full run.  (The reference's own
    resume loader drops this metadata, ``_common.py:211-262`` — a known
    gap.)
    """
    from ...interpro import InterPro
    from ...model import Domain

    interpro = InterPro.load()
    gene_index = {gene.protein.id: gene for gene in genes}
    if len(gene_index) < len(genes):
        raise ValueError("Duplicate gene names in input genes")
    for i in range(len(features)):
        protein_id = features.protein_id[i]
        gene = gene_index[protein_id]
        if gene.source.id != features.sequence_id[i]:
            raise ValueError(
                f"Mismatched source sequence for {protein_id!r}: "
                f"{gene.source.id!r} != {features.sequence_id[i]!r}"
            )
        if gene.start != features.start[i]:
            raise ValueError(
                f"Mismatched gene start for {protein_id!r}: "
                f"{gene.start!r} != {features.start[i]!r}"
            )
        if gene.end != features.end[i]:
            raise ValueError(
                f"Mismatched gene end for {protein_id!r}: "
                f"{gene.end!r} != {features.end[i]!r}"
            )
        if gene.strand.sign != features.strand[i]:
            raise ValueError(
                f"Mismatched gene strand for {protein_id!r}: "
                f"{gene.strand.sign!r} != {features.strand[i]!r}"
            )
        probability = features.cluster_probability[i]
        if isinstance(probability, float) and math.isnan(probability):
            probability = None
        accession = features.domain[i]
        entry = interpro.lookup(accession)
        qualifiers = {
            "inference": ["protein motif"],
            "db_xref": ["{}:{}".format(features.hmm[i].upper(), accession)],
            "note": [
                "e-value: {}".format(features.i_evalue[i]),
                "p-value: {}".format(features.pvalue[i]),
            ],
        }
        if entry is not None:
            qualifiers["function"] = [entry.name]
            qualifiers["db_xref"].append("InterPro:{}".format(entry.accession))
            go_terms = entry.go_terms
            go_functions = entry.go_functions
        else:
            go_terms = []
            go_functions = []
        gene.protein.domains.append(Domain(
            name=accession,
            start=features.domain_start[i],
            end=features.domain_end[i],
            hmm=features.hmm[i],
            i_evalue=features.i_evalue[i],
            pvalue=features.pvalue[i],
            probability=probability,
            go_terms=go_terms,
            go_functions=go_functions,
            qualifiers=qualifiers,
        ))
    return list(gene_index.values())


def assign_sources(logger, sequences, genes: List, *, genome) -> Iterator:
    """Re-attach real source records and re-translate protein sequences."""
    from ...model import Strand

    known = {gene.source.id for gene in genes}
    index = {record.id: record for record in sequences if record.id in known}
    logger.info("Assigning", "source sequences to gene objects", level=2)
    for gene in genes:
        try:
            source = index[gene.source.id]
        except KeyError as err:
            raise RuntimeError(
                f"Sequence {gene.source.id!r} not found in {str(genome)!r}"
            ) from err
        gene = gene.with_source(source)
        gene_seq = source.seq[gene.start - 1 : gene.end]
        if gene.strand == Strand.Reverse:
            from ...seq import reverse_complement

            gene_seq = reverse_complement(gene_seq)
        from ...seq import Seq

        # translate like the gene callers do (table 11, initiator codon
        # rendered as M for the alternative starts GTG/TTG) so resumed
        # records byte-match the caller's output; the reference resumes
        # with a plain table-1 translate() (_common.py:286-290), which
        # diverges from its own gene caller on non-ATG starts
        # keep the trailing '*' (Pyrodigal keeps it; the golden GBK
        # /translation qualifiers end with it)
        protein_seq = Seq(gene_seq).translate(table=11)
        if protein_seq and gene_seq[:3].upper() in ("ATG", "GTG", "TTG"):
            protein_seq = Seq("M" + protein_seq[1:])
        gene.qualifiers.setdefault("transl_table", ["11"])
        gene = gene.with_protein(gene.protein.with_seq(protein_seq))
        yield gene


@TIMER.span("read-inputs")
def load_clusters(logger, clusters):
    from ...model import ClusterTable

    logger.info("Loading", "clusters table from file", repr(str(clusters)))
    with zopen(str(clusters)) as f:
        return ClusterTable.load(f)


def label_genes(logger, genes: List, clusters) -> List:
    """Probability 1 for genes overlapping any cluster row, else 0."""
    by_seq = collections.defaultdict(list)
    for i in range(len(clusters)):
        by_seq[clusters.sequence_id[i]].append((clusters.start[i], clusters.end[i]))
    logger.info("Labelling", "genes belonging to clusters")
    labelled = []
    for gene in genes:
        spans = by_seq[gene.source.id]
        if any(start <= gene.end and gene.start <= end for start, end in spans):
            labelled.append(gene.with_probability(1))
        else:
            labelled.append(gene.with_probability(0))
    return labelled


# --- Extract genes ------------------------------------------------------------

@timed("extract-genes")
def extract_genes(
    logger, sequences: List, *,
    gff_file, cds_feature, locus_tag, mask: bool, jobs: int,
) -> List:
    from ...orf import CDSFinder, GFFFinder

    logger.info("Extracting", "genes from input sequences", level=1)
    kwargs = {}
    if cds_feature is not None:
        kwargs["feature"] = cds_feature
    if locus_tag is not None:
        kwargs["locus_tag"] = locus_tag
    if gff_file is not None:
        logger.info("Using", f"GFF features from {str(gff_file)!r}", level=2)
        finder = GFFFinder(gff_file, **kwargs)
    elif cds_feature is not None:
        logger.info("Using", f"record features named {cds_feature!r}", level=2)
        finder = CDSFinder(**kwargs)
    else:
        from ...orf.scan import ScanFinder

        logger.info("Using", "the de-novo ORF scanner in metagenome mode", level=2)
        finder = ScanFinder(mask=mask, cpus=jobs)

    def callback(record, found):
        logger.success("Found", found, "genes in record", repr(record.id), level=2)

    return list(finder.find_genes(sequences, progress=callback))


# --- Annotate genes -----------------------------------------------------------

def default_hmms():
    from ...hmm import embedded_hmms

    return embedded_hmms()


def custom_hmms(hmm_paths):
    from ...hmm import HMM

    for path in hmm_paths:
        base = os.path.basename(str(path))
        if base.endswith((".gz", ".lz4", ".xz", ".bz2")):
            base, _ = os.path.splitext(base)
        base, _ = os.path.splitext(base)
        yield HMM(
            id=base, version="?", url="?", path=str(path), size=None,
            relabel_with=r"s/([^\.]*)(\..*)?/\1/",
        )


def filter_domains(logger, genes: List, *, e_filter=None, p_filter=None) -> List:
    if e_filter is not None:
        logger.info("Excluding", "domains with e-value over", e_filter, level=1)
        genes = [
            gene.with_protein(gene.protein.with_domains(
                [d for d in gene.protein.domains if d.i_evalue < e_filter]
            ))
            for gene in genes
        ]
    if p_filter is not None:
        logger.info("Excluding", "domains with p-value over", p_filter, level=1)
        genes = [
            gene.with_protein(gene.protein.with_domains(
                [d for d in gene.protein.domains if d.pvalue < p_filter]
            ))
            for gene in genes
        ]
    if p_filter is not None or e_filter is not None:
        count = sum(len(gene.protein.domains) for gene in genes)
        logger.info("Using", "remaining", count, "domains", level=1)
    return genes


def _disentangle(gene):
    """Keep only the lowest-p-value domain among each overlapping group."""
    if len(gene.protein.domains) <= 1:
        return gene
    keep = []
    pending = list(gene.protein.domains)
    while pending:
        domain = pending.pop()
        overlaps = [
            other for other in pending
            if other.start <= domain.end and domain.start <= other.end
        ]
        if not overlaps or domain.pvalue < min(d.pvalue for d in overlaps):
            keep.append(domain)
            for other in overlaps:
                pending.remove(other)
    return gene.with_protein(gene.protein.with_domains(keep))


@timed("annotate-domains")
def annotate_domains(
    logger, genes: List, *,
    hmm_paths: List, default_hmms: Iterable, device, backend: str = "auto",
    devices=None, whitelist=None, disentangle: bool = False, jobs: int = 0,
    bit_cutoffs=None, e_filter=None, p_filter=None,
) -> List:
    import torch

    from ...hmm import ProfileHMMAnnotator

    if devices is not None:
        if torch.device(device).type != "cuda":
            raise ValueError("--devices shards the search over cards; it cannot "
                             "be used with --device cpu")
        if devices != "all":
            count = torch.cuda.device_count()
            if int(devices) > count:
                raise ValueError(f"--devices {devices}: the machine has {count} cards")
            devices = [torch.device("cuda", i) for i in range(int(devices))]
    logger.info("Running", f"profile-HMM domain annotation on {device}", level=1)
    hmms = list(custom_hmms(hmm_paths) if hmm_paths else default_hmms)
    if not hmms:
        raise RuntimeError(
            "no HMM libraries available: provide --hmm or install an "
            "embedded library (see `gecco_tpu_torch.hmm.embedded_hmms`)"
        )
    for hmm in hmms:
        logger.info("Starting", f"annotation with {hmm.id} v{hmm.version}", level=2)
        genes = ProfileHMMAnnotator(
            hmm, jobs, whitelist, backend=backend, devices=devices, device=device,
        ).run(genes, bit_cutoffs=bit_cutoffs)
        logger.success("Finished", f"annotation with {hmm.id} v{hmm.version}", level=2)

    count = sum(len(gene.protein.domains) for gene in genes)
    logger.success("Found", count, "domains across all proteins", level=1)

    if disentangle:
        logger.info("Disentangling", "overlapping domains in each gene", level=1)
        genes = [_disentangle(gene) for gene in genes]

    genes = filter_domains(logger, genes, e_filter=e_filter, p_filter=p_filter)
    genes.sort(key=operator.attrgetter("source.id", "start", "end"))
    for gene in genes:
        gene.protein.domains.sort(key=operator.attrgetter("start", "end"))
    return genes



# --- Predict ------------------------------------------------------------------

@timed("predict-probabilities")
def predict_probabilities(logger, genes: List, *, model, pad: bool, crf_type, device) -> List:
    if model is None:
        logger.info("Loading", "embedded CRF pre-trained model", level=1)
    else:
        logger.info("Loading", "CRF pre-trained model from", repr(str(model)), level=1)
    with TIMER.span("load-crf"):
        crf = crf_type.trained(model)
    logger.info("Predicting", "cluster probabilities with the model", level=1)
    with TIMER.span("decode"):
        return crf.predict_probabilities(genes, pad=pad, device=device)


@timed("extract-clusters")
def extract_clusters(
    logger, genes: List, *, threshold, postproc, cds, edge_distance, trim,
) -> List:
    from ...refine import ClusterRefiner

    logger.info("Extracting", "predicted clusters", level=1)
    refiner = ClusterRefiner(
        threshold=threshold, criterion=postproc, n_cds=cds,
        edge_distance=edge_distance, trim=trim,
    )
    clusters = []
    for _, group in itertools.groupby(genes, key=operator.attrgetter("source.id")):
        clusters.extend(refiner.iter_clusters(list(group)))
    return clusters


@TIMER.span("load-models")
def load_type_classifier(logger, *, model, classifier_type):
    if model is None:
        logger.info("Loading", "type classifier from embedded model", level=2)
    else:
        logger.info("Loading", "type classifier from", repr(str(model)), level=2)
    return classifier_type.trained(model)


def load_model_domains(logger, classifier) -> Set[str]:
    domains = set(classifier.attributes_)
    logger.success("Found", len(domains), "selected features", level=2)
    return domains


@timed("predict-types")
def predict_types(logger, clusters: List, *, classifier) -> List:
    logger.info("Predicting", "gene cluster types", level=1)
    clusters = classifier.predict_types(clusters)
    for cluster in clusters:
        if cluster.type:
            logger.success("Predicted type of", cluster.id, "as", str(cluster.type))
        else:
            best = max(cluster.type_probabilities, key=cluster.type_probabilities.get)
            logger.warn(f"Couldn't assign type to {cluster.id} (maybe {best})")
    return clusters


# --- Train --------------------------------------------------------------------

def seed_rng(logger, seed: int) -> None:
    logger.info("Seeding", "the random number generator with seed", seed, level=2)
    random.seed(seed)
    numpy.random.seed(seed)


@timed("fit-model")
def fit_model(
    logger, genes: List, *,
    feature_type, c1, c2, window_size, window_step,
    shuffle, select, correction, device, seed: int = 42, jobs: int = 0, crf_type,
):
    logger.info("Creating", f"the CRF in {feature_type} mode", level=1)
    logger.info("Using", f"provided hyperparameters (C1={c1}, C2={c2})", level=1)
    crf = crf_type(
        feature_type, algorithm="lbfgs",
        window_size=window_size, window_step=window_step, c1=c1, c2=c2,
    )
    logger.info("Fitting", f"the CRF model to the training data on {device}")
    crf.fit(genes, select=select, shuffle=shuffle, correction_method=correction, seed=seed,
            device=device)
    return crf
