"""``gecco-tpu-torch convert`` — post-process output files into other formats.

Behavioral reference: ``gecco/cli/commands/convert.py``
— ``gbk → bigslice`` (adds fake antiSMASH-Data + mibig subregion,
renames to ``{id}.region{N:03}.gbk``, :97-160), ``gbk → fna/faa``
(:166-242), ``clusters → gff`` (:248-313).
"""

import argparse
import csv
import glob
import os
import pathlib
import re

from . import _common, _parser

__all__ = ["configure_parser", "run"]


def configure_parser(parser: argparse.ArgumentParser, defaults) -> None:
    _parser.configure_common(parser, defaults)
    commands = parser.add_subparsers(required=True, metavar="INPUT", dest="input")

    gbk = commands.add_parser("gbk", help="Convert GenBank records to a different format.")
    gbk.set_defaults(input="gbk")
    gbk.add_argument("-i", "--input-dir", type=pathlib.Path, required=True,
                     help="The directory containing files to convert.")
    gbk.add_argument("-o", "--output-dir", type=pathlib.Path, default=None,
                     help="The directory to write converted files to.")
    gbk.add_argument("-f", "--format", required=True, choices=("bigslice", "fna", "faa"),
                     help="The output format to write.")

    clusters = commands.add_parser("clusters", help="Convert the clusters table to a different format.")
    clusters.set_defaults(input="clusters")
    clusters.add_argument("-i", "--input-dir", type=pathlib.Path, required=True,
                          help="The directory containing files to convert.")
    clusters.add_argument("-o", "--output-dir", type=pathlib.Path, default=None,
                          help="The directory to write converted files to.")
    clusters.add_argument("-f", "--format", required=True, choices=("gff",),
                          help="The output format to write.")


def _gecco_records(logger, input_dir):
    from ... import seqio

    for gbk_file in sorted(input_dir.glob("*_cluster_*.gbk")):
        record = next(seqio.parse(str(gbk_file)))
        structured = record.annotations.get("structured_comment", {})
        if "GECCO-Data" not in structured:
            logger.warn(f"GenBank file {str(gbk_file)!r} was not obtained by GECCO")
            continue
        yield gbk_file, record


def _convert_gbk_bigslice(logger, input_dir, output_dir) -> int:
    from ... import seqio
    from ...model import ClusterTable
    from ...seq import FeatureLocation, SeqFeature

    coordinates, types = {}, {}
    for cluster_file in glob.glob(os.path.join(input_dir, "*.clusters.tsv")):
        table = ClusterTable.load(cluster_file)
        for i in range(len(table)):
            coordinates[table.cluster_id[i]] = (table.start[i], table.end[i])
            types[table.cluster_id[i]] = table.type[i] or "Unknown"

    done = 0
    for gbk_file, record in _gecco_records(logger, input_dir):
        record.annotations.setdefault("structured_comment", {})["antiSMASH-Data"] = {
            "Version": "5.X",
            "Orig. start": coordinates[record.id][0],
            "Orig. end": coordinates[record.id][1],
        }
        subregion = SeqFeature(FeatureLocation(0, len(record.seq)), type="subregion")
        subregion.qualifiers["contig_edge"] = ["False"]
        subregion.qualifiers["aStool"] = ["mibig"]
        subregion.qualifiers["label"] = [types[record.id]]
        record.features.append(subregion)
        contig_id, cluster_n = re.search(r"^(.*)_cluster_(\d+).gbk", gbk_file.name).groups()
        new_name = output_dir.joinpath("{}.region{:03}.gbk".format(contig_id, int(cluster_n)))
        logger.info(f"Rewriting {str(gbk_file)!r} to {str(new_name)!r}")
        with open(new_name, "w") as f:
            seqio.write_genbank([record], f)
        done += 1
    logger.success("Converted", done, "GenBank files to BiG-SLiCE format", level=0)
    return done


def _convert_gbk_fna(logger, input_dir, output_dir) -> int:
    from ... import seqio

    done = 0
    for gbk_file, record in _gecco_records(logger, input_dir):
        new_name = output_dir.joinpath(gbk_file.with_suffix(".fna").name)
        logger.info(f"Converting {str(gbk_file)!r} to FASTA file {str(new_name)!r}")
        record.description = record.description or record.id
        with open(new_name, "w") as f:
            seqio.write_fasta([record], f)
        done += 1
    logger.success("Converted", done, "GenBank files to nucleotide FASTA format", level=0)
    return done


def _convert_gbk_faa(logger, input_dir, output_dir) -> int:
    from ... import seqio
    from ...seq import Seq, SeqRecord

    done = 0
    for gbk_file, record in _gecco_records(logger, input_dir):
        proteins = []
        for feature in record.features:
            if feature.type != "CDS" or "locus_tag" not in feature.qualifiers:
                continue
            proteins.append(SeqRecord(
                id=feature.qualifiers["locus_tag"][0],
                seq=Seq(feature.qualifiers["translation"][0]),
            ))
        new_name = output_dir.joinpath(gbk_file.with_suffix(".faa").name)
        logger.info(f"Converting {str(gbk_file)!r} proteins to {str(new_name)!r}")
        with open(new_name, "w") as f:
            seqio.write_fasta(proteins, f)
        done += 1
    logger.success("Converted", done, "GenBank files to protein FASTA format", level=0)
    return done


def _convert_clusters_gff(logger, input_dir, output_dir) -> int:
    from ... import seqio
    from ...model import ClusterTable

    done = 0
    for tsv_file in sorted(input_dir.glob("*.clusters.tsv")):
        table = ClusterTable.load(str(tsv_file))
        gff_file = output_dir.joinpath(tsv_file.with_suffix(".gff").name)
        with open(gff_file, "w") as dst:
            writer = csv.writer(dst, dialect="excel-tab")
            writer.writerow(["##gff-version 3"])
            for row in table.rows():
                gbk_path = os.path.join(input_dir, f"{row['cluster_id']}.gbk")
                version = "GECCO"
                if os.path.exists(gbk_path):
                    cluster = next(seqio.parse(gbk_path))
                    annotations = cluster.annotations.get("structured_comment", {}).get("GECCO-Data", {})
                    version = annotations.get("version", version)
                bgc_types = ["Unknown"] if not row["type"] else str(row["type"]).split(";")
                type_probas = []
                for key, value in row.items():
                    if key.endswith("_probability"):
                        ty = key.split("_")[0].capitalize()
                        if ty == "Nrp":
                            ty = "NRP"
                        type_probas.append(f"Type{ty}={value}")
                writer.writerow([
                    row["sequence_id"],
                    version,
                    "BGC",
                    str(row["start"]),
                    str(row["end"]),
                    str(row["average_p"]),
                    ".",
                    ".",
                    ";".join([
                        f"ID={row['cluster_id']}",
                        f"Name={'/'.join(sorted(bgc_types))} cluster",
                        f"Type={','.join(sorted(bgc_types))}",
                        f"ProbabilityAverage={row['average_p']}",
                        f"ProbabilityMax={row['max_p']}",
                        *type_probas,
                        f"Genes={str(row['proteins']).count(';') + 1}",
                        f"Domains={str(row['domains']).count(';') + 1}",
                    ]),
                ])
        done += 1
    logger.success("Converted", done, "TSV files to GFF format", level=0)
    return done


def run(args, logger, crf_type, classifier_type, default_hmms) -> int:
    input_dir = args.input_dir
    output_dir = args.output_dir if args.output_dir is not None else input_dir
    output_dir.mkdir(parents=True, exist_ok=True)
    if args.input == "gbk":
        if args.format == "bigslice":
            _convert_gbk_bigslice(logger, input_dir, output_dir)
        elif args.format == "fna":
            _convert_gbk_fna(logger, input_dir, output_dir)
        elif args.format == "faa":
            _convert_gbk_faa(logger, input_dir, output_dir)
    elif args.input == "clusters":
        if args.format == "gff":
            _convert_clusters_gff(logger, input_dir, output_dir)
    return 0
