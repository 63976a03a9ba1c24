"""The port's CLI against the JAX package's, and ``run`` without it.

A small synthetic genome whose genes carry planted domains of a small
calibrated bank (written as ``.h3m``, accessions taken from the embedded
model's Pfam whitelist so the annotator keeps them) goes through
``gecco_tpu_torch``'s CLI on the CPU and ``gecco_tpu``'s CLI with
``--backend pallas`` (its kernels in interpret mode), the path whose
domain definition the port follows: float32 device scores, no float64
rescore.  ``genes.tsv`` must be byte-equal; ``features.tsv`` and
``clusters.tsv`` must have the same rows, with numeric columns within
1e-6 relative, except the domains' ``i_evalue`` and ``pvalue``: float32
domain scores summed in another order than JAX's, which the exponential
tail turns into up to ~1e-4 relative, held at 1e-3.

The other five subcommands: ``annotate`` gives the JAX CLI's tables
(same bounds); ``predict`` from them gives ``run``'s tables in both
packages; ``train`` and ``cv`` on a synthetic training corpus (the
tables of ``tests/test_cli.py``'s ``train``/``cv`` tests) give the JAX
CLI's model files, type-classifier data, folds and gene set, with
probabilities within 2e-2 (two float32 fits of one objective), and
``cv`` labels each row with its own gene's label (the JAX CLI pairs a
fold's predictions, sorted by contig, with labels in fold order); a model
trained by either CLI predicts in the other exactly as in its own;
``convert`` writes the JAX CLI's files byte for byte.
"""

import io
import os
import subprocess
import sys
import warnings

import numpy
import pytest
import torch

from gecco_tpu.cli import main as jax_main
from gecco_tpu.cli.commands import configure_parser as jax_configure_parser
from gecco_tpu.crf import ClusterCRF
from gecco_tpu.hmm.calibrate import calibrate
from gecco_tpu.hmm.h3m import write_h3m
from gecco_tpu.hmm.io import AMINO_ALPHABET, BACKGROUND_F
from gecco_tpu.hmm.synthetic import plant_domain, synthetic_profiles
from gecco_tpu.seq import translate

from gecco_tpu_torch.cli import main
from gecco_tpu_torch.cli.commands import configure_parser

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_GENES = 36


def _synonymous_codons():
    codons = {}
    for a in "ACGT":
        for b in "ACGT":
            for c in "ACGT":
                codons.setdefault(translate(a + b + c), []).append(a + b + c)
    return codons


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    profiles = synthetic_profiles(8, min_length=90, max_length=150, seed=31)
    calibrate(profiles, n=96, L=128, seed=2)
    # the whitelisted Pfam accessions the embedded CRF weighs most
    # towards clusters, so the run also finds clusters
    crf = ClusterCRF.trained()
    with open(os.path.join(ROOT, "gecco_tpu", "data", "domains.tsv")) as f:
        accessions = [line.strip() for line in f if line.strip()]
    accessions.sort(key=lambda a: -(crf.state_weight(a) or 0.0))
    for gm, accession in zip(profiles, accessions):
        gm.hmm.accession = accession
    write_h3m(str(tmp / "bank.h3m"), [gm.hmm for gm in profiles])

    # genes: background proteins, most with one planted domain, on both
    # strands, joined by spacers
    rng = numpy.random.default_rng(5)
    codons = _synonymous_codons()
    p_bg = BACKGROUND_F / BACKGROUND_F.sum()
    complement = str.maketrans("ACGT", "TGCA")
    parts = []
    for i in range(N_GENES):
        x = rng.choice(20, size=int(rng.integers(150, 260)), p=p_bg).astype(numpy.int32)
        if i % 3 != 2:
            gm = profiles[i % len(profiles)]
            x = plant_domain(x, gm, rng, offset=15, max_len=gm.M, divergence=0.05)
        # random synonymous codons, so the other frames hit stops early
        gene = "ATG" + "".join(
            rng.choice(codons[AMINO_ALPHABET[a]]) for a in x) + "TAA"
        if i % 2:
            gene = gene.translate(complement)[::-1]
        parts.append(gene + "".join(rng.choice(list("ACGT"), size=120)))
    with open(tmp / "genome.fna", "w") as f:
        f.write(">genome\n" + "".join(parts) + "\n")
    return tmp


def _run(tmp, out, runner, extra):
    stream = io.StringIO()
    code = runner(["run", "-g", str(tmp / "genome.fna"), "--hmm", str(tmp / "bank.h3m"),
                   "-o", str(out), "--force-tsv", "-j", "1", *extra], stream)
    assert code == 0, stream.getvalue()
    return {kind: (out / f"genome.{kind}.tsv").read_text()
            for kind in ("genes", "features", "clusters")}


#: relative tolerance of the columns holding device domain scores
DOMAIN_SCORE_REL = {"i_evalue": 1e-3, "pvalue": 1e-3}


def _assert_tables_close(mine, theirs):
    rows_a = [r.split("\t") for r in mine.strip().split("\n")]
    rows_b = [r.split("\t") for r in theirs.strip().split("\n")]
    assert len(rows_a) == len(rows_b) and rows_a[0] == rows_b[0]
    rel = [DOMAIN_SCORE_REL.get(column, 1e-6) for column in rows_a[0]]
    for ra, rb in zip(rows_a[1:], rows_b[1:]):
        assert len(ra) == len(rb)
        for a, b, tol in zip(ra, rb, rel):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b
            else:
                assert fa == pytest.approx(fb, rel=tol, abs=1e-300)


@pytest.fixture(scope="module")
def jax_tables(inputs):
    return _run(inputs, inputs / "jax", jax_main, ["--backend", "pallas"])


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_run_matches_jax_cli(inputs, jax_tables, backend):
    theirs = jax_tables
    mine = _run(inputs, inputs / f"torch_{backend}", main,
                ["--device", "cpu", "--backend", backend])
    assert mine["genes"] == theirs["genes"]
    assert len(mine["genes"].splitlines()) > N_GENES // 2
    assert len(mine["features"].splitlines()) > N_GENES // 2
    assert len(mine["clusters"].splitlines()) > 1
    _assert_tables_close(mine["features"], theirs["features"])
    _assert_tables_close(mine["clusters"], theirs["clusters"])


def test_run_device_cuda_fails_without_card(inputs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    stream = io.StringIO()
    code = main(["run", "-g", str(inputs / "genome.fna"), "--hmm", str(inputs / "bank.h3m"),
                 "-o", str(inputs / "nocard")], stream)
    assert code == 1 and "cuda" in stream.getvalue()


def test_run_without_jax(inputs):
    """With ``jax`` and ``gecco_tpu`` blocked, the port's CLI ``run``
    completes on the CPU and neither package is loaded."""
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gecco_tpu'] = None\n"
        "from gecco_tpu_torch.cli import main\n"
        f"code = main(['run', '-g', {str(inputs / 'genome.fna')!r}, "
        f"'--hmm', {str(inputs / 'bank.h3m')!r}, '-o', {str(inputs / 'nojax')!r}, "
        "'--device', 'cpu', '--force-tsv', '-j', '1'])\n"
        "loaded = {m.split('.')[0] for m, v in sys.modules.items() if v is not None}\n"
        "assert not loaded & {'jax', 'gecco_tpu'}, loaded & {'jax', 'gecco_tpu'}\n"
        "sys.exit(code)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (inputs / "nojax" / "genome.features.tsv").read_text().count("\n") > N_GENES // 2


# --- annotate, predict, train, cv, convert ---------------------------------------

COMMANDS = ["annotate", "run", "predict", "train", "cv", "convert"]
#: each CLI's runner and the options that put it on the path of the other's
#: comparisons: the JAX search on its Pallas kernels (interpret mode), the
#: port on the CPU
CLIS = {"jax": (jax_main, ["--backend", "pallas"], []),
        "port": (main, ["--device", "cpu"], ["--device", "cpu"])}


def _cli(runner, argv):
    stream = io.StringIO()
    code = runner([str(a) for a in argv], stream)
    assert code == 0, stream.getvalue()


def _read(out, kind):
    return (out / f"genome.{kind}.tsv").read_text()


@pytest.fixture(scope="module")
def port_run(inputs):
    out = inputs / "port_run"
    _run(inputs, out, main, ["--device", "cpu"])
    return out


@pytest.fixture(scope="module")
def annotated(inputs):
    """``annotate`` of the genome by each CLI: its output directory."""
    outs = {}
    for name, (runner, search, _) in CLIS.items():
        outs[name] = inputs / f"annotate_{name}"
        _cli(runner, ["annotate", "-g", inputs / "genome.fna", "--hmm", inputs / "bank.h3m",
                      "-o", outs[name], "-j", "1", *search])
    return outs


def test_annotate_matches_jax_cli(annotated):
    mine, theirs = annotated["port"], annotated["jax"]
    assert _read(mine, "genes") == _read(theirs, "genes")
    assert len(_read(mine, "features").splitlines()) > N_GENES // 2
    _assert_tables_close(_read(mine, "features"), _read(theirs, "features"))


@pytest.mark.parametrize("package", ["jax", "port"])
def test_predict_from_annotate_gives_run_tables(inputs, annotated, jax_tables, port_run, package):
    runner, _, device = CLIS[package]
    tables = annotated[package]
    out = inputs / f"predict_{package}"
    _cli(runner, ["predict", "--genome", inputs / "genome.fna", "-g", tables / "genome.genes.tsv",
                  "-f", tables / "genome.features.tsv", "-o", out, "--force-tsv", "-j", "1", *device])
    run_dir = inputs / "jax" if package == "jax" else port_run
    for kind in ("genes", "features", "clusters"):
        assert _read(out, kind) == _read(run_dir, kind), kind
    assert len(_read(out, "clusters").splitlines()) > 1
    assert sorted(p.name for p in out.glob("*.gbk")) == sorted(p.name for p in run_dir.glob("*.gbk"))


def _undated(path):
    """A GenBank record without its ``creation_date`` line."""
    return [line for line in path.read_text().splitlines() if "creation_date" not in line]


@pytest.fixture(scope="module")
def training_tables(tmp_path_factory):
    """The synthetic training corpus of ``tests/test_cli.py``'s ``train``
    and ``cv`` tests as tables: genes, their domains, and one cluster row
    for each contig's planted run, typed Polyketide or Terpene."""
    from test_torch_train import PORT, _synthetic_genes

    from gecco_tpu_torch.model import ClusterTable, FeatureTable, GeneTable

    tmp = tmp_path_factory.mktemp("torch_training_tables")
    genes = _synthetic_genes(PORT, n_contigs=6, length=40, seed=3)
    with open(tmp / "genes.tsv", "wb") as f:
        GeneTable.from_genes(genes).dump(f)
    with open(tmp / "features.tsv", "wb") as f:
        FeatureTable.from_genes(genes).dump(f)
    rows = {key: [] for key in ("sequence_id", "cluster_id", "start", "end", "average_p",
                                "max_p", "type", "proteins", "domains")}
    by_source = {}
    for g in genes:
        by_source.setdefault(g.source.id, []).append(g)
    for seq_id, group in by_source.items():
        inside = [g for g in group if g.average_probability == 1.0]
        rows["sequence_id"].append(seq_id)
        rows["cluster_id"].append(f"{seq_id}_cluster_1")
        rows["start"].append(min(g.start for g in inside))
        rows["end"].append(max(g.end for g in inside))
        rows["average_p"].append(1.0)
        rows["max_p"].append(1.0)
        rows["type"].append("Polyketide" if seq_id < "ctg3" else "Terpene")
        rows["proteins"].append(";".join(g.protein.id for g in inside))
        rows["domains"].append("")
    with open(tmp / "clusters.tsv", "wb") as f:
        ClusterTable(rows).dump(f)
    return tmp


def _tables_args(tables):
    return ["-g", tables / "genes.tsv", "-f", tables / "features.tsv",
            "-c", tables / "clusters.tsv"]


#: the training options of ``tests/test_cli.py``'s ``train`` and ``cv``
TRAINING = ["-W", "10", "--c1", "0.05", "--c2", "0.0", "--seed", "42"]


def test_train_matches_jax_cli(training_tables):
    import scipy.sparse

    from test_torch_train import PORT, _stripped, _synthetic_genes

    from gecco_tpu_torch.crf import ClusterCRF

    models = {}
    for name, (runner, _, device) in CLIS.items():
        models[name] = training_tables / f"model_{name}"
        _cli(runner, ["train", *_tables_args(training_tables), "-o", models[name],
                      *TRAINING, *device])
    mine, theirs = models["port"], models["jax"]
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
    for name in ("crf_model.npz", "crf_model.npz.sha256", "model.trans.tsv",
                 "model.state.tsv", "domains.tsv", "types.tsv", "compositions.npz",
                 "forest.npz"):
        assert (mine / name).exists(), name
    for name in ("domains.tsv", "types.tsv"):
        assert (mine / name).read_text() == (theirs / name).read_text()
    numpy.testing.assert_array_equal(
        scipy.sparse.load_npz(mine / "compositions.npz").toarray(),
        scipy.sparse.load_npz(theirs / "compositions.npz").toarray())
    a, b = ClusterCRF.trained(mine), ClusterCRF.trained(theirs)
    assert a.attr_names == b.attr_names
    genes = _stripped(_synthetic_genes(PORT, n_contigs=6, length=40, seed=3), PORT)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pa = [g.average_probability for g in a.predict_probabilities(genes, device="cpu")]
        pb = [g.average_probability for g in b.predict_probabilities(genes, device="cpu")]
    numpy.testing.assert_allclose(pa, pb, atol=2e-2, rtol=0)


def _cv_rows(path):
    rows = [line.split("\t") for line in path.read_text().splitlines() if line]
    header = rows[0]
    return [{key: value for key, value in zip(header, row)} for row in rows[1:]]


def test_cv_matches_jax_cli(training_tables):
    outputs = {}
    for name, (runner, _, device) in CLIS.items():
        outputs[name] = training_tables / f"cv_{name}.tsv"
        _cli(runner, ["cv", *_tables_args(training_tables), "-o", outputs[name],
                      "--splits", "3", *TRAINING, *device])
    mine, theirs = _cv_rows(outputs["port"]), _cv_rows(outputs["jax"])
    assert len(mine) == 6 * 40
    keys = ("sequence_id", "protein_id", "start", "end", "fold")
    assert [[r[k] for k in keys] for r in mine] == [[r[k] for k in keys] for r in theirs]
    assert {r["fold"] for r in mine} == {"1", "2", "3"}
    numpy.testing.assert_allclose([float(r["average_p"]) for r in mine],
                                  [float(r["average_p"]) for r in theirs], atol=2e-2, rtol=0)
    # each row's label is its own gene's (the JAX CLI pairs a fold's
    # predictions, sorted by contig, with its labels in fold order)
    from test_torch_train import PORT, _synthetic_genes

    truth = {g.protein.id: "true" if g.average_probability == 1.0 else "false"
             for g in _synthetic_genes(PORT, n_contigs=6, length=40, seed=3)}
    assert [r["is_cluster"] for r in mine] == [truth[r["protein_id"]] for r in mine]
    from gecco_tpu_torch.crf.metrics import roc_auc_score

    assert roc_auc_score([r["is_cluster"] == "true" for r in mine],
                         [float(r["average_p"]) for r in mine]) > 0.9


def test_models_carry_across_clis(inputs, annotated, jax_tables, port_run):
    """Each CLI trains on ``run``'s tables; each model then predicts from
    the port's ``annotate`` tables through both CLIs' ``predict --model``,
    which must write the same tables and GenBank records (float64 host
    decode on both sides)."""
    for trainer, (runner, _, device) in CLIS.items():
        run_dir = inputs / "jax" if trainer == "jax" else port_run
        model = inputs / f"run_model_{trainer}"
        _cli(runner, ["train", "-g", run_dir / "genome.genes.tsv",
                      "-f", run_dir / "genome.features.tsv",
                      "-c", run_dir / "genome.clusters.tsv", "-o", model, *device])
        assert (model / "crf_model.npz").exists() and (model / "model.state.tsv").exists()
        tables = {}
        for name, (predictor, _, predict_device) in CLIS.items():
            out = inputs / f"predict_{name}_with_{trainer}_model"
            _cli(predictor, ["predict", "--genome", inputs / "genome.fna",
                             "-g", annotated["port"] / "genome.genes.tsv",
                             "-f", annotated["port"] / "genome.features.tsv",
                             "-o", out, "--model", model, "--force-tsv", "-j", "1",
                             *predict_device])
            tables[name] = [_read(out, kind) for kind in ("genes", "features", "clusters")]
            tables[name] += [_undated(path) for path in sorted(out.glob("*.gbk"))]
        assert len(tables["port"]) > 3
        assert tables["port"] == tables["jax"], trainer


@pytest.mark.parametrize("what, fmt", [("gbk", "fna"), ("gbk", "faa"), ("gbk", "bigslice"),
                                       ("clusters", "gff")])
def test_convert_matches_jax_cli(inputs, jax_tables, what, fmt):
    source = inputs / "jax"
    assert list(source.glob("*_cluster_*.gbk"))
    written = {}
    for name, (runner, _, _) in CLIS.items():
        out = inputs / f"convert_{name}_{what}_{fmt}"
        _cli(runner, ["convert", what, "-i", source, "-o", out, "-f", fmt])
        written[name] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
    assert written["port"] and written["port"] == written["jax"]


def _options(configure, name):
    parser = configure("prog", "0", {})
    sub = next(a for a in parser._actions if a.dest == "command").choices[name]
    options = set()
    for action in sub._actions:
        options.update(action.option_strings)
        for child in getattr(action, "choices", None) or {}:
            if isinstance(action.choices, dict):
                options.update(f"{child}:{o}" for a in action.choices[child]._actions
                               for o in a.option_strings)
    return options


@pytest.mark.parametrize("command", COMMANDS)
def test_help_of_every_subcommand(command):
    """``--help`` of each subcommand, and its options are the JAX CLI's
    (``--devices``, ``--profile`` and ``--backend`` included) but for the
    device: ``--device``, on the search's and the CRF's subcommands."""
    stream = io.StringIO()
    assert main([command, "--help"], stream) == 0
    assert stream.getvalue().startswith(f"usage: gecco-tpu-torch {command}")
    mine = _options(configure_parser, command) - {"--device"}
    theirs = _options(jax_configure_parser, command)
    assert mine == theirs
    if command != "convert":
        assert "--device" in _options(configure_parser, command)
