"""The port's ``run`` command against the JAX package's, and without JAX.

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
"""

import io
import os
import subprocess
import sys

import numpy
import pytest
import torch

from gecco_tpu.cli import main as jax_main
from gecco_tpu.crf import ClusterCRF
from gecco_tpu.hmm.calibrate import calibrate
from gecco_tpu.hmm.h3m import write_h3m
from gecco_tpu.hmm.io import AMINO_ALPHABET, BACKGROUND_F
from gecco_tpu.hmm.synthetic import plant_domain, synthetic_profiles
from gecco_tpu.seq import translate

from gecco_tpu_torch.cli import main

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
    """With ``jax`` blocked, the port's CLI ``run`` completes on the CPU."""
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from gecco_tpu_torch.cli import main\n"
        f"code = main(['run', '-g', {str(inputs / 'genome.fna')!r}, "
        f"'--hmm', {str(inputs / 'bank.h3m')!r}, '-o', {str(inputs / 'nojax')!r}, "
        "'--device', 'cpu', '--force-tsv', '-j', '1'])\n"
        "assert 'jax' not in [m.split('.')[0] for m, v in sys.modules.items() if v is not None]\n"
        "sys.exit(code)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (inputs / "nojax" / "genome.features.tsv").read_text().count("\n") > N_GENES // 2
