"""CRF training of the port (``gecco_tpu_torch.crf.train``) against the JAX
package's, on the CPU.

Every corpus is made from a seed with numpy and built twice, once with
each package's ``model`` and ``seq`` modules, so that both fits see the
same genes.  Bounds:

* ``_build_instances``: equal windows, labels and order;
* ``nll`` against a float64 numpy forward algorithm: 1e-5 relative on
  the objective, 1e-4 of the gradient's largest magnitude on each
  component (the float64 gradient by central differences);
* early iterations: ``state`` and ``trans`` within 1e-4 of JAX's;
* fits to convergence: ``last_objective_`` within 1e-4 relative,
  ``state`` within 0.25 (flat directions stop where the float32
  objective stops resolving, as ``tests/test_train.py`` bounds two
  optimizers on one optimum), predictions within 2e-2.

The copies of ``select``, ``cv`` and ``metrics`` are held against the JAX
package's on seeded inputs, and the fixture-free tests of
``tests/test_train.py`` are mirrored on the port.
"""

import math
import warnings

import numpy
import pytest
import torch

import gecco_tpu.model
import gecco_tpu.seq
from gecco_tpu.crf import ClusterCRF as JaxClusterCRF
from gecco_tpu.crf import cv as jax_cv
from gecco_tpu.crf import metrics as jax_metrics
from gecco_tpu.crf import select as jax_select
from gecco_tpu.crf import train as jax_train

import gecco_tpu_torch.model
import gecco_tpu_torch.seq
from gecco_tpu_torch.crf import ClusterCRF
from gecco_tpu_torch.crf import cv, metrics, select, train
from gecco_tpu_torch.model import Domain, Protein
from gecco_tpu_torch.seq import Seq

torch.set_num_threads(1)

JAX = (gecco_tpu.model, gecco_tpu.seq)
PORT = (gecco_tpu_torch.model, gecco_tpu_torch.seq)


def _synthetic_genes(package, n_contigs=6, length=40, seed=1, extra=0.0):
    """``tests/test_train.py::_synthetic_genes`` built with one package's
    modules: domains CLUST0-2 mark a planted run of each contig, BG0-4
    the background.  ``extra`` is the chance of a second domain (so that
    the domain feature type sees several a gene)."""
    model, seq = package
    rng = numpy.random.default_rng(seed)
    genes = []
    for c in range(n_contigs):
        source = seq.SeqRecord(id=f"ctg{c}", seq=seq.Seq(""))
        start_run = rng.integers(5, 15)
        run_len = rng.integers(8, 15)
        for i in range(length):
            in_cluster = start_run <= i < start_run + run_len
            names = []
            if in_cluster:
                if rng.random() < 0.8:
                    names.append("CLUST%d" % rng.integers(0, 3))
            else:
                if rng.random() < 0.6:
                    names.append("BG%d" % rng.integers(0, 5))
            if extra and rng.random() < extra:
                names.append("BG%d" % rng.integers(5, 8))
            p = 1.0 if in_cluster else 0.0
            domains = [
                model.Domain(n, 1 + 20 * k, 10 + 20 * k, "Pfam", 1e-10, 1e-12, probability=p)
                for k, n in enumerate(names)
            ]
            protein = model.Protein(f"ctg{c}_{i+1}", seq.Seq("M"), domains)
            genes.append(model.Gene(
                source, i * 100 + 1, i * 100 + 90, model.Strand.Coding, protein,
                _probability=p,
            ))
    return genes


def _stripped(genes, package):
    model = package[0]
    return [model.Gene(g.source, g.start, g.end, g.strand, g.protein, dict(g.qualifiers), None)
            for g in genes]


def _probabilities(crf, genes, package, **options):
    predicted = crf.predict_probabilities(_stripped(genes, package), **options)
    return numpy.array([g.average_probability for g in predicted])


def _fit_both(options, fit, seed=1):
    """The same fit through both packages; returns (JAX crf, port crf)."""
    jax_crf = JaxClusterCRF("protein", window_size=10, window_step=1, **options)
    port_crf = ClusterCRF("protein", window_size=10, window_step=1, **options)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fit(jax_crf, _synthetic_genes(JAX, seed=seed), {})
        fit(port_crf, _synthetic_genes(PORT, seed=seed), {"device": "cpu"})
    return jax_crf, port_crf


# --- instances and the objective ----------------------------------------------

@pytest.mark.parametrize("feature_type", ["protein", "domain"])
def test_build_instances_matches_jax(feature_type):
    jax_crf = JaxClusterCRF(feature_type, window_size=7, window_step=2)
    port_crf = ClusterCRF(feature_type, window_size=7, window_step=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_train._build_instances(
            jax_crf, _synthetic_genes(JAX, 5, 30, seed=4, extra=0.5), True, 7)
        got = train._build_instances(
            port_crf, _synthetic_genes(PORT, 5, 30, seed=4, extra=0.5), True, 7)
    assert len(got[0]) > 20
    assert got == want


def _nll64(state, trans, idx, y, c2):
    """Float64 forward algorithm of the summed window NLL (independent of
    both packages): per window, log Z by the forward recursion minus the
    labelled path's score."""
    total = 0.0
    for window, labels in zip(idx, y):
        e = state[window].sum(axis=1)  # [W, 2]
        path = e[numpy.arange(len(labels)), labels].sum()
        path += sum(trans[a, b] for a, b in zip(labels[:-1], labels[1:]))
        alpha = e[0]
        for t in range(1, len(e)):
            scores = alpha[:, None] + trans
            top = scores.max(axis=0)
            alpha = top + numpy.log(numpy.exp(scores - top).sum(axis=0)) + e[t]
        top = alpha.max()
        total += top + math.log(numpy.exp(alpha - top).sum()) - path
    return total + c2 * ((state ** 2).sum() + (trans ** 2).sum())


@pytest.mark.parametrize("c2", [0.0, 0.1])
def test_nll_and_gradient_match_float64_forward(c2):
    rng = numpy.random.default_rng(11)
    A, N, W, dmax = 7, 12, 6, 3
    idx = rng.integers(0, A + 1, size=(N, W, dmax)).astype(numpy.int32)
    y = rng.integers(0, 2, size=(N, W)).astype(numpy.int32)
    state = rng.normal(size=(A + 1, 2))
    state[A] = 0.0
    trans = rng.normal(size=(2, 2))

    s = torch.tensor(state, dtype=torch.float32, requires_grad=True)
    t = torch.tensor(trans, dtype=torch.float32, requires_grad=True)
    f = train.nll(s, t, torch.from_numpy(idx), torch.from_numpy(y), c2)
    gs, gt = torch.autograd.grad(f, (s, t))
    got = numpy.concatenate([gs.numpy().ravel(), gt.numpy().ravel()]).astype(numpy.float64)

    want_f = _nll64(state, trans, idx, y, c2)
    assert f.item() == pytest.approx(want_f, rel=1e-5)
    x = numpy.concatenate([state.ravel(), trans.ravel()])
    n_state = state.size
    h = 1e-6
    want = numpy.empty_like(x)
    for i in range(x.size):
        hi, lo = x.copy(), x.copy()
        hi[i] += h
        lo[i] -= h
        want[i] = (_nll64(hi[:n_state].reshape(A + 1, 2), hi[n_state:].reshape(2, 2), idx, y, c2)
                   - _nll64(lo[:n_state].reshape(A + 1, 2), lo[n_state:].reshape(2, 2), idx, y, c2)
                   ) / (2 * h)
    numpy.testing.assert_allclose(got, want, atol=1e-4 * numpy.abs(want).max(), rtol=0)


# --- fits against the JAX package ---------------------------------------------

@pytest.mark.parametrize("max_iterations", [1, 5])
@pytest.mark.parametrize("options", [{"c1": 0.0, "c2": 0.05}, {"c1": 0.05, "c2": 0.05}],
                         ids=["l2", "elastic"])
def test_fit_first_iterations_match_jax(options, max_iterations):
    """OWL-QN's first steps, with and without the L1 orthant projection.
    (With ``c2 = 0`` the L1 gauge fix zeroes the smaller of each feature's
    two weights, and the first steps from zero leave them equal in
    magnitude, a tie that float32 noise breaks either way: the weights
    then differ by a gauge shift that changes no probability, so that
    case is compared by its predictions, below.)"""
    jax_crf, port_crf = _fit_both(
        options, lambda crf, genes, kw: crf.fit(genes, max_iterations=max_iterations, **kw))
    assert port_crf.attr_names == jax_crf.attr_names
    numpy.testing.assert_allclose(port_crf.state, jax_crf.state, atol=1e-4, rtol=0)
    numpy.testing.assert_allclose(port_crf.trans, jax_crf.trans, atol=1e-4, rtol=0)
    assert port_crf.last_objective_ == pytest.approx(jax_crf.last_objective_, rel=1e-5)


def _adam_fit(crf, genes, kw):
    # a fixed number of steps: Adam's stopping test compares successive
    # float32 losses, which float noise would stop at different steps
    (jax_train if isinstance(crf, JaxClusterCRF) else train).fit_crf(
        crf, genes, max_iterations=1000, tolerance=0.0, **kw)


@pytest.mark.parametrize("case", ["l2", "l1", "adam"])
def test_fit_to_convergence_matches_jax(case):
    if case == "l2":
        options, fit = {"c1": 0.0, "c2": 0.05}, None
    elif case == "l1":
        options, fit = {"c1": 0.05, "c2": 0.0}, None
    else:
        options, fit = {"c1": 0.0, "c2": 0.05, "algorithm": "adam"}, _adam_fit
    fit = fit or (lambda crf, genes, kw: crf.fit(genes, max_iterations=300, **kw))
    jax_crf, port_crf = _fit_both(options, fit)
    assert port_crf.attr_names == jax_crf.attr_names
    mine = _probabilities(port_crf, _synthetic_genes(PORT), PORT, device="cpu")
    theirs = _probabilities(jax_crf, _synthetic_genes(JAX), JAX, batch_decode=False)
    numpy.testing.assert_allclose(mine, theirs, atol=2e-2, rtol=0)
    assert mine.max() > 0.8 and mine.min() < 0.2
    if case != "l1":
        assert port_crf.last_objective_ == pytest.approx(jax_crf.last_objective_, rel=1e-4)
        numpy.testing.assert_allclose(port_crf.state, jax_crf.state, atol=0.25, rtol=0)


def test_fit_on_cuda_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    crf = ClusterCRF("protein", window_size=10, c1=0.0, c2=0.05)
    with pytest.raises(RuntimeError, match="cuda"):
        crf.fit(_synthetic_genes(PORT), device="cuda", max_iterations=1)
    assert not crf.fitted


def test_models_carry_across_packages(tmp_path):
    """A model the port trained predicts in the JAX package, and one the
    JAX package trained predicts in the port, as each predicts itself."""
    jax_crf, port_crf = _fit_both(
        {"c1": 0.05, "c2": 0.0}, lambda crf, genes, kw: crf.fit(genes, max_iterations=100, **kw))
    port_crf.save(tmp_path / "port")
    jax_crf.save(tmp_path / "jax")
    in_jax = JaxClusterCRF.trained(tmp_path / "port")
    in_port = ClusterCRF.trained(tmp_path / "jax")
    numpy.testing.assert_array_equal(in_jax.state, port_crf.state)
    numpy.testing.assert_array_equal(in_port.state, jax_crf.state)
    numpy.testing.assert_allclose(
        _probabilities(in_jax, _synthetic_genes(JAX), JAX, batch_decode=False),
        _probabilities(port_crf, _synthetic_genes(PORT), PORT, device="cpu", batch_decode=False),
        atol=1e-12, rtol=0)
    numpy.testing.assert_allclose(
        _probabilities(in_port, _synthetic_genes(PORT), PORT, device="cpu", batch_decode=False),
        _probabilities(jax_crf, _synthetic_genes(JAX), JAX, batch_decode=False),
        atol=1e-12, rtol=0)


# --- the host copies against the JAX package's --------------------------------

def test_fisher_exact_matches_jax():
    rng = numpy.random.default_rng(2)
    for a, b, c, d in rng.integers(0, 60, size=(100, 4)):
        args = (int(a), int(b), int(c), int(d))
        assert select.fisher_exact_two_tailed(*args) == jax_select.fisher_exact_two_tailed(*args)


@pytest.mark.parametrize("method", ["bonferroni", "sidak", "holm", "fdr_bh", "fdr_by"])
def test_significance_correction_matches_jax(method):
    rng = numpy.random.default_rng(3)
    pvalues = {f"PF{i:05}": float(p) for i, p in enumerate(rng.random(40) ** 3)}
    assert (select.significance_correction(pvalues, method)
            == jax_select.significance_correction(pvalues, method))


@pytest.mark.parametrize("correction", [None, "fdr_bh"])
def test_fisher_significance_matches_jax(correction):
    mine = select.fisher_significance(
        (g.protein for g in _synthetic_genes(PORT, seed=5, extra=0.3)), correction)
    theirs = jax_select.fisher_significance(
        (g.protein for g in _synthetic_genes(JAX, seed=5, extra=0.3)), correction)
    assert list(mine.items()) == list(theirs.items())
    assert min(mine.values()) < 1e-3


def test_splitters_match_jax():
    for n, k, seed in [(25, 5, 42), (17, 3, 1), (9, 9, 0)]:
        mine = [(a.tolist(), b.tolist()) for a, b in cv.kfold(n, k=k, seed=seed)]
        theirs = [(a.tolist(), b.tolist()) for a, b in jax_cv.kfold(n, k=k, seed=seed)]
        assert mine == theirs
    groups = [["NRP"], ["Polyketide"], ["NRP", "Polyketide"], ["Terpene"], ["RiPP"], ["NRP"]]
    mine = [(a.tolist(), b.tolist()) for a, b in cv.LeaveOneGroupOut().split(range(6), groups=groups)]
    theirs = [(a.tolist(), b.tolist())
              for a, b in jax_cv.LeaveOneGroupOut().split(range(6), groups=groups)]
    assert mine == theirs
    assert cv.LeaveOneGroupOut().get_n_splits(groups=groups) == 4


def test_metrics_match_jax():
    rng = numpy.random.default_rng(6)
    labels = rng.random(200) < 0.3
    scores = numpy.round(rng.random(200), 2)  # ties
    assert metrics.roc_auc_score(labels, scores) == jax_metrics.roc_auc_score(labels, scores)
    assert (metrics.average_precision_score(labels, scores)
            == jax_metrics.average_precision_score(labels, scores))


# --- mirrors of tests/test_train.py ---------------------------------------------

def test_fisher_exact_matches_scipy():
    import scipy.stats

    rng = numpy.random.default_rng(0)
    for _ in range(50):
        a, b, c, d = rng.integers(0, 40, size=4)
        mine = select.fisher_exact_two_tailed(int(a), int(b), int(c), int(d))
        theirs = scipy.stats.fisher_exact([[a, b], [c, d]], alternative="two-sided").pvalue
        assert mine == pytest.approx(theirs, rel=1e-9), (a, b, c, d)


def test_fdr_bh_matches_reference_example():
    s = {"A": 0.6, "B": 0.05, "C": 1.0, "D": 0.0}
    corrected = select.significance_correction(s, method="fdr_bh")
    assert corrected["A"] == pytest.approx(0.8)
    assert corrected["B"] == pytest.approx(0.1)
    assert corrected["C"] == pytest.approx(1.0)
    assert corrected["D"] == pytest.approx(0.0)


def test_fisher_significance_reference_example():
    def protein(i, names, p):
        return Protein(f"prot{i}", Seq(""), [
            Domain(n, 1, 2, "Pfam", 0.0, 0.0, probability=p) for n in names
        ])

    data = [
        protein(1, "AB", 1), protein(2, "AB", 1), protein(3, "AB", 1),
        protein(4, "A", 1), protein(5, "A", 1),
        protein(6, "CB", 0), protein(7, "C", 0),
    ]
    sig = select.fisher_significance(data)
    assert sig["A"] == pytest.approx(0.0714285714, abs=1e-6)
    assert sig["B"] == pytest.approx(1.0)
    assert sig["C"] == pytest.approx(0.0714285714, abs=1e-6)


def test_loto_split_reference_example():
    loto = cv.LeaveOneGroupOut()
    groups = [["a"], ["b"], ["c"], ["a", "b"]]
    splits = [(t.tolist(), s.tolist()) for t, s in loto.split(range(4), groups=groups)]
    assert splits == [([1, 2], [0]), ([0, 2], [1]), ([0, 1, 3], [2])]
    assert loto.get_n_splits(groups=groups) == 3


def test_kfold_partitions():
    folds = list(cv.kfold(25, k=5))
    assert len(folds) == 5
    all_test = sorted(i for _, test in folds for i in test)
    assert all_test == list(range(25))


def _separates(crf, genes, **options):
    truth = {g.protein.id: g.average_probability for g in genes}
    predicted = crf.predict_probabilities(_stripped(genes, PORT), device="cpu", **options)
    inside = [g.average_probability for g in predicted if truth[g.protein.id] == 1.0]
    outside = [g.average_probability for g in predicted if truth[g.protein.id] == 0.0]
    return numpy.mean(inside), numpy.mean(outside)


def test_fit_and_predict_roundtrip(tmp_path):
    genes = _synthetic_genes(PORT)
    crf = ClusterCRF("protein", window_size=10, window_step=1, c1=0.05, c2=0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        crf.fit(genes, max_iterations=300, device="cpu")
    assert crf.fitted
    assert any(name.startswith("CLUST") for name in crf.attr_names)
    # cluster-marker domains must weigh towards label '1'.  The L1 gauge
    # fix puts a feature's weight on one label: the one whose weight is
    # smaller in magnitude is zeroed, and the first fit leaves the two
    # equal but for float32 noise, so which label carries it is the
    # noise's choice (the port's CPU fit zeroes label 1 of these, the JAX
    # package's label 0); the difference of the two is what predicts
    for name in crf.attr_names:
        if name.startswith("CLUST"):
            weights = crf.state[crf.attr_names.index(name)]
            assert weights[1] - weights[0] > 0.2
    inside, outside = _separates(crf, genes)
    assert inside > 0.8 and outside < 0.2
    crf.save(tmp_path)
    loaded = ClusterCRF.trained(tmp_path)
    assert loaded.attr_names == crf.attr_names
    numpy.testing.assert_allclose(loaded.state, crf.state)
    numpy.testing.assert_allclose(loaded.trans, crf.trans)


def test_fit_with_selection():
    genes = _synthetic_genes(PORT)
    crf = ClusterCRF("protein", window_size=10, window_step=1, c1=0.05)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        crf.fit(genes, select=0.5, max_iterations=50, device="cpu")
    assert crf.significance is not None
    assert crf.significant_features is not None
    assert all(name in crf.significant_features for name in crf.attr_names)


def test_owlqn_matches_adam_optimum_and_sparsifies():
    genes = _synthetic_genes(PORT)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        crf_a = ClusterCRF("protein", window_size=10, algorithm="adam", c1=0.0, c2=0.05)
        crf_b = ClusterCRF("protein", window_size=10, algorithm="lbfgs", c1=0.0, c2=0.05)
        crf_a.fit(list(genes), max_iterations=4000, device="cpu")
        crf_b.fit(list(genes), max_iterations=300, device="cpu")
    assert crf_a.attr_names == crf_b.attr_names
    assert crf_b.last_objective_ <= crf_a.last_objective_ + 1e-3
    numpy.testing.assert_allclose(crf_a.state, crf_b.state, atol=0.25)

    rng = numpy.random.default_rng(9)
    noisy = []
    for g in genes:
        domains = list(g.protein.domains)
        if rng.random() < 0.5:
            domains = domains + [Domain(
                "NOISE%d" % rng.integers(0, 4), 1, 10, "Pfam", 1e-10, 1e-12,
                probability=g.average_probability,
            )]
        noisy.append(g.with_protein(g.protein.with_domains(domains)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        crf_l1 = ClusterCRF("protein", window_size=10, algorithm="lbfgs", c1=0.3, c2=0.0)
        crf_l1.fit(list(noisy), max_iterations=300, device="cpu")
    noise_rows = [i for i, n in enumerate(crf_l1.attr_names) if n.startswith("NOISE")]
    assert (numpy.abs(crf_l1.state[noise_rows]) < 1e-12).sum() > 0
    inside, outside = _separates(crf_l1, noisy)
    assert inside > 0.8 and outside < 0.2

