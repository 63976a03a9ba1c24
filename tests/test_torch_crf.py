"""``marginals_torch`` and the port's ClusterCRF against the JAX package."""

import numpy
import pytest
import torch

import gecco_tpu.model
import gecco_tpu.seq
from gecco_tpu.crf import ClusterCRF as JaxClusterCRF
from gecco_tpu.crf.decode import marginals_jax, marginals_numpy

import gecco_tpu_torch.model
import gecco_tpu_torch.seq
from gecco_tpu_torch.crf import ClusterCRF
from gecco_tpu_torch.crf.decode import marginals_numpy as port_marginals_numpy
from gecco_tpu_torch.crf.decode import marginals_torch

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(7, 5, 2), (33, 20, 2), (4, 3, 3)])
def test_marginals_torch_matches_jax_and_numpy(shape):
    rng = numpy.random.default_rng(sum(shape))
    emissions = (rng.normal(size=shape) * 2.0).astype(numpy.float32)
    trans = rng.normal(size=shape[-1:] * 2).astype(numpy.float32)
    mine = marginals_torch(emissions, trans, device="cpu").numpy()
    assert mine.shape == shape
    numpy.testing.assert_allclose(mine, numpy.asarray(marginals_jax(emissions, trans)),
                                  atol=1e-5, rtol=0)
    numpy.testing.assert_allclose(mine, marginals_numpy(emissions, trans), atol=1e-5, rtol=0)
    numpy.testing.assert_array_equal(port_marginals_numpy(emissions, trans),
                                     marginals_numpy(emissions, trans))
    numpy.testing.assert_allclose(mine.sum(axis=-1), 1.0, atol=1e-5)


def _genes(n, rng, attrs, model, seq):
    """A chain of ``n`` genes built with the ``model`` and ``seq`` modules
    of one package (the JAX package's or the port's)."""
    source = seq.SeqRecord(id="contig", seq=seq.Seq("A" * (n * 100 + 10)))
    genes = []
    for i in range(n):
        domains = [
            model.Domain(str(a), 1, 10, "Pfam", 1e-10, 1e-12)
            for a in rng.choice(attrs, size=int(rng.integers(0, 3)), replace=False)
        ]
        protein = model.Protein(f"contig_{i + 1}", seq.Seq("M" * 30), domains=domains)
        genes.append(model.Gene(source, 1 + 100 * i, 90 + 100 * i, model.Strand.Coding, protein))
    return genes


@pytest.mark.parametrize("batch_decode", [True, False])
def test_cluster_crf_matches_jax_package(batch_decode):
    """The embedded model on a synthetic gene chain: probabilities equal
    the JAX package's (float64 host path) within float32 decode error."""
    jax_crf = JaxClusterCRF.trained()
    port_crf = ClusterCRF.trained()
    rng = numpy.random.default_rng(3)
    weighted = sorted(
        (a for a in jax_crf.attr_names if jax_crf.state_weight(a) is not None),
        key=jax_crf.state_weight)
    attrs = weighted[:20] + weighted[-20:]
    genes = _genes(40, numpy.random.default_rng(3), attrs, gecco_tpu.model, gecco_tpu.seq)
    port_genes = _genes(40, rng, attrs, gecco_tpu_torch.model, gecco_tpu_torch.seq)
    reference = jax_crf.predict_probabilities(genes, batch_decode=False)
    mine = port_crf.predict_probabilities(port_genes, batch_decode=batch_decode, device="cpu")
    a = numpy.array([g.average_probability for g in mine])
    b = numpy.array([g.average_probability for g in reference])
    tol = 1e-5 if batch_decode else 0.0
    numpy.testing.assert_allclose(a, b, atol=tol, rtol=0)
    assert a.max() > 0.5 > a.min()
    assert all(type(g).__module__ == "gecco_tpu_torch.model" for g in mine)


def test_cluster_crf_fit_not_ported():
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        ClusterCRF.trained().fit([])
