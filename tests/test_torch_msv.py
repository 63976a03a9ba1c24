"""The MSV filter stage (kernel I's plain version on the CPU) against JAX.

The kernel wrapper, given CPU tensors, runs its plain PyTorch version;
the same inputs (numpy, from seeds) go through the JAX package's
``MSVKernel`` (``_pallas_msv``) in interpret mode, its XLA engine
``batch.msv_scores`` and its host oracle ``engine.msv_score``, on a bank
whose profiles all sit below the padded width and on one with a profile
of exactly 128 nodes (the TPU kernel's lane-0 ``masked`` case).
Tolerance: 5e-3 nats, the JAX package's own kernel-parity gate; the F1
survivor matrices must be equal.  ``SearchPipeline(filter_stage="msv")``
and ``bias_filter=False`` are held against the JAX Pallas search on the
multidomain workload of ``test_torch_pipeline.py``, with its gates:
identical funnel, hits and domain coordinates, sequence scores within
5e-3 bits, domain scores within 5e-2.
"""

import numpy
import pytest
import torch

from gecco_tpu.hmm import batch, engine
from gecco_tpu.hmm.kernels import Bucketed, MSVKernel
from gecco_tpu.hmm.kernels import SeqPack as JaxSeqPack
from gecco_tpu.hmm.pipeline import SearchPipeline as JaxSearchPipeline
from gecco_tpu.hmm.synthetic import plant_domain, synthetic_profiles, synthetic_proteins

from gecco_tpu_torch.hmm.bank import NEG, TorchBank
from gecco_tpu_torch.hmm.kernels import SeqPack, msv_filter, pack_mask, ssv_filter
from gecco_tpu_torch.hmm.pipeline import SearchPipeline

from test_torch_pipeline import _port, multidomain_inputs

torch.set_num_threads(1)
TOL = 5e-3


def _workload(last_length):
    """Profiles of 30-100 nodes plus one of ``last_length``, and proteins
    with planted domains (lengths not multiples of 4) and the consensus of
    the last profile ending on its last node."""
    profiles = synthetic_profiles(4, min_length=30, max_length=100, seed=7)
    profiles += synthetic_profiles(1, min_length=last_length, max_length=last_length, seed=3)
    rng = numpy.random.default_rng(2)
    seqs = [x[:130] for x in synthetic_proteins(5, mean_length=90, seed=8)]
    for i in range(len(seqs)):
        gm = profiles[i % len(profiles)]
        seqs[i] = plant_domain(seqs[i], gm, rng, offset=5, max_len=min(50, gm.M),
                               divergence=0.2)
    cons = numpy.argmax(profiles[-1].hmm.match[1:, :20], axis=1).astype(numpy.int32)
    seqs.append(numpy.concatenate([rng.integers(0, 20, 3).astype(numpy.int32), cons]))
    assert any(len(x) % 4 for x in seqs)
    host = batch.ProfileBank.build(profiles)
    return profiles, seqs, host, TorchBank.build(_port(profiles), "cpu")


@pytest.fixture(scope="module", params=[127, 128], ids=["unmasked", "masked"])
def workload(request):
    return _workload(request.param)


def test_msv_filter_matches_pallas_batch_and_host(workload):
    profiles, seqs, host, bank = workload
    kern = MSVKernel(host, seq_tile=4, profile_chunk=8)
    assert kern.masked == (max(gm.M for gm in profiles) == 128)
    mine = msv_filter(SeqPack(seqs, "cpu"), bank).numpy()
    numpy.testing.assert_allclose(mine, kern(seqs, interpret=True), atol=TOL, rtol=0)
    numpy.testing.assert_allclose(mine, numpy.asarray(batch.msv_scores(host, seqs)),
                                  atol=TOL, rtol=0)
    for s, x in enumerate(seqs):
        for p, gm in enumerate(profiles):
            assert mine[s, p] == pytest.approx(engine.msv_score(gm, x), abs=TOL), (s, p)


def test_msv_not_below_ssv(workload):
    _profiles, seqs, _host, bank = workload
    pack = SeqPack(seqs, "cpu")
    msv, ssv = msv_filter(pack, bank), ssv_filter(pack, bank)
    assert (msv >= ssv - 1e-4).all()
    assert (msv > ssv + 1e-3).any()  # the J loop adds segments somewhere


def test_msv_empty_sequence_scores_neg(workload):
    _profiles, seqs, _host, bank = workload
    scores = msv_filter(SeqPack([seqs[0], numpy.zeros(0, dtype=numpy.int32)], "cpu"), bank)
    assert (scores[1] == numpy.float32(NEG)).all()
    assert (scores[0] > -1e29).all()


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("F1", [0.2, 0.02])
def test_msv_survivors_match_pallas_masks(workload, F1, bias):
    _profiles, seqs, host, bank = workload
    pack = SeqPack(seqs, "cpu")
    mine = pack_mask(msv_filter(pack, bank), pack, bank, F1, bias=bias)
    jax_pack = JaxSeqPack(seqs, 1 << (max(map(len, seqs)) - 1).bit_length())
    theirs = Bucketed(MSVKernel, host, pow2=True).masks(jax_pack, F1, interpret=True, bias=bias)
    assert mine.shape == theirs.shape
    assert 0 < mine.sum() < mine.size
    numpy.testing.assert_array_equal(mine, theirs)


@pytest.fixture(scope="module")
def multidomain():
    profiles, seqs = multidomain_inputs()
    return profiles, _port(profiles), seqs


def _assert_same_search(pipeline, hits, reference, expected):
    assert pipeline.stage_counts == reference.stage_counts
    assert [(h.sequence_index, h.profile.name) for h in hits] == [
        (h.sequence_index, h.profile.name) for h in expected]
    assert sum(len(h.domains) >= 2 for h in hits) >= 3
    for a, b in zip(hits, expected):
        assert a.score == pytest.approx(b.score, abs=5e-3)
        assert a.evalue == pytest.approx(b.evalue, rel=1e-2)
        assert [(d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from, d.hmm_to)
                for d in a.domains] == [
            (d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from, d.hmm_to)
            for d in b.domains]
        for da, db in zip(a.domains, b.domains):
            assert da.bitscore == pytest.approx(db.bitscore, abs=5e-2)


@pytest.fixture(scope="module")
def jax_searches(multidomain):
    """The JAX Pallas search of each option set, run once."""
    jax_profiles, _profiles, seqs = multidomain
    done = {}

    def search(filter_stage, bias_filter):
        key = (filter_stage, bias_filter)
        if key not in done:
            reference = JaxSearchPipeline(jax_profiles, Z=6, domZ=6, backend="pallas",
                                          filter_stage=filter_stage, bias_filter=bias_filter)
            done[key] = reference, reference.search(seqs)
        return done[key]

    return search


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("filter_stage, bias_filter", [
    ("msv", True), ("msv", False), ("ssv", False)])
def test_search_options_match_jax_pallas_pipeline(multidomain, jax_searches, backend,
                                                  filter_stage, bias_filter):
    _jax_profiles, profiles, seqs = multidomain
    reference, expected = jax_searches(filter_stage, bias_filter)
    pipeline = SearchPipeline(profiles, device="cpu", Z=6, domZ=6, backend=backend,
                              filter_stage=filter_stage, bias_filter=bias_filter)
    hits = pipeline.search(seqs)
    _assert_same_search(pipeline, hits, reference, expected)
    assert pipeline.stage_cells["filter"] > pipeline.stage_cells["viterbi"] > 0


def test_invalid_filter_stage_raises():
    with pytest.raises(ValueError, match="filter stage"):
        SearchPipeline([], device="cpu", filter_stage="fwd")
