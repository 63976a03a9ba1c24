"""Kernel H (dense all-pairs Forward/Viterbi) and the ``max_filter`` search
against the JAX package, at a small size on the CPU.

The kernel wrapper, given CPU tensors, runs its plain PyTorch version;
the same inputs (numpy, from seeds) go through the JAX package's
``Bucketed(ForwardKernel | ViterbiKernel)`` (``_pallas_fwd``) in interpret
mode.  Tolerances: 1e-3 nats against the TPU kernel (float32 sums in
another order; the TPU kernel also truncates its delete chain at
``dchain_depth``, the port does not), 5e-3 nats against the pair kernels
B and C, which compute the same functions by other recurrences.  The
``max_filter`` search (hmmsearch ``--max``) must give JAX's survivor
funnel, hits and domain coordinates, sequence scores within 5e-3 bits
and domain scores within 5e-2 (``tools/tpu_check.py``'s gates).
"""

import numpy
import pytest
import torch

from gecco_tpu.hmm.batch import ProfileBank
from gecco_tpu.hmm.calibrate import calibrate as jax_calibrate
from gecco_tpu.hmm.kernels import Bucketed, ForwardKernel, ViterbiKernel
from gecco_tpu.hmm.pipeline import SearchPipeline as JaxSearchPipeline
from gecco_tpu.hmm.synthetic import plant_domain, synthetic_profiles, synthetic_proteins

from gecco_tpu_torch.hmm.bank import TorchBank
from gecco_tpu_torch.hmm.kernels import (
    SeqPack, dense_scores, dense_scores_plain, viterbi_pairs)
from gecco_tpu_torch.hmm.pipeline import SearchPipeline
from gecco_tpu_torch.hmm.profile import profiles_from_arrays
from gecco_tpu_torch.hmm.stream import forward_pairs

torch.set_num_threads(1)

KERNELS = {"forward": ForwardKernel, "viterbi": ViterbiKernel}


def _port(profiles):
    """The port's copies of JAX profiles, from their plain fields."""
    return profiles_from_arrays([vars(gm.hmm) for gm in profiles])


@pytest.fixture(scope="module")
def workload():
    """Two width classes (profiles of 30-200 nodes and one of 128, the
    class cap), planted proteins of 40-180 residues and an empty one."""
    profiles = synthetic_profiles(5, min_length=30, max_length=200, seed=7)
    profiles += synthetic_profiles(1, min_length=128, max_length=128, seed=3)
    rng = numpy.random.default_rng(2)
    seqs = [x[:180] for x in synthetic_proteins(5, mean_length=140, seed=8)]
    for i in range(len(seqs)):
        gm = profiles[(2 * i) % len(profiles)]
        seqs[i] = plant_domain(seqs[i], gm, rng, offset=5, max_len=min(60, gm.M),
                               divergence=0.2)
    seqs.append(numpy.zeros(0, dtype=numpy.int32))
    bank = TorchBank.build(_port(profiles), "cpu")
    assert [w for w, _ in bank.classes] == [128, 256]
    return profiles, seqs, SeqPack(seqs, "cpu"), bank


@pytest.mark.parametrize("semiring", ["forward", "viterbi"])
def test_dense_plain_matches_jax_bucketed(workload, semiring):
    profiles, seqs, pack, bank = workload
    mine = dense_scores(pack, bank, viterbi=semiring == "viterbi").numpy()
    theirs = Bucketed(KERNELS[semiring], ProfileBank.build(profiles), seq_tile=4,
                      profile_chunk=8)(seqs, interpret=True)
    assert mine.shape == theirs.shape == (len(seqs), len(profiles))
    numpy.testing.assert_allclose(mine[:-1], theirs[:-1], atol=1e-3, rtol=0)
    # the empty sequence: log(C move + 1e-38) with C = 0 and the float32
    # subnormal flushed, as the JAX kernel computes it here
    assert numpy.isneginf(theirs[-1]).all() and numpy.isneginf(mine[-1]).all()


@pytest.mark.parametrize("semiring", ["forward", "viterbi"])
def test_dense_plain_matches_jax_masked_profile(workload, semiring):
    """A bank whose widest profile fills its padded width (the TPU
    kernel's ``masked`` node shift)."""
    profiles, seqs, pack, _bank = workload
    capped = [profiles[-1], profiles[3], profiles[4]]
    host = ProfileBank.build(capped)
    kernel = KERNELS[semiring](host, seq_tile=4, profile_chunk=8)
    assert kernel.masked and host.Mp == capped[0].M == 128
    theirs = kernel(seqs, interpret=True)
    mine = dense_scores(pack, TorchBank.build(_port(capped), "cpu"),
                        viterbi=semiring == "viterbi").numpy()
    numpy.testing.assert_allclose(mine[:-1], theirs[:-1], atol=1e-3, rtol=0)


@pytest.mark.parametrize("semiring", ["forward", "viterbi"])
def test_dense_plain_matches_pair_kernels(workload, semiring):
    """Kernel H against kernel C (Forward) and B (log-space Viterbi) on
    every pair of the non-empty sequences."""
    profiles, seqs, pack, bank = workload
    n = len(seqs) - 1
    s_idx = numpy.repeat(numpy.arange(n), len(profiles))
    p_idx = numpy.tile(numpy.arange(len(profiles)), n)
    pair = forward_pairs if semiring == "forward" else viterbi_pairs
    dense = dense_scores_plain(pack, bank, viterbi=semiring == "viterbi").numpy()
    numpy.testing.assert_allclose(dense[s_idx, p_idx], pair(pack, bank, s_idx, p_idx).numpy(),
                                  atol=5e-3, rtol=0)


@pytest.fixture(scope="module")
def multidomain():
    """``tests/test_torch_pipeline.py``'s multidomain workload plus an
    empty sequence, and JAX's Pallas ``max_filter`` search of it."""
    profiles = synthetic_profiles(6, min_length=40, max_length=80, seed=21)
    jax_calibrate(profiles, n=160, L=160, seed=5)
    rng = numpy.random.default_rng(11)
    seqs = [x[:448] for x in synthetic_proteins(8, mean_length=400, seed=13)]
    for i in range(len(seqs)):
        gm = profiles[i % len(profiles)]
        x = seqs[i]
        copies = 2 + (i % 2)
        stride = max(gm.M + 30, len(x) // (copies + 1))
        for c in range(copies):
            off = 12 + c * stride
            if off + gm.M + 10 < len(x):
                x = plant_domain(x, gm, rng, offset=off, max_len=gm.M, divergence=0.15)
        seqs[i] = x
    seqs.append(numpy.zeros(0, dtype=numpy.int32))
    reference = JaxSearchPipeline(profiles, Z=6, domZ=6, max_filter=True, backend="pallas")
    hits = reference.search(seqs)
    return _port(profiles), seqs, hits, reference.stage_counts


def _assert_same_hits(hits, expected):
    assert [(h.sequence_index, h.profile.name) for h in hits] == [
        (h.sequence_index, h.profile.name) for h in expected]
    for a, b in zip(hits, expected):
        assert a.score == pytest.approx(b.score, abs=5e-3)
        assert a.evalue == pytest.approx(b.evalue, rel=1e-2)
        assert len(a.domains) == len(b.domains)
        for da, db in zip(a.domains, b.domains):
            assert (da.ienv, da.jenv) == (db.ienv, db.jenv)
            assert (da.target_from, da.target_to) == (db.target_from, db.target_to)
            assert (da.hmm_from, da.hmm_to) == (db.hmm_from, db.hmm_to)
            assert da.bitscore == pytest.approx(db.bitscore, abs=5e-2)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_max_filter_search_matches_jax_pipeline(multidomain, backend):
    profiles, seqs, expected, expected_counts = multidomain
    pipeline = SearchPipeline(profiles, device="cpu", Z=6, domZ=6, max_filter=True,
                              backend=backend)
    hits = pipeline.search(seqs)
    pairs = len(seqs) * len(profiles)
    assert pipeline.stage_counts == expected_counts
    assert pipeline.stage_counts["F1"] == pipeline.stage_counts["F2"] == pairs
    assert pipeline.stage_cells["filter"] == 0.0 and pipeline.stage_cells["forward"] > 0
    assert set(pipeline.stage_seconds) == {"filter", "viterbi", "forward", "domains"}
    _assert_same_hits(hits, expected)
    # the empty sequence reaches the candidates (E-value gate only) and
    # reports no hit
    assert all(h.sequence_index != len(seqs) - 1 for h in hits)
    # a second search reuses the cached device bank
    bank = pipeline.bank
    again = pipeline.search(seqs)
    assert pipeline.bank is bank
    assert pipeline.stage_counts == expected_counts
    _assert_same_hits(again, expected)


def test_max_filter_hits_contain_default_hits(multidomain):
    profiles, seqs, _expected, _counts = multidomain
    default = SearchPipeline(profiles, device="cpu", Z=6, domZ=6, backend="torch")
    maxp = SearchPipeline(profiles, device="cpu", Z=6, domZ=6, max_filter=True,
                          backend="torch")
    base = {(h.sequence_index, h.profile.name) for h in default.search(seqs)}
    got = {(h.sequence_index, h.profile.name) for h in maxp.search(seqs)}
    assert base and base <= got and len(got) > len(base)
    assert default.stage_counts["F1"] < maxp.stage_counts["F1"]


def test_max_filter_bit_cutoffs(multidomain):
    """With bit cutoffs every pair is a candidate; the GA cutoff gates."""
    profiles, seqs, _expected, _counts = multidomain
    for gm in profiles:
        gm.hmm.cutoffs = {"GA": (20.0, 20.0)}
    pipeline = SearchPipeline(profiles, device="cpu", Z=6, domZ=6, max_filter=True,
                              bit_cutoffs="gathering", backend="torch")
    try:
        hits = pipeline.search(seqs[:3])
    finally:
        for gm in profiles:
            gm.hmm.cutoffs = {}
    assert hits and all(h.score >= 20.0 for h in hits)
    assert len(hits) <= pipeline.stage_counts["F3"] < 3 * len(profiles)
