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

import dataclasses

import numpy
import pytest
import torch

from gecco_tpu.hmm import batch, engine
from gecco_tpu.hmm.kernels import Bucketed, MSVKernel
from gecco_tpu.hmm.kernels import SeqPack as JaxSeqPack
from gecco_tpu.hmm.pipeline import SearchPipeline as JaxSearchPipeline
from gecco_tpu.hmm.synthetic import plant_domain, synthetic_profiles, synthetic_proteins

from gecco_tpu_torch.hmm.bank import NEG, TorchBank
from gecco_tpu_torch.hmm.kernels import (
    MSV_LANES, SeqPack, msv_filter, msv_filter_plain, msv_nodes, msv_states_plain, msv_tile,
    pack_mask, ssv_filter)
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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_msv_j_state_equals_c_state(seed):
    """J and C of the plain recurrence, both kept, are equal bit for bit
    after every sequence (they run one recurrence from one start), so the
    kernel's score J + move is the plain score C + move bit for bit; both
    stay within the JAX XLA engine's tolerance.  Random profiles of 20 to
    300 nodes (width classes 128 and 256) and random sequences of 0 to 90
    residues."""
    rng = numpy.random.default_rng(seed)
    profiles = synthetic_profiles(4, min_length=20, max_length=300, seed=30 + seed)
    seqs = [rng.integers(0, 21, int(n)).astype(numpy.int32) for n in rng.integers(0, 90, 7)]
    seqs.append(numpy.zeros(0, dtype=numpy.int32))
    pack, bank = SeqPack(seqs, "cpu"), TorchBank.build(_port(profiles), "cpu")
    want = msv_filter_plain(pack, bank)
    seen = 0
    for prof, J, C in msv_states_plain(pack, bank):
        assert torch.equal(J, C)
        live = pack.lens > 0
        assert torch.equal((J + pack.moves_log[:, None])[live], want[live][:, prof])
        seen += len(prof)
    assert seen == bank.P
    theirs = numpy.asarray(batch.msv_scores(batch.ProfileBank.build(profiles), seqs))
    live = pack.lens_host > 0
    numpy.testing.assert_allclose(want.numpy()[live], theirs[live], atol=TOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_msv_sequence_order_scores_land_in_place(seed):
    """Kernel I's order of sequences (``SeqPack.by_length``) is a
    permutation, longest first with ties in index order; scoring the
    sequences in that order, or in any other, tile by tile of each class's
    ``msv_tile``, and writing each score to its sequence's row gives the
    scores of the pack in its own order."""
    rng = numpy.random.default_rng(seed)
    profiles = synthetic_profiles(3, min_length=20, max_length=140, seed=40 + seed)
    tile = msv_tile(128)
    lengths = rng.integers(0, 60, tile + 3)
    lengths[[4, 9]] = lengths[3]                          # ties
    seqs = [rng.integers(0, 21, int(n)).astype(numpy.int32) for n in lengths]
    pack, bank = SeqPack(seqs, "cpu"), TorchBank.build(_port(profiles), "cpu")
    order = pack.by_length()
    assert order.dtype == torch.int32
    order = order.numpy()
    assert sorted(order.tolist()) == list(range(len(seqs)))
    by_len = lengths[order]
    assert (numpy.diff(by_len) <= 0).all()
    for a, b in zip(order[:-1], order[1:]):
        if lengths[a] == lengths[b]:
            assert a < b
    want = msv_filter(pack, bank)
    for perm in (order, rng.permutation(len(seqs))):
        for width, idx in bank.classes:
            part = dataclasses.replace(bank, classes=[(width, idx)])
            out = torch.full_like(want, NEG)
            for t0 in range(0, len(seqs), msv_tile(width)):
                rows = perm[t0:t0 + msv_tile(width)]
                out[torch.as_tensor(rows)] = msv_filter(
                    SeqPack([seqs[r] for r in rows], "cpu"), part)
            cols = idx.long()
            assert torch.equal(out[:, cols], want[:, cols])


def test_msv_tiles_and_nodes_per_class():
    """Each class's tile holds a take of every warp of a block (8 warps of
    32 / G sequences), and the DP row kernel I computes for a profile is
    whole groups of the class's G lanes, never past the class, the
    class's width at 2,048 nodes."""
    assert all(32 % g == 0 for g in MSV_LANES.values())
    for width in (128, 256, 512, 1024, 2048):
        g = MSV_LANES.get(width, 32)
        assert msv_tile(width) % (8 * 32 // g) == 0 and msv_tile(width) >= 32
    lengths = [1, 3, 4, 5, 31, 32, 33, 128, 129, 136, 300, 513, 1024, 1025, 2100]
    profiles = [gm for seed, m in enumerate(lengths)
                for gm in synthetic_profiles(1, min_length=m, max_length=m, seed=seed)]
    bank = TorchBank.build(_port(profiles), "cpu")
    for m, n, width in zip(lengths, msv_nodes(bank).tolist(), bank.class_of.tolist()):
        g = MSV_LANES.get(width, 32)
        if width == 2048:
            assert n == 2048
        else:
            assert n % g == 0 and m <= n < m + g and n <= width


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
