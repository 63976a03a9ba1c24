"""The port's three scoring kernels (plain versions on the CPU) against JAX.

Each kernel wrapper, given CPU tensors, runs its plain PyTorch version;
the same inputs (numpy, from seeds) go through the JAX package's Pallas
kernels in interpret mode and through its host oracles
(``gecco_tpu.hmm.engine``).  Tolerances: 5e-3 nats, the JAX package's
own kernel-parity gate; the F1 survivor matrix must be equal.
"""

import numpy
import pytest
import torch

from gecco_tpu.hmm import batch, engine
from gecco_tpu.hmm.synthetic import plant_domain, synthetic_profiles, synthetic_proteins

from gecco_tpu_torch.hmm.bank import NEG, TorchBank, width_class
from gecco_tpu_torch.hmm.kernels import (
    SeqPack, flatten_pairs, pack_mask, ssv_filter, viterbi_pairs)
from gecco_tpu_torch.hmm.profile import profiles_from_arrays
from gecco_tpu_torch.hmm.stream import forward_pairs

torch.set_num_threads(1)
TOL = 5e-3


def _port_bank(profiles):
    """The port's bank of JAX profiles, built from their plain fields."""
    return TorchBank.build(profiles_from_arrays([vars(gm.hmm) for gm in profiles]), "cpu")


@pytest.fixture(scope="module")
def workload():
    """Profiles across two width classes (incl. the M=127 near-cap case)
    and proteins with planted domains, lengths not multiples of 4."""
    profiles = synthetic_profiles(5, min_length=30, max_length=200, seed=7)
    profiles += synthetic_profiles(1, min_length=127, max_length=127, seed=3)
    rng = numpy.random.default_rng(2)
    seqs = [x[:150] for x in synthetic_proteins(6, mean_length=110, seed=8)]
    for i in range(len(seqs)):
        gm = profiles[(2 * i) % len(profiles)]
        seqs[i] = plant_domain(seqs[i], gm, rng, offset=5, max_len=min(60, gm.M),
                               divergence=0.2)
    # consensus of the near-cap profile ending at its last node
    cons = numpy.argmax(profiles[-1].hmm.match[1:, :20], axis=1).astype(numpy.int32)
    seqs.append(numpy.concatenate([rng.integers(0, 20, 3).astype(numpy.int32), cons]))
    assert any(len(x) % 4 for x in seqs)
    return profiles, seqs, batch.ProfileBank.build(profiles), _port_bank(profiles)


def test_width_classes():
    assert [width_class(m) for m in (1, 127, 128, 129, 2048, 2100, 4096)] == [
        128, 128, 128, 256, 2048, 4096, 4096]
    with pytest.raises(ValueError):
        width_class(4097)


def test_ssv_filter_matches_host_engine(workload):
    profiles, seqs, _host, bank = workload
    scores = ssv_filter(SeqPack(seqs, "cpu"), bank).numpy()
    for s, x in enumerate(seqs):
        for p, gm in enumerate(profiles):
            assert scores[s, p] == pytest.approx(engine.ssv_score(gm, x), abs=TOL), (s, p)


@pytest.mark.parametrize("F1", [0.2, 0.02])
def test_ssv_survivors_match_pallas_masks(workload, F1):
    from gecco_tpu.hmm.kernels import Bucketed, SSVKernel
    from gecco_tpu.hmm.kernels import SeqPack as JaxSeqPack

    _profiles, seqs, host, bank = workload
    pack = SeqPack(seqs, "cpu")
    mine = pack_mask(ssv_filter(pack, bank), pack, bank, F1)
    jax_pack = JaxSeqPack(seqs, 1 << (max(map(len, seqs)) - 1).bit_length())
    theirs = Bucketed(SSVKernel, host, pow2=True).masks(
        jax_pack, F1, interpret=True)
    assert mine.shape == theirs.shape
    assert 0 < mine.sum() < mine.size
    numpy.testing.assert_array_equal(mine, theirs)


def _survivors(n_seqs, P):
    """A ragged survivor pattern with an empty row."""
    return {s: [p for p in range(P) if (s + p) % 3 != 0]
            for s in range(n_seqs) if s != 1}


def test_viterbi_pairs_match_pallas_and_host(workload):
    from gecco_tpu.hmm.kernels import PairBucketed
    from gecco_tpu.hmm.kernels import SeqPack as JaxSeqPack

    profiles, seqs, host, bank = workload
    survivors = _survivors(len(seqs), host.P)
    s_arr, p_arr = flatten_pairs(survivors)
    mine = viterbi_pairs(SeqPack(seqs, "cpu"), bank, s_arr, p_arr).numpy()
    keys = sorted(survivors)
    jax_pack = JaxSeqPack(seqs, 256)
    s_loc, p_j, v_j = PairBucketed(host, viterbi=True).flat_packed(
        jax_pack, numpy.asarray(keys, dtype=numpy.int32),
        [survivors[i] for i in keys], interpret=True)
    theirs = {(keys[s], int(p)): float(v) for s, p, v in zip(s_loc, p_j, v_j)}
    assert len(theirs) == len(mine)
    for s, p, v in zip(s_arr, p_arr, mine):
        assert v == pytest.approx(theirs[(s, p)], abs=TOL), (s, p)
    for r in range(0, len(mine), 7):  # the host engine's Viterbi is slow
        s, p = s_arr[r], p_arr[r]
        assert mine[r] == pytest.approx(engine.viterbi_score(profiles[p], seqs[s]), abs=TOL)


def test_viterbi_pairs_wide_profile():
    """A profile of >= 2048 nodes (the TPU pair kernel's single-row case)."""
    profiles = synthetic_profiles(1, min_length=2100, max_length=2100, seed=9)
    profiles += synthetic_profiles(1, min_length=50, max_length=50, seed=10)
    rng = numpy.random.default_rng(4)
    seqs = [x[:70] for x in synthetic_proteins(2, mean_length=70, seed=11)]
    seqs[0] = plant_domain(seqs[0], profiles[0], rng, offset=2, max_len=60)
    host = batch.ProfileBank.build(profiles)
    bank = _port_bank(profiles)
    assert [w for w, _ in bank.classes] == [128, 4096]
    s_arr = numpy.array([0, 1, 0, 1])
    p_arr = numpy.array([0, 0, 1, 1])
    mine = viterbi_pairs(SeqPack(seqs, "cpu"), bank, s_arr, p_arr).numpy()
    reference = numpy.asarray(batch.viterbi_scores(host, seqs))
    numpy.testing.assert_allclose(mine, reference[s_arr, p_arr], atol=TOL, rtol=0)


def test_forward_pairs_match_pallas_and_host(workload):
    from gecco_tpu.hmm.kernels import SeqPack as JaxSeqPack
    from gecco_tpu.hmm.stream import StreamScores

    profiles, seqs, host, bank = workload
    survivors = _survivors(len(seqs), host.P)
    s_arr, p_arr = flatten_pairs(survivors)
    mine = forward_pairs(SeqPack(seqs, "cpu"), bank, s_arr, p_arr).numpy()
    keys = sorted(survivors)
    s_loc, p_j, v_j = StreamScores(host).flat_packed(
        JaxSeqPack(seqs, 256), numpy.asarray(keys, dtype=numpy.int32),
        [survivors[i] for i in keys], interpret=True)
    theirs = {(keys[s], int(p)): float(v) for s, p, v in zip(s_loc, p_j, v_j)}
    for s, p, v in zip(s_arr, p_arr, mine):
        assert v == pytest.approx(theirs[(s, p)], abs=TOL), (s, p)
        assert v == pytest.approx(engine.forward(profiles[p], seqs[s]).score, abs=TOL)


def test_forward_pairs_empty_sequence_scores_neg(workload):
    _profiles, seqs, _host, bank = workload
    pack = SeqPack([seqs[0], numpy.zeros(0, dtype=numpy.int32)], "cpu")
    s_arr = numpy.array([1, 1, 0])
    p_arr = numpy.array([0, 3, 0])
    scores = forward_pairs(pack, bank, s_arr, p_arr).numpy()
    assert (scores[:2] == numpy.float32(NEG)).all()
    assert scores[2] > -1e29
    vit = viterbi_pairs(pack, bank, s_arr, p_arr).numpy()
    assert (vit[:2] <= -1e29).all() and vit[2] > -1e29
    assert (ssv_filter(pack, bank).numpy()[1] == numpy.float32(NEG)).all()


def test_wrappers_raise_on_mixed_devices(workload):
    _profiles, seqs, _host, bank = workload
    pack = SeqPack(seqs, "meta")
    with pytest.raises(ValueError):
        ssv_filter(pack, bank)


def test_seq_pack_layout():
    seqs = [numpy.array([1, 2, 3]), numpy.zeros(0, dtype=numpy.int32), numpy.array([20, 4])]
    pack = SeqPack(seqs, "cpu")
    assert pack.xs.dtype == torch.int8 and pack.xs.tolist()[:5] == [1, 2, 3, 20, 4]
    assert pack.offsets.tolist() == [0, 3, 3]
    assert pack.lens.tolist() == [3, 0, 2]
    assert pack.padded().tolist() == [[1, 2, 3], [0, 0, 0], [20, 4, 0]]
    assert pack.counts_host[0, 1] == 1 and pack.counts_host[2].sum() == 1
