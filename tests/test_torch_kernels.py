"""The port's scoring kernels A-C (plain versions on the CPU) against JAX.

Each kernel wrapper, given CPU tensors, runs its plain PyTorch version;
the same inputs (numpy, from seeds) go through the JAX package's Pallas
kernels in interpret mode and through its host oracles
(``gecco_tpu.hmm.engine``).  Kernel A stands for all three SSV
variants of the TPU: ``_pallas_ssv_quad`` (the search's filter),
``_pallas_ssv`` (``SSVKernel.__call__``, with the lane-0 mask on a bank
whose profile fills its padded width) and ``_pallas_ssv_pair`` (a
near-cap bank); it is held against each.  Tolerances: 5e-3 nats, the
JAX package's own kernel-parity gate; the F1 survivor matrix must be
equal.
"""

import numpy
import pytest
import torch

from gecco_tpu.hmm import batch, engine
from gecco_tpu.hmm.synthetic import plant_domain, synthetic_profiles, synthetic_proteins

from gecco_tpu_torch.hmm.bank import NEG, TorchBank, width_class
from gecco_tpu_torch.hmm.kernels import (
    SeqPack, pack_mask, pair_blocks, ssv_filter, viterbi_pairs)
from gecco_tpu_torch.hmm.profile import profiles_from_arrays
from gecco_tpu_torch.hmm import kernels as port_kernels
from gecco_tpu_torch.hmm.stream import FORWARD_BLOCK_ROWS, forward_launches, forward_pairs
from gecco_tpu_torch.hmm.stream import forward_pairs_plain
from gecco_tpu_torch.hmm.synthetic import consensus_proteins

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


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_ssv_filter_matches_pallas_ssv(workload, masked):
    """``SSVKernel.__call__`` runs ``_pallas_ssv`` (one residue a roll),
    with its lane-0 mask where a profile fills the padded width."""
    from gecco_tpu.hmm.kernels import SSVKernel

    profiles, seqs, host, bank = workload
    if masked:
        profiles = [gm for gm in profiles if gm.M < 128]
        profiles += synthetic_profiles(1, min_length=128, max_length=128, seed=3)
        seqs = seqs + consensus_proteins(profiles[-1], count=2, length=150, seed=1)
        host, bank = batch.ProfileBank.build(profiles), _port_bank(profiles)
    kern = SSVKernel(host, seq_tile=4, profile_chunk=8)
    assert kern.masked == masked
    mine = ssv_filter(SeqPack(seqs, "cpu"), bank).numpy()
    numpy.testing.assert_allclose(mine, kern(seqs, interpret=True), atol=TOL, rtol=0)


def test_ssv_filter_matches_pallas_ssv_pair():
    """``SSVKernel.scores_packed`` on a profile within three nodes of its
    padded width runs ``_pallas_ssv_pair`` (two residues a roll)."""
    from gecco_tpu.hmm.kernels import SSVKernel
    from gecco_tpu.hmm.kernels import SeqPack as JaxSeqPack

    profiles = synthetic_profiles(1, min_length=127, max_length=127, seed=3)
    host = batch.ProfileBank.build(profiles)
    kern = SSVKernel(host, seq_tile=4, profile_chunk=8)
    assert host.Mp == 128 and not kern.masked and not kern.quad
    xs = consensus_proteins(profiles[0], count=5, length=200)
    theirs = numpy.asarray(kern.scores_packed(JaxSeqPack(xs, 256), interpret=True))
    mine = ssv_filter(SeqPack(xs, "cpu"), _port_bank(profiles)).numpy()
    numpy.testing.assert_allclose(mine, theirs[: len(xs), :1], atol=TOL, rtol=0)
    for s, x in enumerate(xs):
        assert mine[s, 0] == pytest.approx(engine.ssv_score(profiles[0], x), abs=TOL), s


def _survivors(n_seqs, P):
    """A ragged survivor mask with an empty row: its pairs as the search
    takes them (``numpy.nonzero``, row-major) and each non-empty row's
    profiles."""
    s, p = numpy.indices((n_seqs, P))
    mask = ((s + p) % 3 != 0) & (s != 1)
    s_arr, p_arr = numpy.nonzero(mask)
    return s_arr, p_arr, {i: numpy.flatnonzero(row).tolist() for i, row in enumerate(mask)
                          if row.any()}


def test_viterbi_pairs_match_pallas_and_host(workload):
    from gecco_tpu.hmm.kernels import PairBucketed
    from gecco_tpu.hmm.kernels import SeqPack as JaxSeqPack

    profiles, seqs, host, bank = workload
    s_arr, p_arr, survivors = _survivors(len(seqs), host.P)
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


@pytest.mark.parametrize("per_class", [False, True], ids=["one cap", "cap per class"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_blocks_schedule(seed, per_class):
    """The block schedule of kernels B, C, D and F: every row in exactly
    one block, no block across two profiles or width classes or over its
    row cap (one for every class, or each class its own), the classes in
    order, and the inverse permutation back to input order."""
    rng = numpy.random.default_rng(seed)
    n, P, cap = int(rng.integers(1, 400)), int(rng.integers(1, 30)), int(rng.integers(1, 20))
    class_of = numpy.array([width_class(m) for m in rng.integers(1, 4097, P)])
    prof = rng.integers(0, P, n)
    caps = {w: int(rng.integers(1, 20)) for w in (128, 256, 512, 1024, 2048, 4096)}
    order, blocks = pair_blocks(class_of, prof, caps if per_class else cap)
    cap_of = numpy.array([caps[w] if per_class else cap for w in class_of])
    assert blocks.dtype == numpy.int32 and blocks.shape[1] == 2
    assert sorted(order.tolist()) == list(range(n))
    first, count = blocks[:, 0], blocks[:, 1]
    assert (count >= 1).all() and (count <= cap_of[prof[order[first]]]).all()
    covered = numpy.zeros(n, dtype=int)
    for f, c in blocks:
        rows = order[f : f + c]
        covered[f : f + c] += 1
        assert len(set(prof[rows].tolist())) == 1
        assert (numpy.diff(rows) > 0).all()       # stable within a profile
    assert (covered == 1).all()
    assert (numpy.diff(first) > 0).all()
    # a class's rows are contiguous, so each launch takes a run of blocks
    assert (numpy.diff(class_of[prof[order]]) >= 0).all()
    # scores of the rows in launch order, scattered back as pair_launches does
    out = numpy.empty(n, dtype=numpy.int64)
    out[order] = prof[order]
    numpy.testing.assert_array_equal(out, prof)


def test_pair_blocks_empty():
    order, blocks = pair_blocks(numpy.array([128, 256]), numpy.zeros(0, dtype=int), 16)
    assert order.shape == (0,) and blocks.shape == (0, 2)


@pytest.mark.parametrize("windows", [False, True], ids=["whole", "windows"])
def test_forward_launches_schedule(workload, monkeypatch, windows):
    """The host side of kernel C's launch: one launch a width class, whose
    block table covers every row of the class once, each block within one
    profile and at most ``FORWARD_BLOCK_ROWS`` rows, and whose windows
    follow their rows.  Each launch is stood in for by the plain version
    over its blocks' rows (the CUDA launch needs a card); the scores come
    back in input order, equal to the plain version's over all pairs."""
    profiles, seqs, _host, bank = workload
    pack = SeqPack(seqs, "cpu")
    rng = numpy.random.default_rng(3)
    n = 3 * FORWARD_BLOCK_ROWS + 5
    s_arr = rng.integers(0, len(seqs), n)
    p_arr = rng.integers(0, len(profiles), n)
    p_arr[:FORWARD_BLOCK_ROWS + 2] = 1          # one profile over more than a block
    ranges = None
    if windows:
        lens = pack.lens_host[s_arr].astype(numpy.int64)
        start = (rng.random(n) * lens).astype(numpy.int64)
        end = start + (rng.random(n) * (lens - start)).astype(numpy.int64)
        ranges = numpy.stack([start, end], 1)
    seen = []

    def launch_rows(fn_name, counter, pack_, bank_, seq, prof, width, table, n_blocks,
                    starts, ends, scores, log_space):
        assert (fn_name, counter, log_space) == ("gecco_forward_pairs", "forward_pairs", False)
        assert (starts is None) == (ends is None) == (not windows)
        assert table.shape == (n_blocks, 2) and table.dtype == torch.int32
        covered = numpy.zeros(len(seq), dtype=int)
        for first, count in table.tolist():
            assert 1 <= count <= FORWARD_BLOCK_ROWS
            rows = slice(first, first + count)
            covered[rows] += 1
            assert len(set(prof[rows].tolist())) == 1
            window = None if starts is None else torch.stack([starts[rows], ends[rows]], 1)
            scores[rows] = forward_pairs_plain(pack_, bank_, seq[rows].numpy(),
                                               prof[rows].numpy(), ranges=window)
        assert (covered == 1).all()
        assert set(bank_.class_of[prof.numpy()].tolist()) == {width}
        seen.append(width)

    monkeypatch.setattr(port_kernels, "launch_rows", launch_rows)
    launches, finish = forward_launches(pack, bank, s_arr, p_arr, ranges=ranges)
    assert sorted(launches) == sorted(set(bank.class_of[p_arr].tolist()))
    for launch in launches.values():
        launch()
    assert sorted(seen) == sorted(launches)
    got = finish()
    want = forward_pairs_plain(pack, bank, s_arr, p_arr, ranges=ranges)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_forward_pairs_match_pallas_and_host(workload):
    from gecco_tpu.hmm.kernels import SeqPack as JaxSeqPack
    from gecco_tpu.hmm.stream import StreamScores

    profiles, seqs, host, bank = workload
    s_arr, p_arr, survivors = _survivors(len(seqs), host.P)
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
