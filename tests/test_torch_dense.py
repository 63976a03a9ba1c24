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

from gecco_tpu.hmm import engine as jax_engine
from gecco_tpu.hmm.batch import ProfileBank
from gecco_tpu.hmm.calibrate import calibrate as jax_calibrate
from gecco_tpu.hmm.kernels import Bucketed, ForwardKernel, ViterbiKernel
from gecco_tpu.hmm.pipeline import SearchPipeline as JaxSearchPipeline
from gecco_tpu.hmm.synthetic import (
    pfam_shaped_profiles, plant_domain, synthetic_profiles, synthetic_proteins)

from gecco_tpu_torch.hmm.bank import TorchBank
from gecco_tpu_torch.hmm.calibrate import calibrate
from gecco_tpu_torch.hmm.kernels import (
    DENSE_WARP_WIDTH, SeqPack, dense_nodes, dense_scores, dense_scores_plain, viterbi_pairs)
from gecco_tpu_torch.hmm.pipeline import SearchPipeline
from gecco_tpu_torch.hmm.profile import profiles_from_arrays
from gecco_tpu_torch.hmm.stream import forward_pairs
from gecco_tpu_torch.hmm.synthetic import bench_proteins
from gecco_tpu_torch.profiling import TIMER

from test_torch_pipeline import stage_spans

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


def test_dense_nodes_per_class():
    """The DP row kernel H computes for a profile: whole 32-node lane
    groups to ``DENSE_WARP_WIDTH``, never past the class, the class's
    width above it."""
    lengths = [1, 31, 32, 33, 95, 128, 129, 256, 300, 512, 513, 1000, 1024, 1025, 2100]
    profiles = [gm for seed, m in enumerate(lengths)
                for gm in synthetic_profiles(1, min_length=m, max_length=m, seed=seed)]
    bank = TorchBank.build(_port(profiles), "cpu")
    nodes = dense_nodes(bank)
    assert [w for w, _ in bank.classes] == [128, 256, 512, 1024, 2048, 4096]
    for m, n, width in zip(lengths, nodes.tolist(), bank.class_of.tolist()):
        if width <= DENSE_WARP_WIDTH:
            assert n % 32 == 0 and m <= n < m + 32 and n <= width
        else:
            assert n == width


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
def test_dense_rows_do_not_depend_on_the_pack(workload, semiring):
    """A sequence scores the same in any pack: rows of a whole pack equal
    the scores of a pack of those sequences alone, in another order (how
    ``chip_smoke.py`` holds a sample of the bench pack's rows)."""
    _profiles, seqs, pack, bank = workload
    rows = [len(seqs) - 1, 3, 0]    # the empty sequence first
    viterbi = semiring == "viterbi"
    whole = dense_scores(pack, bank, viterbi=viterbi).numpy()[rows]
    alone = dense_scores(SeqPack([seqs[r] for r in rows], "cpu"), bank, viterbi=viterbi).numpy()
    numpy.testing.assert_array_equal(whole, alone)


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
    TIMER.reset()
    hits = pipeline.search(seqs)
    pairs = len(seqs) * len(profiles)
    assert pipeline.stage_counts == expected_counts
    assert pipeline.stage_counts["F1"] == pipeline.stage_counts["F2"] == pairs
    assert pipeline.stage_cells["filter"] == 0.0 and pipeline.stage_cells["forward"] > 0
    # no filter or Viterbi stage runs: kernel H scores every pair
    assert stage_spans() == ["forward", "domains"]
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


#: the cut of the bench workload (``bench_proteins()``: 3,015 proteins,
#: 2,766 profiles, ``Z = 2,766`` as ``chip_smoke.py`` searches it) on
#: which both packages' ``max_filter`` searches must pick the same
#: candidates: its first proteins against the profiles planted in its
#: first eight and the bank's first few
BENCH_CUT_PROTEINS = 48
BENCH_CUT_PROFILES = 3
BENCH_Z = 2766


def test_max_filter_candidates_match_jax_on_bench_cut(monkeypatch):
    """Each package calibrates its own copy of the cut's profiles (the
    defaults: 256 sequences of 256 residues, seed 0) and runs its
    ``max_filter`` search, the port on plain PyTorch and the JAX package
    on its XLA engines: the same ``stage_counts`` and the same pairs
    reach domain definition (JAX's are the pairs its host engine is
    asked to define)."""
    profiles, seqs = bench_proteins()
    head = seqs[:BENCH_CUT_PROTEINS]
    pick = sorted({(13 * i) % len(profiles) for i in range(8) if i % 4 != 3}
                  | set(range(BENCH_CUT_PROFILES)))
    mine = [profiles[p] for p in pick]
    theirs = [gm for p, gm in enumerate(pfam_shaped_profiles(len(profiles), seed=0))
              if p in pick]
    for a, b in zip(mine, theirs):
        assert a.name == b.name
        numpy.testing.assert_array_equal(a.hmm.match, b.hmm.match)
    calibrate(mine, device="cpu")
    jax_calibrate(theirs, backend="xla")

    port = SearchPipeline(mine, device="cpu", Z=BENCH_Z, domZ=BENCH_Z, max_filter=True,
                          backend="torch")
    port.search(head)
    defined = set()
    forward = jax_engine.forward
    whole = {x.tobytes() for x in head}

    def recording_forward(gm, x):
        # the candidate loop scores whole sequences; domain definition
        # rescores envelopes, which are not recorded
        key = numpy.asarray(x).tobytes()
        if key in whole:
            defined.add((gm.name, key))
        return forward(gm, x)

    monkeypatch.setattr(jax_engine, "forward", recording_forward)
    reference = JaxSearchPipeline(theirs, Z=BENCH_Z, domZ=BENCH_Z, max_filter=True,
                                  backend="xla")
    reference.search(head)
    assert port.stage_counts == reference.stage_counts
    assert {(mine[p].name, head[i].tobytes()) for i, p in port.candidate_pairs} == defined
    pairs = port.stage_counts["pairs"]
    planted = {(i, pick.index((13 * i) % len(profiles))) for i in range(len(head))
               if i % 4 != 3 and (13 * i) % len(profiles) in pick}
    found = len(planted & set(port.candidate_pairs))
    print(f"max_filter on {len(head)} bench proteins x {len(pick)} profiles: "
          f"{port.stage_counts['F3']} of {pairs} pairs ({port.stage_counts['F3'] / pairs:.2%}) "
          f"pass E <= 10, {found} of the {len(planted)} with a planted domain among them; "
          f"stage_counts {port.stage_counts}")
