"""The port's pair-dense domain path (kernels J and K, windowed B and C,
``PairDomains``; plain versions) against JAX.

The same inputs, made with numpy from seeds, go through the port's plain
versions (the kernel wrappers take them for CPU tensors) and through the
JAX package's Pallas pair kernels in interpret mode, on one grid row of 8
sequences with C=8 profile columns, Lp=128 and Mp=128 (a power of two, so
the TPU kernels' ``log2(Mp)`` delete-chain doublings are exact, as the
port's chains are).  Tolerances: scores and log scales 1e-3 nats, ``mocc``,
``pB`` and ``pE`` 1e-4 absolute, null2 log-ratios 1e-3 (float32 sums in
another order: XLA's ``jnp.sum`` vs PyTorch's); at the bank's truncated
chain depth ``nd`` 5e-3 bits, the JAX package's own gate; alignment
coordinates and envelopes equal.  ``_pallas_pair_fwd``'s Viterbi is
probability-space max-product, the port's kernel B log-space max-plus: the
same maxima, rounded differently.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy
import pytest
import torch

from gecco_tpu.hmm import engine
from gecco_tpu.hmm.batch import ProfileBank
from gecco_tpu.hmm.calibrate import calibrate as jax_calibrate
from gecco_tpu.hmm.domains import PairDomains as JaxPairDomains
from gecco_tpu.hmm.kernels import SeqPack as JaxSeqPack
from gecco_tpu.hmm.kernels import (
    _pallas_pair_align, _pallas_pair_fwd_packed, _pallas_pair_posterior, dchain_depth)
from gecco_tpu.hmm.synthetic import plant_domain, synthetic_profiles, synthetic_proteins

from gecco_tpu_torch.hmm.bank import TorchBank
from gecco_tpu_torch.hmm.domains import (
    PairDomains, pair_align, pair_align_plain, pair_posterior, pair_posterior_plain,
    pair_posterior_smem)
from gecco_tpu_torch.hmm.kernels import SeqPack, viterbi_pairs
from gecco_tpu_torch.hmm.profile import profiles_from_arrays
from gecco_tpu_torch.hmm.stream import StreamDomains, envelopes, forward_pairs

torch.set_num_threads(1)

S, C, MP, LP = 8, 8, 128, 128
LOG2 = math.log(2.0)


def _port(profiles):
    """The port's copies of JAX profiles, from their plain fields."""
    return profiles_from_arrays([vars(gm.hmm) for gm in profiles])


def _coords(d):
    return (d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from, d.hmm_to)


@pytest.fixture(scope="module")
def cell():
    """Eight sequences with planted domains against four profiles of one
    128-node class: column ``c`` of sequence ``s`` is profile ``(s + c) %
    4`` (column 0 the planted one), columns 4-7 padding."""
    profiles = synthetic_profiles(4, min_length=40, max_length=100, seed=41)
    rng = numpy.random.default_rng(3)
    seqs = []
    for r, x in enumerate(synthetic_proteins(S, mean_length=100, seed=17)):
        x = x[: 70 + 7 * r]
        gm = profiles[r % len(profiles)]
        seqs.append(plant_domain(x, gm, rng, offset=5, max_len=min(gm.M, 60), divergence=0.1))
    host = ProfileBank.build(profiles)
    assert host.Mp == MP and max(map(len, seqs)) <= LP
    port = _port(profiles)
    bank = TorchBank.build(port, "cpu")
    pack = SeqPack(seqs, "cpu")
    idx = numpy.zeros((S, C), dtype=numpy.int32)
    idx[:, :4] = (numpy.arange(S)[:, None] + numpy.arange(4)[None, :]) % 4
    s_idx = numpy.repeat(numpy.arange(S), 4)
    p_idx = idx[:, :4].reshape(-1)
    jpack = JaxSeqPack(seqs, LP)
    trans = tuple(jnp.asarray(a) for a in (
        host.tmm, host.tim, host.tdm, host.tmi, host.tii, host.tmd, host.tdd, host.bm))
    jax_in = dict(
        host=host, pack=jpack, idx=jnp.asarray(idx), e_odds=jnp.asarray(host.e_odds),
        trans=trans, xs=jpack.xs[:S].reshape(1, S, LP), lens=jpack.lens[:S].reshape(1, 1, S),
        loops=jpack.loops_exp[:S].reshape(1, 1, S), moves=jpack.moves_exp[:S].reshape(1, 1, S))
    return profiles, port, seqs, pack, bank, s_idx, p_idx, jax_in


@pytest.fixture(scope="module")
def jax_posterior(cell):
    """``_pallas_pair_posterior`` (interpret mode) with ``pE``: ``score [32]``
    and ``mocc, pB, pE [32, Lp]`` in the port's row order."""
    *_rest, j = cell
    outs = _pallas_pair_posterior(MP, LP, C, False, True, True)(
        j["xs"], j["lens"], j["loops"], j["moves"], j["idx"], j["e_odds"], *j["trans"])
    score, mocc, pb, pe = (numpy.asarray(a)[:, :4] for a in outs)
    return score.reshape(-1), mocc.reshape(-1, LP), pb.reshape(-1, LP), pe.reshape(-1, LP)


@pytest.mark.parametrize("emit_pe", [True, False])
def test_pair_posterior_matches_jax_kernel(cell, jax_posterior, emit_pe):
    _profiles, _port_profiles, seqs, pack, bank, s_idx, p_idx, j = cell
    want = jax_posterior
    if not emit_pe:     # the kernel variant PairDomains runs
        outs = _pallas_pair_posterior(MP, LP, C, False, True, False)(
            j["xs"], j["lens"], j["loops"], j["moves"], j["idx"], j["e_odds"], *j["trans"])
        assert len(outs) == 3
        numpy.testing.assert_array_equal(numpy.asarray(outs[1])[:, :4].reshape(-1, LP), want[1])
    score, mocc, pb, pe = pair_posterior(pack, bank, s_idx, p_idx, emit_pe=emit_pe)
    stride = max(map(len, seqs))
    assert mocc.shape == pb.shape == (len(s_idx), stride)
    numpy.testing.assert_allclose(score.numpy(), want[0], atol=1e-3, rtol=0)
    got = (mocc, pb, pe) if emit_pe else (mocc, pb)
    assert (pe is None) == (not emit_pe)
    for r, s in enumerate(s_idx):
        L = len(seqs[s])
        for a, b in zip(got, want[1:]):
            numpy.testing.assert_allclose(a[r, :L].numpy(), b[r, :L], atol=1e-4, rtol=0)
            assert not a[r, L:].any()
    assert mocc.max() > 0.9 and (mocc >= 0).all() and (mocc <= 1).all()


def test_pair_posterior_matches_host_engine(cell):
    """As ``tests/test_hmm.py::test_pair_posterior_matches_engine`` holds the
    TPU kernel: score and ``mocc`` 5e-3, cumulative ``pB``/``pE`` 2e-2.  The
    engine's cumulative sums start with row 0 (the B state before the first
    residue, ~0.04 on these 70-residue sequences), which no kernel emits."""
    profiles, _port_profiles, seqs, pack, bank, _s_idx, _p_idx, _j = cell
    s_idx = numpy.arange(S)
    p_idx = s_idx % len(profiles)
    score, mocc, pb, pe = pair_posterior(pack, bank, s_idx, p_idx)
    for r, (s, p) in enumerate(zip(s_idx, p_idx)):
        gm, x = profiles[p], seqs[s]
        fwd = engine.forward(gm, x)
        post = engine.posterior_decode(gm, x, fwd, engine.backward(gm, x))
        L = len(x)
        assert float(score[r]) == pytest.approx(fwd.score, abs=5e-3)
        numpy.testing.assert_allclose(mocc[r, :L].numpy(), post.mocc[1:], atol=5e-3)
        numpy.testing.assert_allclose(numpy.cumsum(pb[r, :L].numpy()),
                                      post.btot[1:] - post.btot[0], atol=2e-2)
        numpy.testing.assert_allclose(numpy.cumsum(pe[r, :L].numpy()),
                                      post.etot[1:] - post.etot[0], atol=2e-2)


def test_pair_posterior_wrapper_is_plain_on_cpu_and_sizes_shared_memory(cell):
    _profiles, _port_profiles, _seqs, pack, bank, s_idx, p_idx, _j = cell
    got = pair_posterior(pack, bank, s_idx[:5], p_idx[:5])
    want = pair_posterior_plain(pack, bank, s_idx[:5], p_idx[:5])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # 12 KB of trajectories at 512 residues, 96 KB at 4,096
    assert pair_posterior_smem(128, 512) - pair_posterior_smem(128, 0) == 12 * 1024
    assert pair_posterior_smem(4096, 4096) - pair_posterior_smem(4096, 0) == 96 * 1024


def test_pair_align_matches_jax_kernel(cell, jax_posterior):
    """Per sequence: the planted pair's first envelope, the planted pair's
    whole sequence, and an unrelated profile over the whole sequence."""
    _profiles, _port_profiles, seqs, pack, bank, s_idx, p_idx, j = cell
    score, mocc, pb, _pe = jax_posterior
    lens = pack.lens_host.astype(numpy.int32)
    planted = numpy.arange(S) * 4                 # rows of column 0
    env_i, env_j, _over = envelopes(torch.as_tensor(mocc[planted].copy()),
                                    torch.as_tensor(pb[planted].copy()), torch.as_tensor(lens))
    ienv = numpy.ones((S, C), numpy.float32)
    jenv = numpy.zeros((S, C), numpy.float32)     # padding: an empty window
    totals = numpy.zeros((S, C), numpy.float32)
    idx = numpy.zeros((S, C), numpy.int32)
    rows = []
    for s in range(S):
        ok = numpy.flatnonzero(env_j[s].numpy() >= env_i[s].numpy())
        assert len(ok), "the planted pair has an envelope"
        first = (int(env_i[s, ok[0]]), int(env_j[s, ok[0]]))
        for c, (col, (i0, j0)) in enumerate(((0, first), (0, (1, lens[s])), (1, (1, lens[s])))):
            idx[s, c] = p_idx[4 * s + col]
            ienv[s, c], jenv[s, c], totals[s, c] = i0, j0, score[4 * s + col]
            rows.append((s, idx[s, c], i0, j0, totals[s, c]))
    assert sum(j0 - i0 + 1 < lens[s] for s, _p, i0, j0, _t in rows) >= S // 2
    want = _pallas_pair_align(MP, LP, C, False, True)(
        j["xs"], j["lens"], j["loops"], j["moves"], jnp.asarray(ienv[None]),
        jnp.asarray(jenv[None]), jnp.asarray(totals[None]), jnp.asarray(idx),
        j["e_odds"], *j["trans"])
    envsc, logn2, tf, tt, hf, ht = (numpy.asarray(a)[:, :3] for a in want)
    rs, rp, iv, jv, total = (numpy.asarray(col) for col in zip(*rows))
    out, coords = pair_align(pack, bank, rs, rp, iv, jv,
                             torch.as_tensor(total.astype(numpy.float32)))
    numpy.testing.assert_allclose(out[:, 0].numpy(), envsc.reshape(-1), atol=1e-3, rtol=0)
    numpy.testing.assert_allclose(out[:, 1:].numpy(), logn2.reshape(-1, 24)[:, :21],
                                  atol=1e-3, rtol=0)
    want_coords = numpy.stack([a.reshape(-1) for a in (tf, tt, hf, ht)], 1)
    numpy.testing.assert_array_equal(coords.numpy(), want_coords.astype(numpy.int32))
    assert (coords[:, 0].numpy() >= iv).all() and (coords[:, 1].numpy() <= jv).all()
    plain = pair_align_plain(pack, bank, rs, rp, iv, jv,
                             torch.as_tensor(total.astype(numpy.float32)))
    assert torch.equal(out, plain[0]) and torch.equal(coords, plain[1])
    # a class without occupancy: the TPU kernel's log(max(n2, 1e-300)) is
    # float32, where 1e-300 is 0, so interpret mode gives -inf (its padding
    # columns, empty windows, show it); the port's clamp does the same
    assert numpy.isneginf(numpy.asarray(want[1])[:, 3:, :21]).all()
    assert torch.isneginf(torch.log(torch.clamp(torch.zeros(1), min=1e-300))).all()


WINDOWS = {
    "full": lambda L: (0, L),
    "inner": lambda L: (5, min(60, L)),
    "empty": lambda L: (5, 5),
}


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("depth", ["exact", "bank"])
@pytest.mark.parametrize("viterbi", [False, True], ids=["forward", "viterbi"])
def test_windowed_pair_scores_match_pallas_pair_fwd(cell, viterbi, depth, window):
    """``_pallas_pair_fwd`` itself (``rows_per_cell=1``: ``call_packed``
    would pick the ILP kernel at this size), with ``ranges``."""
    _profiles, _port_profiles, seqs, pack, bank, s_idx, p_idx, j = cell
    nd = None if depth == "exact" else dchain_depth(j["host"])
    if depth == "bank":
        assert nd < int(math.log2(MP)), "the bank's depth truncates the chain"
    ranges = numpy.array([WINDOWS[window](len(x)) for x in seqs], dtype=numpy.int32)
    jp = j["pack"]
    n = jp.n
    rows = numpy.arange(n, dtype=numpy.int32) % S
    valid = (numpy.arange(n) < S).astype(numpy.int32)
    idx = numpy.zeros((n, C), numpy.int32)
    idx[:S] = numpy.asarray(j["idx"])
    starts = numpy.zeros(n, numpy.int32)
    ends = numpy.zeros(n, numpy.int32)
    starts[:S], ends[:S] = ranges[:, 0], ranges[:, 1]
    fn = _pallas_pair_fwd_packed(MP, LP, C, False, True, True, nd, viterbi, rows_per_cell=1)
    want = numpy.asarray(fn(
        jp.xs, jp.lens, jp.loops_exp, jp.moves_exp, jnp.asarray(rows), jnp.asarray(valid),
        jnp.asarray(idx), jnp.asarray(starts), jnp.asarray(ends), j["e_odds"],
        *j["trans"]))[:S, :4].reshape(-1)
    kernel = viterbi_pairs if viterbi else forward_pairs
    got = kernel(pack, bank, s_idx, p_idx, ranges=ranges[s_idx]).numpy()
    if window == "empty":
        # log(0 * move + 1e-38): the subnormal is flushed, on both sides
        assert numpy.isneginf(want).all() and numpy.isneginf(got).all()
        return
    tol = 1e-3 if depth == "exact" else 5e-3 * LOG2
    numpy.testing.assert_allclose(got, want, atol=tol, rtol=0)
    whole = kernel(pack, bank, s_idx, p_idx).numpy()
    if window == "full":
        numpy.testing.assert_array_equal(got, whole)
    else:
        assert numpy.abs(got - whole).max() > 0.1


@pytest.mark.parametrize("kernel", [forward_pairs, viterbi_pairs])
@pytest.mark.parametrize("bad", [(-1, 10), (12, 11), (0, 10_000)],
                         ids=["start below 0", "start past end", "end past length"])
def test_pair_scores_reject_window_outside_sequence(cell, kernel, bad):
    _profiles, _port_profiles, seqs, pack, bank, s_idx, p_idx, _j = cell
    ranges = numpy.array([(0, len(seqs[s])) for s in s_idx])
    ranges[3] = bad
    with pytest.raises(ValueError, match="ranges"):
        kernel(pack, bank, s_idx, p_idx, ranges=ranges)
    with pytest.raises(ValueError, match="ranges"):
        kernel(pack, bank, s_idx, p_idx, ranges=ranges[:-1])


def test_forward_pairs_keeps_its_score_of_an_empty_sequence():
    """-1e30 for an empty sequence without ``ranges``; -inf for its (empty) window."""
    profiles = _port(synthetic_profiles(1, min_length=30, max_length=30, seed=2))
    seqs = [numpy.zeros(0, dtype=numpy.int32), numpy.arange(12, dtype=numpy.int32)]
    pack, bank = SeqPack(seqs, "cpu"), TorchBank.build(profiles, "cpu")
    assert float(forward_pairs(pack, bank, [0], [0])[0]) == numpy.float32(-1e30)
    assert float(forward_pairs(pack, bank, [0], [0], ranges=[(0, 0)])[0]) == -math.inf
    assert float(viterbi_pairs(pack, bank, [1], [0], ranges=[(4, 4)])[0]) == -math.inf


# ---------------------------------------------------------------------------
# PairDomains
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def multidomain():
    """Four profiles of one 128-node class, calibrated; eight proteins of
    ~250 residues with two or three planted copies each."""
    profiles = synthetic_profiles(4, min_length=40, max_length=70, seed=21)
    jax_calibrate(profiles, n=160, L=160, seed=5)
    rng = numpy.random.default_rng(11)
    seqs = [x[:250] for x in synthetic_proteins(8, mean_length=300, seed=13)]
    for i in range(len(seqs)):
        gm = profiles[i % len(profiles)]
        x = seqs[i]
        copies = 2 + (i % 2)
        for c in range(copies):
            off = 8 + c * (len(x) // copies)
            if off + gm.M + 5 < len(x):
                x = plant_domain(x, gm, rng, offset=off, max_len=gm.M, divergence=0.15)
        seqs[i] = x
    return profiles, seqs


def _assert_same_domains(got, want, tol):
    assert sorted(got) == sorted(want)
    for key, doms in want.items():
        assert [_coords(d) for d in got[key]] == [_coords(d) for d in doms], key
        for a, b in zip(got[key], doms):
            assert a.envsc == pytest.approx(b.envsc, abs=tol)
            assert a.bitscore == pytest.approx(b.bitscore, abs=tol)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_pair_domains_match_jax_pair_domains_and_stream_domains(multidomain, backend):
    profiles, seqs = multidomain
    pairs = [(i, i % len(profiles)) for i in range(len(seqs))]
    pairs += [(0, 3), (5, 0), (7, 2)]            # unrelated pairs: no domains
    host = ProfileBank.build(profiles)
    assert host.Mp == MP        # JAX's 128-multiple width is a power of two here
    want = JaxPairDomains(host, profiles).define(seqs, pairs, pad_to=256, interpret=True)
    for doms in want.values():   # JAX appends in slot order; the port sorts
        doms.sort(key=lambda d: (d.ienv, d.jenv))
    port = _port(profiles)
    bank, pack = TorchBank.build(port, "cpu"), SeqPack(seqs, "cpu")
    domains = PairDomains(bank, port, backend=backend)
    got = domains.define(seqs, pairs, pack)
    assert domains.host_pairs == 0
    assert sum(len(v) for v in want.values()) >= 16
    _assert_same_domains(got, want, 5e-2)
    stream = StreamDomains(bank, port, backend=backend).define(seqs, pairs, pack)
    _assert_same_domains(got, stream, 5e-2)


def test_pair_domains_repeated_pair_empty_sequence_and_overflow():
    """A 20-node profile planted nine times (more regions than the eight
    slots: the host engine, counted), a repeated pair (reported once; the
    JAX class would report its domains twice) and an empty sequence (no
    domains; the TPU kernels clamp its length to 1 and score a residue of
    the padding)."""
    small = synthetic_profiles(1, min_length=20, max_length=20, seed=4)[0]
    wide = synthetic_profiles(1, min_length=70, max_length=70, seed=6)[0]
    profiles = [small, wide]
    rng = numpy.random.default_rng(21)
    many = synthetic_proteins(1, mean_length=400, seed=2)[0][:9 * 40 + 10]
    for c in range(9):
        many = plant_domain(many, small, rng, offset=10 + 40 * c, max_len=20, divergence=0.0)
    tail = synthetic_proteins(1, mean_length=300, seed=5)[0][:173]
    tail = plant_domain(tail, wide, rng, offset=173 - 55, max_len=wide.M, divergence=0.05)
    seqs = [many, tail, numpy.zeros(0, dtype=numpy.int32)]
    port = _port(profiles)
    domains = PairDomains(TorchBank.build(port, "cpu"), port)
    pairs = [(0, 0), (1, 1), (1, 1), (2, 0), (2, 1)]
    got = domains.define(seqs, pairs, SeqPack(seqs, "cpu"))
    assert sorted(got) == [(0, 0), (1, 1), (2, 0), (2, 1)]
    assert got[(2, 0)] == [] and got[(2, 1)] == []
    assert domains.host_pairs == 1
    assert [dataclasses.astuple(d) for d in got[(0, 0)]] == [
        dataclasses.astuple(d) for d in engine.define_domains(profiles[0], seqs[0])]
    assert len(got[(0, 0)]) == 9
    want = engine.define_domains(profiles[1], seqs[1])
    assert len(got[(1, 1)]) == len(want) >= 1
    assert got[(1, 1)][-1].jenv == len(seqs[1]) == 173
    for a, b in zip(got[(1, 1)], want):
        assert _coords(a) == _coords(b)
        assert a.bitscore == pytest.approx(b.bitscore, abs=5e-2)


def test_pair_domains_gate_sends_what_kernel_j_cannot_hold_to_the_host():
    """The port's gate: 4,096 residues, and kernel J's shared memory."""
    domains = PairDomains(None, [])
    assert domains._on_device(4096, 128) and not domains._on_device(4097, 128)
    assert domains._on_device(4096, 2048)
    assert domains._on_device(2600, 4096) and not domains._on_device(2800, 4096)
    with pytest.raises(ValueError):
        PairDomains(None, [], backend="pallas")
