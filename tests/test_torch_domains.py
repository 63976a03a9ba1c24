"""The port's domain definition (kernels D–G, plain versions) against JAX.

The same inputs, made with numpy from seeds, go through the port's
plain versions (the kernel wrappers take them for CPU tensors) and
through the JAX package's Pallas kernels in interpret mode with the full
delete-chain depth (``nd=None``), on one cell of C=8 rows, Lc=32 and
Mp=128, with the emission stream built as ``_jit_posterior.run`` builds
it.  Tolerances: trajectories, ``mocc`` and ``pB`` 1e-4 absolute and log
scales 1e-3 nats (float32 sums in another order: XLA's ``jnp.sum`` vs
PyTorch's); bfloat16 planes within one bfloat16 step (their float32
values differ by such sums and can round to neighbouring bfloat16
values); envelope slots, overflow flags and alignment coordinates equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy
import pytest
import torch

from gecco_tpu.hmm import engine
from gecco_tpu.hmm.batch import ProfileBank
from gecco_tpu.hmm.calibrate import calibrate as jax_calibrate
from gecco_tpu.hmm.stream import StreamBank
from gecco_tpu.hmm.stream import StreamDomains as JaxStreamDomains
from gecco_tpu.hmm.stream import (
    _jit_envelopes, _stream_align_bwd, _stream_align_fwd, _stream_bwd, _stream_fwd)
from gecco_tpu.hmm.synthetic import plant_domain, synthetic_profiles, synthetic_proteins

from gecco_tpu_torch.hmm import stream
from gecco_tpu_torch.hmm.bank import TorchBank
from gecco_tpu_torch.hmm.kernels import SeqPack
from gecco_tpu_torch.hmm.profile import profiles_from_arrays
from gecco_tpu_torch.hmm.stream import (
    StreamDomains, align_bwd, align_fwd, envelopes, posterior_bwd, posterior_fwd)

torch.set_num_threads(1)


def _port(profiles):
    """The port's copies of JAX profiles, from their plain fields."""
    return profiles_from_arrays([vars(gm.hmm) for gm in profiles])

C, LC, MP, LPS = 8, 32, 128, 128
BF16_STEP = 2.0 ** -7   # one bfloat16 step at the bottom of a binade


@pytest.fixture(scope="module")
def cell():
    """Eight pairs of one 128-node class, lengths not multiples of 32,
    with planted domains; the JAX stream inputs of the same cell."""
    profiles = synthetic_profiles(4, min_length=40, max_length=100, seed=41)
    rng = numpy.random.default_rng(3)
    seqs = []
    for r, x in enumerate(synthetic_proteins(C, mean_length=100, seed=17)):
        x = x[: 70 + 7 * r]
        gm = profiles[r % len(profiles)]
        seqs.append(plant_domain(x, gm, rng, offset=5, max_len=min(gm.M, 60), divergence=0.1))
    assert all(len(x) % 32 for x in seqs) and max(map(len, seqs)) <= LPS
    host = ProfileBank.build(profiles)
    port = _port(profiles)
    bank = TorchBank.build(port, "cpu")
    pack = SeqPack(seqs, "cpu")
    s_idx = numpy.arange(C)
    p_idx = s_idx % len(profiles)

    # the JAX cell, as StreamDomains._jit_posterior builds it
    shared = StreamBank(host)
    (_idx, bucket), = shared.buckets
    assert bucket.Mp == MP
    local = shared.local[p_idx, 1]
    sub = bucket.bank
    xs = numpy.zeros((C, LPS), dtype=numpy.int32)
    for r, x in enumerate(seqs):
        xs[r, : len(x)] = x
    eg = sub.e_odds[:, local, :]                                   # [21, C, Mp]
    es = eg[xs, numpy.arange(C)[:, None]]                           # [C, Lps, Mp]
    es = es.reshape(1, C, LPS, MP).transpose(0, 2, 1, 3)
    trans9 = [jnp.asarray(a[local].reshape(1, C, MP)) for a in (
        sub.e_odds[20], sub.tmm, sub.tim, sub.tdm, sub.tmi, sub.tii, sub.tmd, sub.tdd, sub.bm)]
    lens = pack.lens_host.astype(numpy.float32)[None]
    loops = pack.loops_exp.numpy()[None]
    moves = pack.moves_exp.numpy()[None]
    jax_in = dict(es=jnp.asarray(es), eg=jnp.asarray(eg.reshape(21, 1, C, MP)), trans9=trans9,
                  lens=jnp.asarray(lens), loops=jnp.asarray(loops), moves=jnp.asarray(moves))
    return port, seqs, pack, bank, s_idx, p_idx, jax_in


@pytest.fixture(scope="module")
def jax_posterior(cell):
    *_rest, j = cell
    nlc = LPS // LC
    fN, fB, fJ, fC, flog, score = _stream_fwd(MP, C, LC, nlc, 1, True, None)(
        j["es"], j["lens"], j["loops"], j["moves"], *j["trans9"][1:])

    def shift1(a):
        return jnp.concatenate([jnp.zeros_like(a[:, :1]), a[:, :-1]], axis=1)

    mocc, pb = _stream_bwd(MP, C, LC, nlc, 1, True, None)(
        j["es"], fB, flog, shift1(fN), shift1(fJ), shift1(fC), shift1(flog),
        j["lens"], j["loops"], j["moves"], score, *j["trans9"])
    traj = numpy.stack([numpy.asarray(a)[0].T for a in (fN, fB, fJ, fC, flog)])
    return traj, numpy.asarray(score)[0], numpy.asarray(mocc)[0].T, numpy.asarray(pb)[0].T


@pytest.fixture(scope="module")
def jax_align_planes(cell):
    *_rest, j = cell
    outs = _stream_align_bwd(MP, C, LC, LPS // LC, 1, True, None)(
        j["es"], j["lens"], j["loops"], j["moves"], *j["trans9"])
    planes = numpy.stack([numpy.asarray(a.astype(jnp.float32))[0].transpose(1, 0, 2)
                          for a in outs[:2]])                       # [2, C, Lps, Mp]
    logs = numpy.stack([numpy.asarray(a)[0].T for a in outs[2:]])   # [4, C, Lps]
    return outs, planes, logs


def test_posterior_fwd_matches_jax_kernel(cell, jax_posterior):
    _profiles, seqs, pack, bank, s_idx, p_idx, _j = cell
    want, want_score, _mocc, _pb = jax_posterior
    traj, score = posterior_fwd(pack, bank, s_idx, p_idx)
    assert traj.shape == (5, C, max(map(len, seqs)))
    for r, x in enumerate(seqs):
        L = len(x)
        numpy.testing.assert_allclose(traj[:4, r, :L].numpy(), want[:4, r, :L], atol=1e-4, rtol=0)
        numpy.testing.assert_allclose(traj[4, r, :L].numpy(), want[4, r, :L], atol=1e-3, rtol=0)
        assert not traj[:, r, L:].any()
    numpy.testing.assert_allclose(score.numpy(), want_score, atol=1e-3, rtol=0)


def test_posterior_bwd_matches_jax_kernel(cell, jax_posterior):
    _profiles, seqs, pack, bank, s_idx, p_idx, _j = cell
    traj, score, want_mocc, want_pb = jax_posterior
    stride = max(map(len, seqs))
    post = posterior_bwd(pack, bank, s_idx, p_idx,
                         torch.as_tensor(numpy.ascontiguousarray(traj[:, :, :stride])),
                         torch.as_tensor(score.copy()))
    numpy.testing.assert_allclose(post[0].numpy(), want_mocc[:, :stride], atol=1e-4, rtol=0)
    numpy.testing.assert_allclose(post[1].numpy(), want_pb[:, :stride], atol=1e-4, rtol=0)
    assert (post[0] >= 0).all() and (post[0] <= 1).all() and post[0].max() > 0.9


def test_envelopes_match_jax(cell, jax_posterior):
    _profiles, seqs, pack, *_rest = cell
    _traj, _score, mocc, pb = jax_posterior
    lens = pack.lens_host.astype(numpy.int32)
    # the cell's posteriors, then random ones with many regions and
    # envelopes, so that both kinds of overflow occur
    rng = numpy.random.default_rng(8)
    n, Lp = 64, 96
    wave = numpy.sin(numpy.arange(Lp)[None, :] / rng.uniform(0.6, 4.0, (n, 1))
                     + rng.uniform(0, 6, (n, 1)))
    rnd_mocc = numpy.clip(0.5 + 0.5 * wave + rng.normal(0, 0.1, (n, Lp)), 0, 1)
    rnd_pb = rng.exponential(rng.uniform(0.005, 0.2, (n, 1)), (n, Lp))
    rnd_lens = rng.integers(1, Lp + 1, n).astype(numpy.int32)
    flags = []
    for m, b, L in ((mocc, pb, lens), (rnd_mocc, rnd_pb, rnd_lens)):
        m, b = m.astype(numpy.float32), b.astype(numpy.float32)
        want_i, want_j, want_over = (numpy.asarray(a)[0] for a in _jit_envelopes(8, 4)(
            jnp.asarray(m[None]), jnp.asarray(b[None]), jnp.asarray(L[None])))
        got_i, got_j, got_over = envelopes(torch.as_tensor(m), torch.as_tensor(b),
                                           torch.as_tensor(L))
        numpy.testing.assert_array_equal(got_i.numpy(), want_i)
        numpy.testing.assert_array_equal(got_j.numpy(), want_j)
        numpy.testing.assert_array_equal(got_over.numpy(), want_over)
        flags.append(want_over)
    assert not flags[0].any() and (want_j >= want_i).any()
    assert 0 < flags[1].sum() < n


def test_align_bwd_matches_jax_kernel(cell, jax_align_planes):
    _profiles, seqs, pack, bank, s_idx, p_idx, _j = cell
    _outs, want_planes, want_logs = jax_align_planes
    planes, logs = align_bwd(pack, bank, s_idx, p_idx)
    assert planes.dtype == torch.bfloat16 and planes.shape == (2, C, max(map(len, seqs)), MP)
    planes = planes.float().numpy()
    for r, x in enumerate(seqs):
        L = len(x)
        for k in range(2):
            numpy.testing.assert_allclose(planes[k, r, :L], want_planes[k, r, :L],
                                          rtol=BF16_STEP, atol=1e-30)
        numpy.testing.assert_allclose(logs[:, r, :L].numpy(), want_logs[:, r, :L],
                                      atol=1e-3, rtol=0)
        assert not planes[:, r, L:].any() and not logs[:, r, L:].any()


def test_align_fwd_matches_jax_kernel(cell, jax_posterior, jax_align_planes):
    _profiles, seqs, pack, bank, s_idx, p_idx, j = cell
    _traj, score, mocc, pb = jax_posterior
    outs, want_planes, want_logs = jax_align_planes
    # one envelope per row: the first slot the finder fills, else the
    # whole sequence
    lens = pack.lens_host
    env_i, env_j, _over = envelopes(torch.as_tensor(mocc.copy()), torch.as_tensor(pb.copy()),
                                    torch.as_tensor(lens))
    iv = numpy.ones(C, numpy.int32)
    jv = lens.astype(numpy.int32).copy()
    for r in range(C):
        ok = numpy.flatnonzero(env_j[r].numpy() >= env_i[r].numpy())
        if len(ok):
            iv[r], jv[r] = env_i[r, ok[0]], env_j[r, ok[0]]
    assert (jv - iv + 1 < lens).sum() >= C // 2
    want = _stream_align_fwd(MP, C, LC, LPS // LC, 1, True, None)(
        j["es"], *outs, j["lens"], j["loops"], j["moves"],
        jnp.asarray(iv.astype(numpy.float32)[None]), jnp.asarray(jv.astype(numpy.float32)[None]),
        jnp.asarray(score[None]), j["eg"], *j["trans9"])
    want_envsc, want_logn2 = numpy.asarray(want[0])[0], numpy.asarray(want[1])[0]
    want_coords = numpy.stack([numpy.asarray(a)[0] for a in want[2:]], 1)
    stride = max(map(len, seqs))
    planes = torch.as_tensor(numpy.ascontiguousarray(want_planes[:, :, :stride])).to(torch.bfloat16)
    logs = torch.as_tensor(numpy.ascontiguousarray(want_logs[:, :, :stride]))
    out, coords = align_fwd(pack, bank, s_idx, p_idx, planes, logs, iv, jv,
                            torch.as_tensor(score.copy()))
    numpy.testing.assert_allclose(out[:, 0].numpy(), want_envsc, atol=1e-3, rtol=0)
    numpy.testing.assert_allclose(out[:, 1:].numpy(), want_logn2[:, :21], atol=1e-3, rtol=0)
    numpy.testing.assert_array_equal(coords.numpy(), want_coords.astype(numpy.int32))
    assert (coords[:, 0] >= torch.as_tensor(iv)).all() and (coords[:, 1] <= torch.as_tensor(jv)).all()


@pytest.fixture(scope="module")
def multidomain():
    """``tests/test_torch_pipeline.py``'s multidomain workload."""
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
    return profiles, seqs


def test_stream_domains_match_jax_stream_domains(multidomain):
    profiles, seqs = multidomain
    pairs = [(i, i % len(profiles)) for i in range(len(seqs))]
    pairs += [(0, 3), (5, 0), (7, 2)]            # unrelated pairs: no domains
    host = ProfileBank.build(profiles)
    want = JaxStreamDomains(host, profiles).define(seqs, pairs, interpret=True)
    port = _port(profiles)
    domains = StreamDomains(TorchBank.build(port, "cpu"), port)
    got = domains.define(seqs, pairs, SeqPack(seqs, "cpu"))
    assert domains.host_pairs == 0
    assert sorted(got) == sorted(want)
    assert sum(len(v) for v in want.values()) >= 16
    for key, doms in want.items():
        assert len(got[key]) == len(doms), key
        for a, b in zip(got[key], doms):
            assert (a.ienv, a.jenv) == (b.ienv, b.jenv)
            assert (a.target_from, a.target_to) == (b.target_from, b.target_to)
            assert (a.hmm_from, a.hmm_to) == (b.hmm_from, b.hmm_to)
            assert a.envsc == pytest.approx(b.envsc, abs=5e-2)
            assert a.bitscore == pytest.approx(b.bitscore, abs=5e-2)


@pytest.fixture(scope="module")
def edge_cases():
    """A 20-node profile planted nine times (more regions than slots), a
    domain ending on the last residue of a sequence of 173 residues, and
    an empty sequence."""
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
    return profiles, seqs


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_stream_domains_edge_cases_match_host_engine(edge_cases, backend):
    profiles, seqs = edge_cases
    port = _port(profiles)
    domains = StreamDomains(TorchBank.build(port, "cpu"), port, backend=backend)
    pairs = [(0, 0), (1, 1), (1, 1), (2, 0), (2, 1)]
    got = domains.define(seqs, pairs, SeqPack(seqs, "cpu"))
    assert sorted(got) == [(0, 0), (1, 1), (2, 0), (2, 1)]
    assert got[(2, 0)] == [] and got[(2, 1)] == []
    # nine regions overflow the eight slots: the host engine, exactly
    assert domains.host_pairs == 1
    assert len(got[(0, 0)]) == 9
    assert [dataclasses.astuple(d) for d in got[(0, 0)]] == [
        dataclasses.astuple(d) for d in engine.define_domains(profiles[0], seqs[0])]
    # the repeated pair once; its last envelope ends on the last residue
    want = engine.define_domains(profiles[1], seqs[1])
    assert len(got[(1, 1)]) == len(want) >= 1
    assert got[(1, 1)][-1].jenv == len(seqs[1]) == 173
    for a, b in zip(got[(1, 1)], want):
        assert (a.ienv, a.jenv) == (b.ienv, b.jenv)
        assert (a.target_from, a.target_to) == (b.target_from, b.target_to)
        assert (a.hmm_from, a.hmm_to) == (b.hmm_from, b.hmm_to)
        assert a.bitscore == pytest.approx(b.bitscore, abs=5e-2)


def test_stream_domains_splits_launches_by_byte_budget(cell, monkeypatch):
    """A small byte budget cuts the class into several launches of D–G;
    the domains stay the same."""
    profiles, seqs, pack, bank, s_idx, p_idx, _j = cell
    pairs = list(zip(s_idx, p_idx))
    want = StreamDomains(bank, profiles, backend="torch").define(seqs, pairs, pack)
    calls = []

    def counted(fn, name):
        def wrapper(pack, bank, seq_idx, *args):
            calls.append((name, [len(seqs[s]) for s in seq_idx]))
            return fn(pack, bank, seq_idx, *args)
        return wrapper

    fwd, bwd, abwd, afwd = stream._KERNELS["torch"]
    monkeypatch.setitem(stream._KERNELS, "torch", (counted(fwd, "D"), bwd, counted(abwd, "F"), afwd))
    domains = StreamDomains(bank, profiles, backend="torch")
    budget = domains.BYTES_BUDGET = 2 * max(map(len, seqs)) * domains.POSTERIOR_BYTES
    got = domains.define(seqs, pairs, pack)
    d_lens = [lens for name, lens in calls if name == "D"]
    assert len(d_lens) >= C // 3 and sum(map(len, d_lens)) == C
    assert all(len(lens) * max(lens) * domains.POSTERIOR_BYTES <= budget for lens in d_lens)
    n_rows = sum(len(v) for v in want.values())
    assert n_rows >= C // 2
    # a row's two planes of 128 nodes exceed the budget: one launch each
    assert [len(lens) for name, lens in calls if name == "F"] == [1] * n_rows
    assert sorted(got) == sorted(want)
    for key, doms in want.items():
        assert [(d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from, d.hmm_to)
                for d in got[key]] == [
            (d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from, d.hmm_to) for d in doms]
        for a, b in zip(got[key], doms):
            assert a.bitscore == pytest.approx(b.bitscore, abs=1e-4)


@pytest.mark.parametrize("bounds", ["start 0", "end before start", "end past length"])
def test_align_fwd_rejects_envelope_outside_sequence(cell, bounds):
    _profiles, seqs, pack, bank, s_idx, p_idx, _j = cell
    iv = numpy.ones(C, numpy.int32)
    jv = numpy.array([len(x) for x in seqs], numpy.int32)
    if bounds == "start 0":
        iv[3] = 0
    elif bounds == "end before start":
        iv[3], jv[3] = 10, 9
    else:
        jv[3] += 1
    with pytest.raises(ValueError, match="envelopes"):
        align_fwd(pack, bank, s_idx, p_idx, None, None, iv, jv, torch.zeros(C))


def test_stream_domains_rejects_unknown_backend():
    with pytest.raises(ValueError):
        StreamDomains(None, [], backend="pallas")
