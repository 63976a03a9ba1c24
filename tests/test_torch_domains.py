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
from gecco_tpu.hmm.synthetic import (
    pfam_shaped_profiles, plant_domain, synthetic_profiles, synthetic_proteins)

from gecco_tpu_torch.hmm import engine as port_engine
from gecco_tpu_torch.hmm import stream
from gecco_tpu_torch.hmm.bank import TorchBank
from gecco_tpu_torch.hmm.domains import (
    pair_align_launches, pair_align_plain, pair_posterior_launches, pair_posterior_plain)
from gecco_tpu_torch.hmm.kernels import SeqPack
from gecco_tpu_torch.hmm.profile import profiles_from_arrays
from gecco_tpu_torch.hmm.stream import (
    ALIGN_FWD_BLOCK_ROWS, DOMAIN_BLOCK_ROWS, StreamDomains, align_bwd, align_bwd_launches,
    align_bwd_plain, align_fwd, align_fwd_launches, align_fwd_plain, envelopes, posterior_bwd,
    posterior_bwd_launches, posterior_bwd_plain, posterior_fwd, posterior_fwd_launches,
    posterior_fwd_plain)

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


#: protein 2104 of ``hmm.synthetic.bench_proteins()`` (``chip_smoke.py``'s
#: workload: a gene of ``synthetic_genome(3230, seed=4)`` cut to 512
#: residues), held as a literal, and the profile of
#: ``pfam_shaped_profiles(2766, seed=0)`` it meets in the ``max_filter``
#: search (92 nodes)
NEAR_TIE_PROTEIN = (
    "MQAIARDPSVAGIPYIWPHVAGATEAPGTWPWHWRCGAEFEYGSHYGKWHFGKNHTFLDTGQKTQMDMSTLWILAQNQWNLEERK"
    "ILSDRELPQAGIAAYKDYVYGPYPWWWYPSGCRIGRARYSIPNGNMLFCNSIEMAMKFAKNRQESEAEAPLTESFLAESCIKI"
    "LASLNALWSNCWLITCVIIFGNKRFPDRYMHNTGALSNQAVPFHTVARKRAPWVWGPIDTMRQNGRSESKWADYVLSKGTKQDD"
    "GDRKANWPVKKLNRLARIAMAKVEYPSRQADGEPQDVNKPQSKSAILFENTALNEIAHANDSLTGWYX")
NEAR_TIE_PROFILE = 1539


def test_stream_domains_near_tie_matches_jax_and_engine():
    """The ``max_filter`` pair whose domain count differed between two
    builds of kernel E on an H100 (one envelope more, [27, 38], after E's
    warp redesign): the float64 engine's peak match occupancy over residues
    21-45 is 4.2e-6 below the region threshold RT1, within float32
    rounding of it, so a kernel may land on either side.  The port's
    ``StreamDomains`` on the CPU gives the envelopes and coordinates of
    JAX's ``StreamDomains`` (Pallas in interpret mode) and of the float64
    engine: one domain, [105, 144]."""
    profile = pfam_shaped_profiles(2766, seed=0)[NEAR_TIE_PROFILE]
    x = numpy.array(["ACDEFGHIKLMNPQRSTVWYX".index(c) for c in NEAR_TIE_PROTEIN],
                    dtype=numpy.int32)
    assert (len(x), profile.M) == (320, 92)
    fwd, bwd = engine.forward(profile, x), engine.backward(profile, x)
    mocc = numpy.asarray(engine.posterior_decode(profile, x, fwd, bwd).mocc[1 : len(x) + 1])
    assert engine.RT1 - 1e-5 < mocc[20:45].max() < engine.RT1

    def coords(doms):
        return [(d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from, d.hmm_to)
                for d in doms]

    want = coords(engine.define_domains(profile, x))
    assert want == [(105, 144, 105, 144, 37, 76)]
    jax_doms = JaxStreamDomains(ProfileBank.build([profile]), [profile]).define(
        [x], [(0, 0)], interpret=True)
    assert coords(jax_doms[(0, 0)]) == want
    port = _port([profile])
    domains = StreamDomains(TorchBank.build(port, "cpu"), port)
    got = domains.define([x], [(0, 0)], SeqPack([x], "cpu"))
    assert domains.host_pairs == 0
    assert coords(got[(0, 0)]) == want
    for a, b in zip(got[(0, 0)], jax_doms[(0, 0)]):
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


def _coords(d):
    return (d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from, d.hmm_to)


@pytest.fixture(scope="module")
def long_rows():
    """A seeded sequence of 4,400 residues, past JAX's 4,096-residue pack
    limit, carrying a diverged domain of a 1,030-node profile (the
    2,048-node class) and two of a 100-node profile (the 128-node class);
    the domains of both pairs from the port's float64 engine and from
    JAX's ``StreamDomains``, which sends them to its host engine."""
    narrow = synthetic_profiles(1, min_length=100, max_length=100, seed=31)[0]
    wide = synthetic_profiles(1, min_length=1030, max_length=1030, seed=32)[0]
    profiles = [narrow, wide]
    rng = numpy.random.default_rng(43)
    x = synthetic_proteins(1, mean_length=6000, seed=44)[0][:4400]
    x = plant_domain(x, wide, rng, offset=60, max_len=wide.M, divergence=0.1)
    for offset in (1200, 1500):
        x = plant_domain(x, narrow, rng, offset=offset, max_len=narrow.M, divergence=0.1)
    assert len(x) == 4400 > stream._MAX_LPS
    seqs, pairs = [x], [(0, 0), (0, 1)]
    port = _port(profiles)
    want = {(s, p): port_engine.define_domains(port[p], seqs[s]) for s, p in pairs}
    jax_doms = JaxStreamDomains(ProfileBank.build(profiles), profiles).define(
        seqs, pairs, interpret=True)
    return port, seqs, pairs, want, jax_doms


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_stream_domains_long_rows_match_host_engine(long_rows, backend):
    """Rows longer than 4,096 residues stay on the device stages (D–G;
    on the CPU both backends take the plain versions): no pair goes to the
    host engine, and the envelopes and alignment coordinates are the
    float64 engine's and JAX's, the bits within 1e-2 of both (a float32
    sum of the log scales missed the wide domain's by 0.19 bits)."""
    profiles, seqs, pairs, want, jax_doms = long_rows
    domains = StreamDomains(TorchBank.build(profiles, "cpu"), profiles, backend=backend)
    got = domains.define(seqs, pairs, SeqPack(seqs, "cpu"))
    assert domains.host_pairs == 0
    assert domains.counts["domains.long_rows"] == len(pairs)
    assert [len(got[key]) for key in pairs] == [len(want[key]) for key in pairs] == [2, 1]
    for key in pairs:
        assert [_coords(d) for d in got[key]] == [_coords(d) for d in want[key]] == [
            _coords(d) for d in jax_doms[key]]
        for a, b, c in zip(got[key], want[key], jax_doms[key]):
            assert a.bitscore == pytest.approx(b.bitscore, abs=1e-2)
            assert a.bitscore == pytest.approx(c.bitscore, abs=1e-2)


def test_long_row_posteriors_match_float64_engine(long_rows):
    """The posterior stage over 4,400 residues (kernels D and E, plain
    versions): the Forward score within 1e-3 nats and ``mocc`` within 1e-3
    of the float64 engine's at every residue.  Summed in float32, the log
    scales drifted by 0.04 nats over such a row, which lifted ``mocc`` by
    0.04 everywhere past the domains."""
    profiles, seqs, pairs, *_ = long_rows
    pack, bank = SeqPack(seqs, "cpu"), TorchBank.build(profiles, "cpu")
    s_idx, p_idx = (numpy.array([pair[k] for pair in pairs]) for k in (0, 1))
    traj, score = posterior_fwd(pack, bank, s_idx, p_idx)
    post = posterior_bwd(pack, bank, s_idx, p_idx, traj, score)
    x = seqs[0]
    for r, p in enumerate(p_idx):
        fwd, bwd = port_engine.forward(profiles[p], x), port_engine.backward(profiles[p], x)
        mocc = port_engine.posterior_decode(profiles[p], x, fwd, bwd).mocc[1 : len(x) + 1]
        assert float(score[r]) == pytest.approx(fwd.score, abs=1e-3)
        numpy.testing.assert_allclose(post[0, r].numpy(), mocc, atol=1e-3, rtol=0)


def test_stream_domains_long_row_overflow_goes_to_host_engine(long_rows):
    """A sequence of 4,300 residues carrying a 20-node profile sixteen
    times has more regions than the eight slots: the pair goes to the host
    engine (``host_pairs.overflow``, not a long row defined on the device)
    and reports exactly its domains."""
    _profiles, seqs, *_ = long_rows
    small = _port(synthetic_profiles(1, min_length=20, max_length=20, seed=4))
    rng = numpy.random.default_rng(47)
    many = seqs[0][:4300].copy()
    for c in range(16):
        many = plant_domain(many, small[0], rng, offset=3000 + 40 * c, max_len=20,
                            divergence=0.0)
    domains = StreamDomains(TorchBank.build(small, "cpu"), small, backend="torch")
    got = domains.define([many], [(0, 0)], SeqPack([many], "cpu"))
    assert domains.counts == {
        "host_pairs.length": 0, "host_pairs.overflow": 1, "domains.long_rows": 0}
    assert domains.host_pairs == 1
    want = port_engine.define_domains(small[0], many)
    assert len(want) > 8
    assert [dataclasses.astuple(d) for d in got[(0, 0)]] == [dataclasses.astuple(d) for d in want]


def test_stream_domains_refuses_rows_past_kernel_g_payload():
    """A sequence longer than kernel G's int32 start payload allows raises,
    before any launch: it is neither cut nor sent to the host engine."""
    profiles = _port(synthetic_profiles(1, min_length=20, max_length=20, seed=4))
    seqs = [numpy.zeros(stream._MAX_ROW + 1, dtype=numpy.int32)]
    domains = StreamDomains(TorchBank.build(profiles, "cpu"), profiles, backend="torch")
    with pytest.raises(ValueError, match="kernel G takes at most 262143"):
        domains.define(seqs, [(0, 0)], SeqPack(seqs, "cpu"))
    assert domains.host_pairs == 0


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


@pytest.fixture(scope="module")
def schedule_rows():
    """Rows of three width classes (128, 256 and, from a 2,100-node
    profile, 4,096) in an order that interleaves profiles: the first
    profiles of 128 and 256 nodes take more rows than a block, and an
    empty sequence is among them."""
    from gecco_tpu_torch.hmm.synthetic import synthetic_profiles as port_profiles

    profiles = (port_profiles(2, min_length=40, max_length=100, seed=61)
                + port_profiles(1, min_length=200, max_length=200, seed=62)
                + port_profiles(1, min_length=2100, max_length=2100, seed=63))
    bank = TorchBank.build(profiles, "cpu")
    assert bank.class_of.tolist() == [128, 128, 256, 4096]
    rng = numpy.random.default_rng(9)
    seqs = [rng.integers(0, 20, n).astype(numpy.int32) for n in (0, 1, 33, 47, 60, 81, 90)]
    pack = SeqPack(seqs, "cpu")
    n = 6 * DOMAIN_BLOCK_ROWS[128] + 5
    p_idx = numpy.array([0, 1, 0, 2, 0, 3] * n)[:n]
    assert min(numpy.bincount(p_idx)[:3]) > max(DOMAIN_BLOCK_ROWS[128], DOMAIN_BLOCK_ROWS[256])
    s_idx = rng.integers(0, len(seqs), n)
    s_idx[:3] = 0
    return pack, bank, s_idx, p_idx


#: each kernel's prepared launches and plain version
_SCHEDULED = {
    "posterior_fwd": (posterior_fwd_launches, posterior_fwd_plain),
    "posterior_bwd": (posterior_bwd_launches, posterior_bwd_plain),
    "align_bwd": (align_bwd_launches, align_bwd_plain),
    "align_fwd": (align_fwd_launches, align_fwd_plain),
    "pair_posterior": (pair_posterior_launches, pair_posterior_plain),
    "pair_align": (pair_align_launches, pair_align_plain),
}
#: the kernels that take a block a row from 512 nodes up
_ALIGN_FORWARD = ("align_fwd", "pair_align")


def _inputs(kernel, pack, bank, seq, prof, env):
    """A kernel's own inputs for rows ``(seq, prof)``, from the plain
    versions of the kernels before it: kernel D's trajectories and scores
    for E; kernel F's planes (for G), each row's envelope (``env[seq]``)
    and its Forward score for G and K."""
    if kernel == "posterior_bwd":
        return posterior_fwd_plain(pack, bank, seq, prof)
    if kernel in _ALIGN_FORWARD:
        iv, jv = (torch.as_tensor(env[seq, k], dtype=torch.int32) for k in (0, 1))
        total = posterior_fwd_plain(pack, bank, seq, prof)[1]
        if kernel == "pair_align":
            return iv, jv, total
        return (*align_bwd_plain(pack, bank, seq, prof), iv, jv, total)
    return ()


def _plain_rows(kernel, pack, bank, seq, prof, width, inputs=()):
    """The plain version over rows, padded to ``width`` nodes (planes)."""
    got = _SCHEDULED[kernel][1](pack, bank, seq, prof, *inputs)
    if kernel != "align_bwd":
        return got if isinstance(got, tuple) else (got,)
    planes, logs = got
    wide = torch.zeros(planes.shape[:3] + (width,), dtype=planes.dtype)
    wide[..., : planes.shape[3]] = planes
    return wide, logs


@pytest.mark.parametrize("kernel", list(_SCHEDULED))
def test_domain_launches_schedule(schedule_rows, monkeypatch, kernel):
    """The host side of kernels D-G, J and K: one launch per width class
    up to 1,024 nodes (so one per group of ``StreamDomains`` and
    ``PairDomains``, which are of one class), whose block table covers
    every row of the class once, each block within one profile and at most
    ``DOMAIN_BLOCK_ROWS`` rows (``ALIGN_FWD_BLOCK_ROWS`` for G and K), and
    one launch (a block a row) for the classes above; every row goes to
    its own output slot, and kernels E, G and K take their inputs there
    (J and K their scratch too).  Each launch is stood in for by the plain
    version over its blocks' rows (the CUDA launch needs a card), given
    the inputs at the slots it is given and written at them; the outputs
    equal the plain version's over all rows, whose profiles interleave.
    G's and K's rows are the non-empty ones, each with an envelope."""
    pack, bank, s_idx, p_idx = schedule_rows
    prepare = _SCHEDULED[kernel][0]
    caps = ALIGN_FWD_BLOCK_ROWS if kernel in _ALIGN_FORWARD else DOMAIN_BLOCK_ROWS
    lens = pack.lens_host
    rng = numpy.random.default_rng(12)
    iv = 1 + (rng.random(pack.S) * lens).astype(numpy.int64)
    env = numpy.stack([iv, iv + (rng.random(pack.S) * (lens - iv + 1)).astype(numpy.int64)], 1)
    if kernel in _ALIGN_FORWARD:
        keep = lens[s_idx] > 0
        s_idx, p_idx = s_idx[keep], p_idx[keep]
    n_in = {"posterior_fwd": 0, "posterior_bwd": 2, "align_bwd": 0, "align_fwd": 5,
            "pair_posterior": 0, "pair_align": 3}[kernel]
    seen = []

    def launch_rows(fn_name, counter, pack_, bank_, seq, prof, width, table, n_blocks, out_row,
                    n_out, *tail, log_space, stride):
        assert (fn_name, counter, log_space) == (f"gecco_{kernel}", kernel, False)
        assert n_out == len(s_idx) and stride == max(1, int(pack.lens_host[s_idx].max()))
        plane_width = 0
        if kernel in ("align_bwd", "align_fwd", "pair_align"):
            plane_width, *tail = tail
            assert plane_width == 4096
        if kernel == "pair_posterior":   # emit_pe; the warp form's trajectory scratch
            n_post, traj, *tail = tail
            assert n_post == 3 and traj.shape == (6, n_out, stride)
        inputs, outputs = tail[:n_in], tail[n_in:]
        if kernel == "pair_posterior":
            score, post = outputs
            outputs = (score, *post)
        if kernel == "pair_align":       # the longest envelope, the parked rows' scratch
            env_stride, planes, logs, *outputs = outputs
            longest = int((env[s_idx, 1] - env[s_idx, 0]).max()) + 1
            assert env_stride == longest and planes.shape == (2, n_out, longest, plane_width)
            assert logs.shape == (4, n_out, longest)
        classes = set(bank_.class_of[prof.numpy()].tolist())
        if width <= 1024:
            assert classes == {width} and table.shape == (n_blocks, 2)
            runs = table.tolist()
        else:
            assert table is None and n_blocks == 0 and min(classes) > 1024
            runs = [(r, 1) for r in range(len(seq))]
        covered = numpy.zeros(len(seq), dtype=int)
        for first, count in runs:
            assert 1 <= count <= caps[width]
            rows = slice(first, first + count)
            covered[rows] += 1
            assert len(set(prof[rows].tolist())) == 1
            slots = out_row[rows].long()
            got = _plain_rows(kernel, pack_, bank_, seq[rows].numpy(), prof[rows].numpy(),
                              plane_width,
                              [t[slots] if t.dim() == 1 else t[:, slots] for t in inputs])
            for out, value in zip(outputs, got):
                if kernel in _ALIGN_FORWARD or value.dim() == 1:
                    out[slots] = value
                elif value.dim() == 2:   # [rows, residues]
                    out[slots] = 0
                    out[slots, : value.shape[1]] = value
                else:
                    out[:, slots] = 0
                    out[:, slots, : value.shape[2]] = value
        assert (covered == 1).all()
        seen.append(width)

    monkeypatch.setattr(stream, "launch_rows", launch_rows)
    none = numpy.zeros(0, dtype=numpy.int64)
    launches, out = prepare(pack, bank, none, none, *_inputs(kernel, pack, bank, none, none, env))
    assert launches == {} and (out if isinstance(out, tuple) else (out,))[0].numel() == 0
    for w in (128, 256, 4096):   # a group of one class, as StreamDomains makes them
        one = bank.class_of[p_idx] == w
        launches, _out = prepare(pack, bank, s_idx[one], p_idx[one],
                                 *_inputs(kernel, pack, bank, s_idx[one], p_idx[one], env))
        assert list(launches) == [w]
    inputs = _inputs(kernel, pack, bank, s_idx, p_idx, env)
    launches, out = prepare(pack, bank, s_idx, p_idx, *inputs)
    assert sorted(launches) == [128, 256, 4096]
    for launch in launches.values():
        launch()
    assert sorted(seen) == [128, 256, 4096]
    want = _plain_rows(kernel, pack, bank, s_idx, p_idx, 4096, inputs)
    for got, value in zip(out if isinstance(out, tuple) else (out,), want):
        assert got.shape == value.shape
        if got.dtype == torch.bfloat16:
            torch.testing.assert_close(got.float(), value.float(), atol=1e-30, rtol=BF16_STEP)
        elif got.dtype == torch.int32:
            assert torch.equal(got, value)
        else:
            torch.testing.assert_close(got, value, atol=1e-5, rtol=1e-5)
