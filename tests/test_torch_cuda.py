"""The CUDA kernels against their plain versions — needs an NVIDIA card.

Tolerances: max-plus kernels (A, B, H's Viterbi, I) 1e-4 nats; sum-product
kernels (C-G, H's Forward, J, K) and their log scales 1e-3 nats,
trajectories and posteriors 1e-4 absolute (float32 sums in another
order); bfloat16 planes within one bfloat16 step; envelopes and alignment
coordinates equal.  Only the port is imported here.

Marked ``cuda``; skipped (with the reason) where no card is present.
On a machine with one: ``python -m pytest tests/test_torch_cuda.py -q``.
"""

import numpy
import pytest
import torch

from gecco_tpu_torch.hmm.bank import NEG, TorchBank
from gecco_tpu_torch.hmm.domains import (
    _SMEM_CAP, PairDomains, pair_align, pair_align_plain, pair_posterior, pair_posterior_plain,
    pair_posterior_smem)
from gecco_tpu_torch.hmm.kernels import (
    DENSE_TILE, VITERBI_BLOCK_ROWS, SeqPack, dense_scores, dense_scores_plain, msv_filter,
    msv_filter_plain, msv_tile, ssv_filter, ssv_filter_plain, viterbi_pairs,
    viterbi_pairs_plain)
from gecco_tpu_torch.hmm.pipeline import SearchPipeline
from gecco_tpu_torch.hmm.synthetic import (
    consensus_proteins, plant_domain, synthetic_profiles, synthetic_proteins)
from gecco_tpu_torch.hmm.stream import (
    _MAX_LPS, ALIGN_FWD_BLOCK_ROWS, DOMAIN_BLOCK_ROWS, FORWARD_BLOCK_ROWS, StreamDomains,
    align_bwd, align_bwd_plain, align_fwd, align_fwd_plain, envelopes, forward_pairs,
    forward_pairs_plain, posterior_bwd, posterior_bwd_plain, posterior_fwd, posterior_fwd_plain)
from gecco_tpu_torch.profiling import TIMER

pytestmark = pytest.mark.cuda


def _launches(kernel=None):
    """Launches since ``TIMER.reset()`` (its ``launch.<kernel>`` counters):
    of ``kernel``, or of each kernel launched."""
    counts = {key[len("launch."):]: n for key, n in TIMER.counters.items()
              if key.startswith("launch.")}
    return counts if kernel is None else counts.get(kernel, 0)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def workload(device):
    # width classes 128, 512, 1,024 and, from the last two, 2,048 and 4,096
    profiles = synthetic_profiles(12, min_length=20, max_length=700, seed=5)
    profiles += synthetic_profiles(1, min_length=1500, max_length=1500, seed=8)
    profiles += synthetic_profiles(1, min_length=2100, max_length=2100, seed=6)
    rng = numpy.random.default_rng(1)
    seqs = [x[:600] for x in synthetic_proteins(24, mean_length=250, seed=7)]
    for i in range(0, len(seqs), 2):
        gm = profiles[i % len(profiles)]
        seqs[i] = plant_domain(seqs[i], gm, rng, max_len=min(gm.M, 200), divergence=0.2)
    seqs.append(numpy.zeros(0, dtype=numpy.int32))
    bank = TorchBank.build(profiles, device)
    assert {1024, 2048, 4096} <= set(bank.class_of.tolist())
    return profiles, seqs, SeqPack(seqs, device), bank


def test_ssv_kernel_matches_plain(workload):
    _profiles, _seqs, pack, bank = workload
    TIMER.reset()
    got = ssv_filter(pack, bank)
    torch.cuda.synchronize()
    assert _launches("ssv_filter") > 0
    torch.testing.assert_close(got, ssv_filter_plain(pack, bank), atol=1e-4, rtol=0)


@pytest.mark.parametrize("lengths", [(128, 256), (125, 126, 127)],
                         ids=["full-width", "near-cap"])
def test_ssv_kernel_full_width_and_near_cap(device, lengths):
    """Kernel A on the banks the TPU served with its other SSV variants:
    profiles that fill their width class (``_pallas_ssv``'s lane-0 mask)
    and profiles within three nodes of it (``_pallas_ssv_pair``), each
    protein with a consensus ending on the last node."""
    profiles = [gm for seed, m in enumerate(lengths)
                for gm in synthetic_profiles(1, min_length=m, max_length=m, seed=seed)]
    seqs = [x for seed, gm in enumerate(profiles)
            for x in consensus_proteins(gm, count=5, length=gm.M + 40, seed=seed)]
    pack, bank = SeqPack(seqs, device), TorchBank.build(profiles, device)
    got = ssv_filter(pack, bank)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ssv_filter_plain(pack, bank), atol=1e-4, rtol=0)


def test_msv_kernel_matches_plain(workload):
    """Kernel I on every width class of the bank (128 to 4,096 nodes)."""
    _profiles, _seqs, pack, bank = workload
    TIMER.reset()
    got = msv_filter(pack, bank)
    torch.cuda.synchronize()
    assert _launches("msv_filter") == len(bank.classes)
    torch.testing.assert_close(got, msv_filter_plain(pack, bank), atol=1e-4, rtol=0)
    assert (got >= ssv_filter(pack, bank) - 1e-4).all()


#: model lengths of the edge bank: 33 and 95, each width class's width - 1
#: and width, and 129 across the 128/129 boundary
EDGE_MODELS = (33, 95, 127, 128, 129, 255, 256, 511, 512, 1023, 1024, 2047, 2048, 4095, 4096)
#: sequence lengths around a warp's 32 lanes and a 4-byte word of residues
EDGE_SEQS = (0, 1, 31, 32, 33, 2000)


@pytest.fixture(scope="module")
def edge_workload(device):
    """Kernels A, B and H at their edges: every width class 128 to 4,096 with
    the models of ``EDGE_MODELS``, the sequences of ``EDGE_SEQS`` (each
    but the first two a consensus run ending on a profile's last node: of
    33, 128, 129 and 4,096 nodes) and 40 proteins with planted domains,
    more than kernel A's tile of 32 sequences."""
    profiles = [gm for seed, m in enumerate(EDGE_MODELS)
                for gm in synthetic_profiles(1, min_length=m, max_length=m, seed=20 + seed)]
    by_length = {gm.M: gm for gm in profiles}
    rng = numpy.random.default_rng(3)

    def tail(m, n):
        """Consensus of the last ``n`` nodes of the ``m``-node profile."""
        cons = numpy.argmax(by_length[m].hmm.match[1:, :20], axis=1).astype(numpy.int32)
        return cons[m - n:]

    seqs = [numpy.zeros(0, dtype=numpy.int32), rng.integers(0, 20, 1).astype(numpy.int32),
            tail(33, 31), tail(128, 32), tail(129, 33), tail(4096, 2000)]
    assert tuple(map(len, seqs)) == EDGE_SEQS
    for i, x in enumerate(synthetic_proteins(40, mean_length=300, seed=12)):
        gm = profiles[i % len(profiles)]
        seqs.append(plant_domain(x, gm, rng, max_len=min(gm.M, 200), divergence=0.2))
    bank = TorchBank.build(profiles, device)
    assert [w for w, _ in bank.classes] == [128, 256, 512, 1024, 2048, 4096]
    return profiles, seqs, SeqPack(seqs, device), bank


def test_ssv_kernel_edges(edge_workload):
    """Kernel A against its plain version on the edge bank: every class,
    one launch a class; the largest difference is printed (0.0 expected)."""
    _profiles, _seqs, pack, bank = edge_workload
    TIMER.reset()
    got = ssv_filter(pack, bank)
    torch.cuda.synchronize()
    assert _launches("ssv_filter") == len(bank.classes)
    want = ssv_filter_plain(pack, bank)
    err = float((got - want).abs().max())
    print(f"kernel A on the edge bank: largest difference {err!r} nats")
    assert err <= 1e-4
    assert (got[0] == NEG).all()                  # the empty sequence


def _edge_pairs(n_seqs, n_profiles):
    """One pair of the 33-node profile (the 2,000-residue sequence), every
    sequence against the 95-node profile (more rows than a block of
    kernel B takes), and each other profile against the edge sequences and
    four proteins."""
    s, p = [len(EDGE_SEQS) - 1], [0]
    s += list(range(n_seqs))
    p += [1] * n_seqs
    proteins = n_seqs - len(EDGE_SEQS)
    for q in range(2, n_profiles):
        mine = list(range(len(EDGE_SEQS))) + [len(EDGE_SEQS) + (3 * q + i) % proteins
                                               for i in range(4)]
        s += mine
        p += [q] * len(mine)
    return numpy.array(s), numpy.array(p)


@pytest.mark.parametrize("windows", [False, True], ids=["whole", "windows"])
def test_viterbi_kernel_edges(edge_workload, windows):
    """Kernel B against its plain version on the edge bank, every class in
    one launch each; with windows, empty ones (-inf) and ``[0, L)`` ones
    (equal to the launch without ``ranges``).  The largest difference is
    printed (0.0 expected)."""
    profiles, seqs, pack, bank = edge_workload
    s_idx, p_idx = _edge_pairs(len(seqs), len(profiles))
    assert (p_idx == 1).sum() > VITERBI_BLOCK_ROWS and (p_idx == 0).sum() == 1
    lens = pack.lens_host[s_idx].astype(numpy.int64)
    ranges = None
    if windows:
        rng = numpy.random.default_rng(4)
        start = (rng.random(len(lens)) * lens).astype(numpy.int64)
        end = start + (rng.random(len(lens)) * (lens - start)).astype(numpy.int64)
        end[::5] = start[::5]                       # empty windows
        start[1::5], end[1::5] = 0, lens[1::5]      # [0, L) windows
        ranges = numpy.stack([start, end], 1)
    TIMER.reset()
    got = viterbi_pairs(pack, bank, s_idx, p_idx, ranges=ranges)
    torch.cuda.synchronize()
    assert _launches("viterbi_pairs") == len(bank.classes)
    want = viterbi_pairs_plain(pack, bank, s_idx, p_idx, ranges=ranges)
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite)
    err = float((got[finite] - want[finite]).abs().max())
    print(f"kernel B on the edge bank ({'windows' if windows else 'whole sequences'}): "
          f"largest difference {err!r} nats")
    assert err <= 1e-4
    if windows:
        empty = torch.as_tensor(ranges[:, 0] == ranges[:, 1], device=pack.device)
        assert torch.isneginf(got[empty]).all()
        full = torch.as_tensor((ranges[:, 0] == 0) & (ranges[:, 1] == lens) & (lens > 0),
                               device=pack.device)
        assert torch.equal(got[full], viterbi_pairs(pack, bank, s_idx, p_idx)[full])


#: model lengths on both sides of 32 k nodes, where kernels I and C change
#: the nodes a lane (C = ceil(M / 32)), in every width class
NODE_MODELS = (31, 32, 33, 63, 64, 65, 159, 160, 161, 415, 416, 417, 831, 832, 833, 1100, 2100)


@pytest.fixture(scope="module")
def node_workload(device):
    """Kernels I and C where the nodes a lane change: the profiles of
    ``NODE_MODELS`` (every class 128 to 4,096), and one sequence more than
    kernel I's largest tile (``msv_tile``), of 0 to 2,000 residues, so that
    the last tile of the 128-node class holds one sequence and a block of
    kernel C takes rows that differ widely in length; half carry a planted
    domain."""
    profiles = [gm for seed, m in enumerate(NODE_MODELS)
                for gm in synthetic_profiles(1, min_length=m, max_length=m, seed=50 + seed)]
    rng = numpy.random.default_rng(5)
    lengths = [0, 1, 2, 3, 5, 31, 32, 33, 64, 127, 300, 700, 1500, 2000]
    lengths += rng.integers(20, 600, msv_tile(128) + 1 - len(lengths)).tolist()
    seqs = [rng.integers(0, 20, n).astype(numpy.int32) for n in lengths]
    for i in range(8, len(seqs), 2):
        gm = profiles[i % len(profiles)]
        seqs[i] = plant_domain(seqs[i], gm, rng, max_len=min(gm.M, len(seqs[i]) // 2, 200),
                               divergence=0.2)
    bank = TorchBank.build(profiles, device)
    assert [w for w, _ in bank.classes] == [128, 256, 512, 1024, 2048, 4096]
    return profiles, seqs, SeqPack(seqs, device), bank


@pytest.mark.parametrize("bank_of", ["edge", "nodes"])
def test_msv_kernel_edges(edge_workload, node_workload, bank_of):
    """Kernel I against its plain version bit for bit, every class 128 to
    4,096 in one launch each: the edge bank (models of every class's width
    - 1 and width, sequences of 0 to 2,000 residues, 46 sequences: a tile
    and a ragged one at 256 nodes and above) and the node bank (models at
    32 k - 1, 32 k and 32 k + 1 nodes, one sequence past the largest tile).
    The largest difference is printed (0.0 expected)."""
    _profiles, _seqs, pack, bank = edge_workload if bank_of == "edge" else node_workload
    TIMER.reset()
    got = msv_filter(pack, bank)
    torch.cuda.synchronize()
    assert _launches("msv_filter") == len(bank.classes)
    want = msv_filter_plain(pack, bank)
    err = float((got - want).abs().max())
    print(f"kernel I on the {bank_of} bank, {pack.S} sequences: largest difference {err!r} nats, "
          f"{int((got != want).sum())} scores not bit-equal")
    assert torch.equal(got, want)
    assert (got[torch.as_tensor(pack.lens_host == 0, device=pack.device)] == NEG).all()


@pytest.mark.parametrize("windows", [False, True], ids=["whole", "windows"])
def test_forward_kernel_edges(node_workload, device, windows):
    """Kernel C against its plain version on the node bank, every class in
    one launch each: every sequence against every profile (each profile's
    rows more than a block of ``FORWARD_BLOCK_ROWS``, of 0 to 2,000
    residues) and a sequence of 5,000 residues against the 128- and
    4,096-node classes.  With windows, empty ones (-inf) and ``[0, L)``
    ones (bit-equal to the launch without ``ranges``).  The largest
    difference is printed."""
    profiles, seqs, _pack, bank = node_workload
    rng = numpy.random.default_rng(8)
    pack = SeqPack(seqs + [rng.integers(0, 20, 5000).astype(numpy.int32)], device)
    long = pack.S - 1
    s_idx = numpy.repeat(numpy.arange(long), len(profiles))
    p_idx = numpy.tile(numpy.arange(len(profiles)), long)
    outer = numpy.flatnonzero(numpy.isin(bank.class_of, (128, 4096)))
    s_idx = numpy.concatenate([s_idx, numpy.full(len(outer), long)])
    p_idx = numpy.concatenate([p_idx, outer])
    assert (numpy.bincount(p_idx) > FORWARD_BLOCK_ROWS).all()
    lens = pack.lens_host[s_idx].astype(numpy.int64)
    ranges = None
    if windows:
        start = (rng.random(len(lens)) * lens).astype(numpy.int64)
        end = start + (rng.random(len(lens)) * (lens - start)).astype(numpy.int64)
        end[::5] = start[::5]                       # empty windows
        start[1::5], end[1::5] = 0, lens[1::5]      # [0, L) windows
        ranges = numpy.stack([start, end], 1)
    TIMER.reset()
    got = forward_pairs(pack, bank, s_idx, p_idx, ranges=ranges)
    torch.cuda.synchronize()
    assert _launches("forward_pairs") == len(bank.classes)
    want = forward_pairs_plain(pack, bank, s_idx, p_idx, ranges=ranges)
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite)
    err = float((got[finite] - want[finite]).abs().max())
    print(f"kernel C on the node bank ({'windows' if windows else 'whole sequences'}, "
          f"{len(s_idx)} pairs): largest difference {err!r} nats")
    assert err <= 1e-3
    if windows:
        empty = torch.as_tensor(ranges[:, 0] == ranges[:, 1], device=pack.device)
        assert torch.isneginf(got[empty]).all()
        full = torch.as_tensor((ranges[:, 0] == 0) & (ranges[:, 1] == lens) & (lens > 0),
                               device=pack.device)
        assert torch.equal(got[full], forward_pairs(pack, bank, s_idx, p_idx)[full])
    else:
        assert (got[torch.as_tensor(lens == 0, device=pack.device)] == NEG).all()


@pytest.fixture(scope="module")
def domain_edge_rows(node_workload, device):
    """Rows of kernels D-G on the node bank, one group per width class
    as ``StreamDomains`` makes them: every profile against
    18 sequences (more rows than a block of ``DOMAIN_BLOCK_ROWS``), the
    empty one and the 2,000-residue one among them, and a sequence of
    4,096 residues against the 128- and 4,096-node classes; the rows of a
    class interleave its profiles."""
    profiles, seqs, _pack, bank = node_workload
    rng = numpy.random.default_rng(11)
    pack = SeqPack(seqs + [rng.integers(0, 20, 4096).astype(numpy.int32)], device)
    long = pack.S - 1
    lens = pack.lens_host
    per = 18
    picks = [numpy.concatenate([[0, int(numpy.argmax(lens[:long]))],
                                rng.choice(numpy.arange(1, long), per - 2, replace=False)])
             for _p in profiles]
    s_idx = numpy.array([picks[p][i] for i in range(per) for p in range(len(profiles))])
    p_idx = numpy.array([p for _i in range(per) for p in range(len(profiles))])
    outer = numpy.flatnonzero(numpy.isin(bank.class_of, (128, 4096)))
    s_idx = numpy.concatenate([s_idx, numpy.full(len(outer), long)])
    p_idx = numpy.concatenate([p_idx, outer])
    assert (numpy.bincount(p_idx) > max(DOMAIN_BLOCK_ROWS.values())).all()
    assert max(ALIGN_FWD_BLOCK_ROWS.values()) <= max(DOMAIN_BLOCK_ROWS.values())
    width = bank.class_of[p_idx]
    return pack, bank, [(s_idx[width == w], p_idx[width == w]) for w in sorted(set(width))]


def _past_length(pack, s_idx, stride):
    """``[n, stride]``: residues at or past each row's length."""
    lens = torch.as_tensor(pack.lens_host[s_idx], device=pack.device)
    return torch.arange(stride, device=pack.device)[None, :] >= lens[:, None]


def test_posterior_fwd_kernel_edges(domain_edge_rows):
    """Kernel D against its plain version on the node bank's rows (models
    at 32 k - 1, 32 k and 32 k + 1 nodes, more rows of a profile than a
    block, interleaved profiles, an empty sequence, 4,096 residues): one
    launch a class; the trajectories zero past each row's length, the
    empty sequence scoring -1e30.  The largest differences are printed."""
    pack, bank, groups = domain_edge_rows
    errs = [0.0, 0.0]
    for s_idx, p_idx in groups:
        TIMER.reset()
        traj, score = posterior_fwd(pack, bank, s_idx, p_idx)
        torch.cuda.synchronize()
        assert _launches("posterior_fwd") == 1
        want_traj, want_score = posterior_fwd_plain(pack, bank, s_idx, p_idx)
        _close(traj[:4], want_traj[:4], 1e-4)
        _close(traj[4], want_traj[4], 1e-3)
        _close(score, want_score, 1e-3)
        errs[0] = max(errs[0], float((traj[:4] - want_traj[:4]).abs().max()))
        errs[1] = max(errs[1], float((traj[4] - want_traj[4]).abs().max()),
                      float((score - want_score).abs().max()))
        past = _past_length(pack, s_idx, traj.shape[2])
        assert (traj[:, past] == 0).all()
        assert (score[torch.as_tensor(pack.lens_host[s_idx] == 0, device=pack.device)]
                == NEG).all()
    print(f"kernel D on the node bank ({len(groups)} classes): largest difference "
          f"{errs[0]!r} (N, B, J, C), {errs[1]!r} nats (log scale, score)")


def test_align_bwd_kernel_edges(domain_edge_rows):
    """Kernel F against its plain version on the rows of
    ``test_posterior_fwd_kernel_edges``: one launch a class; the planes
    within one bfloat16 step and exactly zero past each row's length and
    at nodes [32 ceil(M / 32), width) of every residue, the logs within
    1e-3 nats and zero past each row's length.  The largest differences
    are printed."""
    pack, bank, groups = domain_edge_rows
    errs = [0.0, 0.0]
    lengths = bank.lengths.cpu().numpy()
    for s_idx, p_idx in groups:
        TIMER.reset()
        planes, logs = align_bwd(pack, bank, s_idx, p_idx)
        torch.cuda.synchronize()
        assert _launches("align_bwd") == 1
        want_planes, want_logs = align_bwd_plain(pack, bank, s_idx, p_idx)
        _close(planes, want_planes, 1e-30, rtol=2.0 ** -7)
        _close(logs, want_logs, 1e-3)
        diff = (planes.float() - want_planes.float()).abs()
        errs[0] = max(errs[0], float((diff / want_planes.float().abs().clamp(min=1e-30)).max()))
        errs[1] = max(errs[1], float((logs - want_logs).abs().max()))
        past = _past_length(pack, s_idx, planes.shape[2])
        assert (planes[:, past] == 0).all() and (logs[:, past] == 0).all()
        computed = torch.as_tensor(32 * -(-lengths[p_idx] // 32), device=pack.device)
        beyond = torch.arange(planes.shape[3], device=pack.device)[None, :] >= computed[:, None]
        assert (planes.permute(0, 2, 1, 3)[:, :, beyond] == 0).all()
    print(f"kernel F on the node bank ({len(groups)} classes): largest relative difference "
          f"{errs[0]!r} (planes), {errs[1]!r} nats (logs)")


def test_posterior_bwd_kernel_edges(domain_edge_rows):
    """Kernel E against its plain version on the rows of
    ``test_posterior_fwd_kernel_edges`` (models at 32 k - 1, 32 k and 32 k
    + 1 nodes, more rows of a profile than a block, interleaved profiles, an
    empty sequence, 4,096 residues), on plain kernel D's trajectories and
    scores: one launch a class; mocc and pB within 1e-4 and zero past each
    row's length.  The largest difference is printed."""
    pack, bank, groups = domain_edge_rows
    err = 0.0
    for s_idx, p_idx in groups:
        traj, score = posterior_fwd_plain(pack, bank, s_idx, p_idx)
        TIMER.reset()
        post = posterior_bwd(pack, bank, s_idx, p_idx, traj, score)
        torch.cuda.synchronize()
        assert _launches("posterior_bwd") == 1
        want = posterior_bwd_plain(pack, bank, s_idx, p_idx, traj, score)
        _close(post, want, 1e-4)
        err = max(err, float((post - want).abs().max()))
        past = _past_length(pack, s_idx, post.shape[2])
        assert (post[:, past] == 0).all()
    print(f"kernel E on the node bank ({len(groups)} classes): largest difference {err!r} "
          f"(mocc, pB)")


def test_align_fwd_kernel_edges(domain_edge_rows):
    """Kernel G against its plain version on the non-empty rows of
    ``test_posterior_fwd_kernel_edges``, on plain kernel F's planes and
    plain kernel D's scores: one launch a class; envelopes [1, 1], [L, L],
    [1, L], iv = jv and others in turn; the envelope score and null2
    log-ratios within 1e-3 nats, the coordinates equal.  The largest
    differences are printed."""
    pack, bank, groups = domain_edge_rows
    rng = numpy.random.default_rng(13)
    errs = [0.0, 0.0]
    for s_idx, p_idx in groups:
        keep = pack.lens_host[s_idx] > 0
        s_idx, p_idx = s_idx[keep], p_idx[keep]
        L = pack.lens_host[s_idx].astype(numpy.int64)
        iv = 1 + (rng.random(len(L)) * L).astype(numpy.int64)
        jv = iv + (rng.random(len(L)) * (L - iv + 1)).astype(numpy.int64)
        kind = numpy.arange(len(L)) % 5
        iv[kind == 0], jv[kind == 0] = 1, 1
        iv[kind == 1], jv[kind == 1] = L[kind == 1], L[kind == 1]
        iv[kind == 2], jv[kind == 2] = 1, L[kind == 2]
        jv[kind == 3] = iv[kind == 3]
        _traj, score = posterior_fwd_plain(pack, bank, s_idx, p_idx)
        planes, logs = align_bwd_plain(pack, bank, s_idx, p_idx)
        TIMER.reset()
        out, coords = align_fwd(pack, bank, s_idx, p_idx, planes, logs, iv, jv, score)
        torch.cuda.synchronize()
        assert _launches("align_fwd") == 1
        want_out, want_coords = align_fwd_plain(pack, bank, s_idx, p_idx, planes, logs, iv, jv,
                                                score)
        _close(out, want_out, 1e-3)
        errs[0] = max(errs[0], float((out[:, 0] - want_out[:, 0]).abs().max()))
        errs[1] = max(errs[1], float((out[:, 1:] - want_out[:, 1:]).abs().max()))
        assert torch.equal(coords, want_coords)
    print(f"kernel G on the node bank ({len(groups)} classes): largest difference "
          f"{errs[0]!r} nats (envelope score), {errs[1]!r} (null2 log-ratios)")


#: model lengths of the 1,024-, 2,048- and 4,096-node classes and the
#: lengths of the long rows' sequences, past JAX's 4,096-residue pack limit
LONG_MODELS = (1000, 2000, 2200)
LONG_SEQS = (6000, 5900, 300)


@pytest.fixture(scope="module")
def long_domain_rows(device):
    """Rows of kernels D-G of about 6,000 residues: a random sequence, one
    carrying a diverged domain of each profile of ``LONG_MODELS`` and one of
    300 residues (zeros past it to the stride), against every profile, one
    group per width class as ``StreamDomains`` makes them."""
    profiles = [gm for seed, m in enumerate(LONG_MODELS)
                for gm in synthetic_profiles(1, min_length=m, max_length=m, seed=70 + seed)]
    rng = numpy.random.default_rng(17)
    seqs = [rng.integers(0, 20, n).astype(numpy.int32) for n in LONG_SEQS]
    for gm, offset in zip(profiles, (100, 1800, 3700)):
        seqs[1] = plant_domain(seqs[1], gm, rng, offset=offset, max_len=min(gm.M, 1500),
                               divergence=0.2)
    bank = TorchBank.build(profiles, device)
    assert bank.class_of.tolist() == [1024, 2048, 4096]
    s_idx = numpy.repeat(numpy.arange(len(seqs)), len(profiles))
    p_idx = numpy.tile(numpy.arange(len(profiles)), len(seqs))
    width = bank.class_of[p_idx]
    groups = [(s_idx[width == w], p_idx[width == w]) for w in sorted(set(width.tolist()))]
    return profiles, seqs, SeqPack(seqs, device), bank, groups


def test_domain_kernels_on_long_rows(long_domain_rows):
    """Kernels D-G against their plain versions on rows of up to 6,000
    residues at the 1,024-, 2,048- and 4,096-node classes, one launch a
    class: D's trajectories and score, E's posteriors on plain D's, F's
    planes and logs, G on plain F's planes over the envelopes the plain
    posteriors give (each row's first, else the whole sequence) and over
    whole sequences; zeros past each row's length.  The log scales run
    over every residue (summed in double precision).  The largest
    differences are printed."""
    _profiles, _seqs, pack, bank, groups = long_domain_rows
    errs = dict.fromkeys(("traj", "log scale", "post", "planes", "logs", "G"), 0.0)
    for s_idx, p_idx in groups:
        traj, score = posterior_fwd(pack, bank, s_idx, p_idx)
        want_traj, want_score = posterior_fwd_plain(pack, bank, s_idx, p_idx)
        _close(traj[:4], want_traj[:4], 1e-4)
        _close(traj[4], want_traj[4], 1e-3)
        _close(score, want_score, 1e-3)
        post = posterior_bwd(pack, bank, s_idx, p_idx, want_traj, want_score)
        want_post = posterior_bwd_plain(pack, bank, s_idx, p_idx, want_traj, want_score)
        _close(post, want_post, 1e-4)
        past = _past_length(pack, s_idx, traj.shape[2])
        assert (traj[:, past] == 0).all() and (post[:, past] == 0).all()
        planes, logs = align_bwd(pack, bank, s_idx, p_idx)
        want_planes, want_logs = align_bwd_plain(pack, bank, s_idx, p_idx)
        _close(planes, want_planes, 1e-30, rtol=2.0 ** -7)
        _close(logs, want_logs, 1e-3)
        assert (planes[:, past] == 0).all() and (logs[:, past] == 0).all()
        lens = pack.lens[torch.as_tensor(s_idx, device=pack.device)]
        env_i, env_j, _over = envelopes(want_post[0], want_post[1], lens)
        ok = env_j >= env_i
        first = torch.argmax(ok.int(), dim=1, keepdim=True)
        has = ok.any(dim=1)
        iv = torch.where(has, env_i.gather(1, first)[:, 0], 1).to(torch.int32).cpu().numpy()
        jv = torch.where(has, env_j.gather(1, first)[:, 0], lens).to(torch.int32).cpu().numpy()
        for env in ((iv, jv), (numpy.ones_like(jv), pack.lens_host[s_idx])):
            out, coords = align_fwd(pack, bank, s_idx, p_idx, want_planes, want_logs, *env,
                                    want_score)
            want_out, want_coords = align_fwd_plain(pack, bank, s_idx, p_idx, want_planes,
                                                    want_logs, *env, want_score)
            _close(out, want_out, 1e-3)
            assert torch.equal(coords, want_coords)
            errs["G"] = max(errs["G"], float((out - want_out).abs().max()))
        errs["traj"] = max(errs["traj"], float((traj[:4] - want_traj[:4]).abs().max()))
        errs["log scale"] = max(errs["log scale"], float((traj[4] - want_traj[4]).abs().max()),
                                float((score - want_score).abs().max()))
        errs["post"] = max(errs["post"], float((post - want_post).abs().max()))
        diff = (planes.float() - want_planes.float()).abs()
        errs["planes"] = max(errs["planes"],
                             float((diff / want_planes.float().abs().clamp(min=1e-30)).max()))
        errs["logs"] = max(errs["logs"], float((logs - want_logs).abs().max()))
    print("kernels D-G on rows of up to 6,000 residues: largest differences "
          + ", ".join(f"{name} {value!r}" for name, value in errs.items()))


def test_stream_domains_long_rows_cuda_matches_torch(long_domain_rows):
    """``StreamDomains`` on the long rows: no pair to the host engine, every
    long row defined by kernels D-G, the domains of the plain versions."""
    profiles, seqs, pack, bank, groups = long_domain_rows
    pairs = [(int(s), int(p)) for s_idx, p_idx in groups for s, p in zip(s_idx, p_idx)]
    domains = StreamDomains(bank, profiles)
    got = domains.define(seqs, pairs, pack)
    long = sum(1 for s, _ in pairs if len(seqs[s]) > _MAX_LPS)
    assert domains.counts == {"host_pairs.length": 0, "host_pairs.overflow": 0,
                              "domains.long_rows": long}
    assert sum(map(len, got.values())) >= len(LONG_MODELS)
    _same_domains(got, StreamDomains(bank, profiles, backend="torch").define(seqs, pairs, pack))


@pytest.mark.parametrize("kernel, plain, tol", [
    (viterbi_pairs, viterbi_pairs_plain, 1e-4),
    (forward_pairs, forward_pairs_plain, 1e-3),
])
def test_pair_kernels_match_plain(workload, kernel, plain, tol):
    profiles, seqs, pack, bank = workload
    s_idx = numpy.repeat(numpy.arange(len(seqs)), len(profiles))
    p_idx = numpy.tile(numpy.arange(len(profiles)), len(seqs))
    got = kernel(pack, bank, s_idx, p_idx)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, plain(pack, bank, s_idx, p_idx), atol=tol, rtol=0)


@pytest.mark.parametrize("viterbi, tol", [(False, 1e-3), (True, 1e-4)])
def test_dense_kernel_matches_plain(workload, viterbi, tol):
    """Kernel H on every width class of the bank (128 to 4,096 nodes)."""
    _profiles, _seqs, pack, bank = workload
    TIMER.reset()
    got = dense_scores(pack, bank, viterbi=viterbi)
    torch.cuda.synchronize()
    assert _launches("dense_scores") == len(bank.classes)
    want = dense_scores_plain(pack, bank, viterbi=viterbi)
    assert torch.isneginf(want[-1]).all()       # the empty sequence
    torch.testing.assert_close(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("viterbi, tol", [(False, 1e-3), (True, 1e-4)],
                         ids=["forward", "viterbi"])
@pytest.mark.parametrize("pack_of", ["one", "ragged"])
def test_dense_kernel_edges(edge_workload, device, viterbi, tol, pack_of):
    """Kernel H against its plain version on the edge bank, every class
    128 to 4,096 in one launch each: a pack of one sequence (the 2,000
    residues), and a pack of ``DENSE_TILE + 1`` sequences (the edge
    sequences of 0 to 2,000 residues and proteins, repeated), whose last
    tile holds one sequence, so that the block's shared counter runs dry
    in its first warp.  The largest difference is printed."""
    _profiles, seqs, _pack, bank = edge_workload
    if pack_of == "one":
        chosen = [seqs[EDGE_SEQS.index(2000)]]
    else:
        chosen = [seqs[i % len(seqs)] for i in range(DENSE_TILE + 1)]
    pack = SeqPack(chosen, device)
    TIMER.reset()
    got = dense_scores(pack, bank, viterbi=viterbi)
    torch.cuda.synchronize()
    assert _launches("dense_scores") == len(bank.classes)
    want = dense_scores_plain(pack, bank, viterbi=viterbi)
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite)
    assert int(finite.sum()) == (pack.lens_host > 0).sum() * bank.P
    err = float((got[finite] - want[finite]).abs().max())
    print(f"kernel H ({'Viterbi' if viterbi else 'Forward'}) on the edge bank, "
          f"{pack.S} sequences: largest difference {err!r} nats")
    assert err <= tol


@pytest.mark.parametrize("max_filter", [False, True])
def test_search_cuda_matches_torch(workload, device, max_filter):
    profiles, seqs, _pack, _bank = workload
    a = SearchPipeline(profiles, device=device, backend="cuda", max_filter=max_filter)
    b = SearchPipeline(profiles, device=device, backend="torch", max_filter=max_filter)
    hits_a, hits_b = a.search(seqs), b.search(seqs)
    assert a.stage_counts == b.stage_counts
    assert [(h.sequence_index, h.profile.name) for h in hits_a] == [
        (h.sequence_index, h.profile.name) for h in hits_b]


def test_sharded_search_on_one_card_matches_single(workload, device):
    """Two shards on one card, one thread each: the one-device search's
    hits and funnel, and the launches the two shards make alone."""
    from gecco_tpu_torch.parallel import shard_sequences

    profiles, seqs, _pack, _bank = workload
    single = SearchPipeline(profiles, device=device, backend="cuda")
    expected = single.search(seqs)
    shards = shard_sequences(seqs, 2)
    TIMER.reset()
    for shard in shards:
        alone = SearchPipeline(profiles, device=device, backend="cuda", Z=len(seqs))
        alone.search([seqs[i] for i in shard])
    torch.cuda.synchronize()
    separate = _launches()
    multi = SearchPipeline(profiles, device=device, backend="cuda",
                           devices=[device, device])
    TIMER.reset()
    hits = multi.search(seqs)
    torch.cuda.synchronize()
    assert _launches() == separate and separate["ssv_filter"] > 0
    assert multi.stage_devices == 2 and multi.stage_counts == single.stage_counts
    assert [(h.sequence_index, h.profile.name) for h in hits] == [
        (h.sequence_index, h.profile.name) for h in expected]
    for a, b in zip(hits, expected):
        assert abs(a.score - b.score) <= 1e-4


def test_host_path_launches_nothing(workload, device):
    profiles, seqs, _pack, _bank = workload
    pipeline = SearchPipeline(profiles, device=device, use_accelerator=False)
    TIMER.reset()
    before = torch.cuda.memory_allocated(device)
    hits = pipeline.search(seqs[:3])
    assert (_launches(), torch.cuda.memory_allocated(device)) == ({}, before)
    assert pipeline._torch_bank is None
    assert all(numpy.isfinite(h.score) for h in hits)


def test_calibrate_launches_kernels_a_and_h(device):
    """``calibrate`` on the card: kernel A once a width class, kernel H
    twice (Viterbi, Forward), no B or C; the stats of the plain versions."""
    from gecco_tpu_torch.hmm.calibrate import calibrate

    mine = synthetic_profiles(6, min_length=30, max_length=600, seed=4)
    plain = synthetic_profiles(6, min_length=30, max_length=600, seed=4)
    TIMER.reset()
    calibrate(mine, device=device, n=64, L=96)
    torch.cuda.synchronize()
    classes = len(TorchBank.build(mine, device).classes)
    assert _launches("ssv_filter") == classes
    assert _launches("dense_scores") == 2 * classes
    assert _launches("viterbi_pairs") == _launches("forward_pairs") == 0
    calibrate(plain, device=device, n=64, L=96, backend="torch")
    for a, b in zip(mine, plain):
        for key in ("MSV", "VITERBI", "FORWARD"):
            assert abs(a.hmm.stats[key][0] - b.hmm.stats[key][0]) <= 1e-3, key


@pytest.mark.parametrize("bias_filter", [True, False], ids=["bias", "nobias"])
def test_search_msv_cuda_matches_torch(workload, device, bias_filter):
    profiles, seqs, _pack, _bank = workload
    a, b = (SearchPipeline(profiles, device=device, backend=backend, filter_stage="msv",
                           bias_filter=bias_filter) for backend in ("cuda", "torch"))
    TIMER.reset()
    hits_a, hits_b = a.search(seqs), b.search(seqs)
    assert _launches("msv_filter") > 0
    assert a.stage_counts == b.stage_counts
    assert [(h.sequence_index, h.profile.name) for h in hits_a] == [
        (h.sequence_index, h.profile.name) for h in hits_b]


@pytest.fixture(scope="module")
def domain_rows(workload):
    """Every (sequence, profile) pair of the workload, one group per width class."""
    profiles, seqs, pack, bank = workload
    s_all = numpy.repeat(numpy.arange(len(seqs)), len(profiles))
    p_all = numpy.tile(numpy.arange(len(profiles)), len(seqs))
    width = bank.class_of[p_all]
    return [(s_all[width == w], p_all[width == w]) for w in sorted(set(width.tolist()))]


def _close(got, want, atol, rtol=0.0):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_posterior_kernels_match_plain(workload, domain_rows):
    _profiles, _seqs, pack, bank = workload
    TIMER.reset()
    for s_idx, p_idx in domain_rows:
        traj, score = posterior_fwd(pack, bank, s_idx, p_idx)
        want_traj, want_score = posterior_fwd_plain(pack, bank, s_idx, p_idx)
        _close(traj[:4], want_traj[:4], 1e-4)
        _close(traj[4], want_traj[4], 1e-3)
        _close(score, want_score, 1e-3)
        post = posterior_bwd(pack, bank, s_idx, p_idx, want_traj, want_score)
        _close(post, posterior_bwd_plain(pack, bank, s_idx, p_idx, want_traj, want_score), 1e-4)
    assert (_launches("posterior_fwd"), _launches("posterior_bwd")) == (
        len(domain_rows), len(domain_rows))


def test_align_kernels_match_plain(workload, domain_rows):
    _profiles, _seqs, pack, bank = workload
    for s_idx, p_idx in domain_rows:
        traj, score = posterior_fwd_plain(pack, bank, s_idx, p_idx)
        post = posterior_bwd_plain(pack, bank, s_idx, p_idx, traj, score)
        lens = pack.lens[torch.as_tensor(s_idx, device=pack.device)]
        env_i, env_j, _over = envelopes(post[0], post[1], lens)
        # one envelope per row: the first slot found, else the whole sequence
        ok = env_j >= env_i
        first = torch.argmax(ok.int(), dim=1, keepdim=True)
        has = ok.any(dim=1)
        iv = torch.where(has, env_i.gather(1, first)[:, 0], 1).to(torch.int32)
        jv = torch.where(has, env_j.gather(1, first)[:, 0], lens).to(torch.int32)
        keep = (lens > 0).cpu().numpy()
        s_idx, p_idx = s_idx[keep], p_idx[keep]
        keep_t = torch.as_tensor(keep, device=pack.device)
        iv, jv = iv[keep_t].cpu(), jv[keep_t].cpu()
        score = score[keep_t].contiguous()
        planes, logs = align_bwd(pack, bank, s_idx, p_idx)
        want_planes, want_logs = align_bwd_plain(pack, bank, s_idx, p_idx)
        _close(planes, want_planes, 1e-30, rtol=2.0 ** -7)
        _close(logs, want_logs, 1e-3)
        out, coords = align_fwd(pack, bank, s_idx, p_idx, want_planes, want_logs, iv, jv, score)
        want_out, want_coords = align_fwd_plain(
            pack, bank, s_idx, p_idx, want_planes, want_logs, iv, jv, score)
        _close(out, want_out, 1e-3)
        torch.testing.assert_close(coords, want_coords, atol=0, rtol=0)


def _same_domains(got, want):
    assert sorted(got) == sorted(want)
    for key, doms in want.items():
        assert [(d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from, d.hmm_to)
                for d in got[key]] == [
            (d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from, d.hmm_to) for d in doms]
        for a, b in zip(got[key], doms):
            assert a.envsc == pytest.approx(b.envsc, abs=1e-3)
            assert a.bitscore == pytest.approx(b.bitscore, abs=1e-2)


def test_stream_domains_cuda_matches_torch(workload):
    profiles, seqs, pack, bank = workload
    pairs = [(s, p) for s in range(len(seqs)) for p in range(len(profiles))]
    got = StreamDomains(bank, profiles, backend="cuda").define(seqs, pairs, pack=pack)
    want = StreamDomains(bank, profiles, backend="torch").define(seqs, pairs, pack=pack)
    assert sum(len(v) for v in want.values()) >= len(seqs) // 2
    _same_domains(got, want)


@pytest.mark.parametrize("kernel, plain, tol", [
    (viterbi_pairs, viterbi_pairs_plain, 1e-4),
    (forward_pairs, forward_pairs_plain, 1e-3),
])
def test_windowed_pair_kernels_match_plain(workload, kernel, plain, tol):
    """Kernels B and C over residue windows, every width class: a full
    window equals the launch without ``ranges`` bit for bit, inner windows
    match the plain version, an empty window scores -inf."""
    profiles, seqs, pack, bank = workload
    s_idx = numpy.repeat(numpy.arange(len(seqs)), len(profiles))
    p_idx = numpy.tile(numpy.arange(len(profiles)), len(seqs))
    lens = pack.lens_host[s_idx].astype(numpy.int64)
    whole = kernel(pack, bank, s_idx, p_idx)
    full = kernel(pack, bank, s_idx, p_idx, ranges=numpy.stack([0 * lens, lens], 1))
    torch.cuda.synchronize()
    keep = torch.as_tensor(lens > 0, device=pack.device)
    assert torch.equal(full[keep], whole[keep])
    assert torch.isneginf(full[~keep]).all()
    rng = numpy.random.default_rng(2)
    start = (rng.random(len(lens)) * lens * 0.5).astype(numpy.int64)
    end = start + ((rng.random(len(lens)) * (lens - start))).astype(numpy.int64)
    end[::7] = start[::7]                       # empty windows
    ranges = numpy.stack([start, end], 1)
    got = kernel(pack, bank, s_idx, p_idx, ranges=ranges)
    want = plain(pack, bank, s_idx, p_idx, ranges=ranges)
    torch.cuda.synchronize()
    empty = torch.as_tensor(end == start, device=pack.device)
    assert torch.isneginf(got[empty]).all() and torch.isneginf(want[empty]).all()
    torch.testing.assert_close(got[~empty], want[~empty], atol=tol, rtol=0)


@pytest.mark.parametrize("emit_pe", [True, False])
def test_pair_posterior_kernel_matches_plain(workload, domain_rows, emit_pe):
    """Kernel J on every width class (128 to 4,096 nodes), one launch a class."""
    _profiles, _seqs, pack, bank = workload
    TIMER.reset()
    for s_idx, p_idx in domain_rows:
        got = pair_posterior(pack, bank, s_idx, p_idx, emit_pe=emit_pe)
        want = pair_posterior_plain(pack, bank, s_idx, p_idx, emit_pe=emit_pe)
        _close(got[0], want[0], 1e-3)
        for a, b in zip(got[1:3], want[1:3]):
            _close(a, b, 1e-4)
        if emit_pe:
            _close(got[3], want[3], 1e-4)
        else:
            assert got[3] is None and want[3] is None
    assert _launches("pair_posterior") == len(domain_rows)


def test_pair_align_kernel_matches_plain(workload, domain_rows):
    """Kernel K on every width class: one envelope per row (the first slot
    found, else the whole sequence)."""
    _profiles, _seqs, pack, bank = workload
    TIMER.reset()
    for s_idx, p_idx in domain_rows:
        score, mocc, pb, _pe = pair_posterior_plain(pack, bank, s_idx, p_idx, emit_pe=False)
        lens = pack.lens[torch.as_tensor(s_idx, device=pack.device)]
        env_i, env_j, _over = envelopes(mocc, pb, lens)
        ok = env_j >= env_i
        first = torch.argmax(ok.int(), dim=1, keepdim=True)
        has = ok.any(dim=1)
        iv = torch.where(has, env_i.gather(1, first)[:, 0], 1).to(torch.int32)
        jv = torch.where(has, env_j.gather(1, first)[:, 0], lens).to(torch.int32)
        keep = (lens > 0).cpu().numpy()
        s_idx, p_idx = s_idx[keep], p_idx[keep]
        keep_t = torch.as_tensor(keep, device=pack.device)
        iv, jv = iv[keep_t].cpu(), jv[keep_t].cpu()
        score = score[keep_t].contiguous()
        out, coords = pair_align(pack, bank, s_idx, p_idx, iv, jv, score)
        want_out, want_coords = pair_align_plain(pack, bank, s_idx, p_idx, iv, jv, score)
        _close(out, want_out, 1e-3)
        torch.testing.assert_close(coords, want_coords, atol=0, rtol=0)
    assert _launches("pair_align") == len(domain_rows)


def _edge_envelopes(pack, s_idx, seed):
    """Envelopes [1, 1], [L, L], [1, L], iv = jv and others in turn, one a
    row (every row non-empty)."""
    rng = numpy.random.default_rng(seed)
    L = pack.lens_host[s_idx].astype(numpy.int64)
    iv = 1 + (rng.random(len(L)) * L).astype(numpy.int64)
    jv = iv + (rng.random(len(L)) * (L - iv + 1)).astype(numpy.int64)
    kind = numpy.arange(len(L)) % 5
    iv[kind == 0], jv[kind == 0] = 1, 1
    iv[kind == 1], jv[kind == 1] = L[kind == 1], L[kind == 1]
    iv[kind == 2], jv[kind == 2] = 1, L[kind == 2]
    jv[kind == 3] = iv[kind == 3]
    return iv, jv


def _pair_posterior_rows(pack, bank, s_idx, p_idx):
    """The rows that ``PairDomains`` gives kernel J: those whose block form
    fits its shared memory (the 4,096-residue sequence against the
    4,096-node class does not)."""
    keep = numpy.array([pair_posterior_smem(int(bank.class_of[p]), int(pack.lens_host[s]))
                        <= _SMEM_CAP for s, p in zip(s_idx, p_idx)], dtype=bool)
    return s_idx[keep], p_idx[keep]


def _check_pair_posterior(pack, bank, s_idx, p_idx):
    """Kernel J against its plain version on rows ``(s_idx, p_idx)``:
    score within 1e-3 nats, mocc, pB and pE within 1e-4 and zero past each
    row's length, an empty sequence scoring -1e30; returns the largest
    differences (score, posteriors)."""
    got = pair_posterior(pack, bank, s_idx, p_idx)
    torch.cuda.synchronize()
    want = pair_posterior_plain(pack, bank, s_idx, p_idx)
    _close(got[0], want[0], 1e-3)
    post, want_post = torch.stack(got[1:]), torch.stack(want[1:])
    _close(post, want_post, 1e-4)
    assert (post[:, _past_length(pack, s_idx, post.shape[2])] == 0).all()
    assert (got[0][torch.as_tensor(pack.lens_host[s_idx] == 0, device=pack.device)]
            == NEG).all()
    return float((got[0] - want[0]).abs().max()), float((post - want_post).abs().max())


def test_pair_posterior_kernel_edges(domain_edge_rows):
    """Kernel J against its plain version on the node bank's rows (models
    at 32 k - 1, 32 k and 32 k + 1 nodes, more rows of a profile than a
    block, interleaved profiles, an empty sequence, 4,096 residues against
    the 128-node class), the rows ``PairDomains`` gives it: one launch a
    class.  The largest differences are printed."""
    pack, bank, groups = domain_edge_rows
    errs = [0.0, 0.0]
    for s_idx, p_idx in groups:
        s_idx, p_idx = _pair_posterior_rows(pack, bank, s_idx, p_idx)
        TIMER.reset()
        errs = [max(a, b) for a, b in zip(errs, _check_pair_posterior(pack, bank, s_idx, p_idx))]
        assert _launches("pair_posterior") == 1
    print(f"kernel J on the node bank ({len(groups)} classes): largest difference "
          f"{errs[0]!r} nats (score), {errs[1]!r} (mocc, pB, pE)")


def _check_pair_align(pack, bank, s_idx, p_idx, seed):
    """Kernel K against its plain version on the non-empty rows ``(s_idx,
    p_idx)`` with :func:`_edge_envelopes`: the envelope score and null2
    log-ratios within 1e-3 nats, the coordinates equal; returns the
    largest differences (envelope score, null2)."""
    iv, jv = _edge_envelopes(pack, s_idx, seed)
    _traj, score = posterior_fwd_plain(pack, bank, s_idx, p_idx)
    out, coords = pair_align(pack, bank, s_idx, p_idx, iv, jv, score)
    torch.cuda.synchronize()
    want_out, want_coords = pair_align_plain(pack, bank, s_idx, p_idx, iv, jv, score)
    _close(out, want_out, 1e-3)
    assert torch.equal(coords, want_coords)
    return (float((out[:, 0] - want_out[:, 0]).abs().max()),
            float((out[:, 1:] - want_out[:, 1:]).abs().max()))


def test_pair_align_kernel_edges(domain_edge_rows):
    """Kernel K against its plain version on the non-empty rows of
    ``test_posterior_fwd_kernel_edges`` (the 4,096-residue sequence among
    them), on plain kernel D's scores: one launch a class; envelopes [1, 1],
    [L, L], [1, L], iv = jv and others in turn.  The largest differences
    are printed."""
    pack, bank, groups = domain_edge_rows
    errs = [0.0, 0.0]
    for s_idx, p_idx in groups:
        keep = pack.lens_host[s_idx] > 0
        TIMER.reset()
        errs = [max(a, b) for a, b in zip(errs, _check_pair_align(
            pack, bank, s_idx[keep], p_idx[keep], 13))]
        assert _launches("pair_align") == 1
    print(f"kernel K on the node bank ({len(groups)} classes): largest difference "
          f"{errs[0]!r} nats (envelope score), {errs[1]!r} (null2 log-ratios)")


@pytest.mark.parametrize("kernel", ["pair_posterior", "pair_align"])
def test_pair_kernels_mixed_shuffled(domain_edge_rows, kernel):
    """Kernels J and K over the node bank's rows of every class in one
    call, in a shuffled order, so that each class's launch takes its rows
    in block order and writes each at its slot in the caller's order: one
    launch a class up to 1,024 nodes and one for the classes above, the
    outputs equal to the plain version's.  (Without the 4,096-residue
    sequence: kernel J's block form sizes its shared memory by the call's
    longest row.)"""
    pack, bank, groups = domain_edge_rows
    s_idx = numpy.concatenate([g[0] for g in groups])
    p_idx = numpy.concatenate([g[1] for g in groups])
    keep = pack.lens_host[s_idx] < 4096
    if kernel == "pair_align":
        keep &= pack.lens_host[s_idx] > 0
    order = numpy.random.default_rng(21).permutation(int(keep.sum()))
    s_idx, p_idx = s_idx[keep][order], p_idx[keep][order]
    assert len(set(bank.class_of[p_idx[:8]].tolist())) > 1
    TIMER.reset()
    if kernel == "pair_posterior":
        _check_pair_posterior(pack, bank, s_idx, p_idx)
    else:
        _check_pair_align(pack, bank, s_idx, p_idx, 17)
    assert _launches(kernel) == 5


def test_pair_domains_cuda_matches_torch_and_stream(workload):
    profiles, seqs, pack, bank = workload
    pairs = [(s, p) for s in range(len(seqs)) for p in range(len(profiles))]
    got = PairDomains(bank, profiles, backend="cuda").define(seqs, pairs, pack=pack)
    want = PairDomains(bank, profiles, backend="torch").define(seqs, pairs, pack=pack)
    assert sum(len(v) for v in want.values()) >= len(seqs) // 2
    _same_domains(got, want)
    _same_domains(got, StreamDomains(bank, profiles, backend="cuda").define(
        seqs, pairs, pack=pack))
