"""The CUDA kernels against their plain versions — needs an NVIDIA card.

Tolerances: max-plus kernels (A, B, H's Viterbi) 1e-4 nats; sum-product
kernels (C-G, H's Forward) and their log scales 1e-3 nats, trajectories
and posteriors 1e-4 absolute (float32 sums in another order); bfloat16
planes within one bfloat16 step; envelopes and alignment coordinates
equal.  Only the port is imported here.

Marked ``cuda``; skipped (with the reason) where no card is present.
On a machine with one: ``python -m pytest tests/test_torch_cuda.py -q``.
"""

import numpy
import pytest
import torch

from gecco_tpu_torch import _build
from gecco_tpu_torch.hmm.bank import TorchBank
from gecco_tpu_torch.hmm.kernels import (
    SeqPack, dense_scores, dense_scores_plain, ssv_filter, ssv_filter_plain, viterbi_pairs,
    viterbi_pairs_plain)
from gecco_tpu_torch.hmm.pipeline import SearchPipeline
from gecco_tpu_torch.hmm.synthetic import plant_domain, synthetic_profiles, synthetic_proteins
from gecco_tpu_torch.hmm.stream import (
    StreamDomains, align_bwd, align_bwd_plain, align_fwd, align_fwd_plain, envelopes,
    forward_pairs, forward_pairs_plain, posterior_bwd, posterior_bwd_plain, posterior_fwd,
    posterior_fwd_plain)

pytestmark = pytest.mark.cuda


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
    before = _build.launches["ssv_filter"]
    got = ssv_filter(pack, bank)
    torch.cuda.synchronize()
    assert _build.launches["ssv_filter"] > before
    torch.testing.assert_close(got, ssv_filter_plain(pack, bank), atol=1e-4, rtol=0)


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
    before = _build.launches["dense_scores"]
    got = dense_scores(pack, bank, viterbi=viterbi)
    torch.cuda.synchronize()
    assert _build.launches["dense_scores"] == before + len(bank.classes)
    want = dense_scores_plain(pack, bank, viterbi=viterbi)
    assert torch.isneginf(want[-1]).all()       # the empty sequence
    torch.testing.assert_close(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("max_filter", [False, True])
def test_search_cuda_matches_torch(workload, device, max_filter):
    profiles, seqs, _pack, _bank = workload
    a = SearchPipeline(profiles, device=device, backend="cuda", max_filter=max_filter)
    b = SearchPipeline(profiles, device=device, backend="torch", max_filter=max_filter)
    hits_a, hits_b = a.search(seqs), b.search(seqs)
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
    before = (_build.launches["posterior_fwd"], _build.launches["posterior_bwd"])
    for s_idx, p_idx in domain_rows:
        traj, score = posterior_fwd(pack, bank, s_idx, p_idx)
        want_traj, want_score = posterior_fwd_plain(pack, bank, s_idx, p_idx)
        _close(traj[:4], want_traj[:4], 1e-4)
        _close(traj[4], want_traj[4], 1e-3)
        _close(score, want_score, 1e-3)
        post = posterior_bwd(pack, bank, s_idx, p_idx, want_traj, want_score)
        _close(post, posterior_bwd_plain(pack, bank, s_idx, p_idx, want_traj, want_score), 1e-4)
    assert (_build.launches["posterior_fwd"], _build.launches["posterior_bwd"]) == (
        before[0] + len(domain_rows), before[1] + len(domain_rows))


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


def test_stream_domains_cuda_matches_torch(workload):
    profiles, seqs, pack, bank = workload
    pairs = [(s, p) for s in range(len(seqs)) for p in range(len(profiles))]
    got = StreamDomains(bank, profiles, backend="cuda").define(seqs, pairs, pack=pack)
    want = StreamDomains(bank, profiles, backend="torch").define(seqs, pairs, pack=pack)
    assert sorted(got) == sorted(want)
    assert sum(len(v) for v in want.values()) >= len(seqs) // 2
    for key, doms in want.items():
        assert [(d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from, d.hmm_to)
                for d in got[key]] == [
            (d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from, d.hmm_to) for d in doms]
        for a, b in zip(got[key], doms):
            assert a.envsc == pytest.approx(b.envsc, abs=1e-3)
            assert a.bitscore == pytest.approx(b.bitscore, abs=1e-2)
