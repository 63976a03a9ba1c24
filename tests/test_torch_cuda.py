"""The CUDA kernels against their plain versions — needs an NVIDIA card.

Marked ``cuda``; skipped (with the reason) where no card is present.
On a machine with one: ``python -m pytest tests/test_torch_cuda.py -q``.
"""

import numpy
import pytest
import torch

from gecco_tpu.hmm import batch
from gecco_tpu.hmm.synthetic import plant_domain, synthetic_profiles, synthetic_proteins

from gecco_tpu_torch import _build
from gecco_tpu_torch.hmm.bank import TorchBank
from gecco_tpu_torch.hmm.kernels import (
    SeqPack, ssv_filter, ssv_filter_plain, viterbi_pairs, viterbi_pairs_plain)
from gecco_tpu_torch.hmm.pipeline import SearchPipeline
from gecco_tpu_torch.hmm.stream import forward_pairs, forward_pairs_plain

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def workload(device):
    profiles = synthetic_profiles(12, min_length=20, max_length=700, seed=5)
    profiles += synthetic_profiles(1, min_length=2100, max_length=2100, seed=6)
    rng = numpy.random.default_rng(1)
    seqs = [x[:600] for x in synthetic_proteins(24, mean_length=250, seed=7)]
    for i in range(0, len(seqs), 2):
        gm = profiles[i % len(profiles)]
        seqs[i] = plant_domain(seqs[i], gm, rng, max_len=min(gm.M, 200), divergence=0.2)
    seqs.append(numpy.zeros(0, dtype=numpy.int32))
    host = batch.ProfileBank.build(profiles)
    return profiles, seqs, SeqPack(seqs, device), TorchBank.from_numpy(host, device)


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


def test_search_cuda_matches_torch(workload, device):
    profiles, seqs, _pack, _bank = workload
    a = SearchPipeline(profiles, device=device, backend="cuda")
    b = SearchPipeline(profiles, device=device, backend="torch")
    hits_a, hits_b = a.search(seqs), b.search(seqs)
    assert a.stage_counts == b.stage_counts
    assert [(h.sequence_index, h.profile.name) for h in hits_a] == [
        (h.sequence_index, h.profile.name) for h in hits_b]
