"""The port's search slice and calibration against the JAX package.

The multidomain fixture is built like ``tests/test_hmm.py``'s
(``multidomain_workload``): six calibrated synthetic profiles, eight
proteins carrying two or three strong planted copies each.  The port
runs on the CPU (its kernel wrappers take the plain versions there);
the JAX package runs its XLA engines.  Gates: identical survivor funnel,
hits and domain coordinates; sequence scores within 5e-3 bits, domain
bit scores within 5e-2 (``tools/tpu_check.py``'s gates).
"""

import numpy
import pytest
import torch

from gecco_tpu.hmm.calibrate import calibrate as jax_calibrate
from gecco_tpu.hmm.pipeline import SearchPipeline as JaxSearchPipeline
from gecco_tpu.hmm.synthetic import plant_domain, synthetic_profiles, synthetic_proteins

from gecco_tpu_torch.hmm.calibrate import calibrate
from gecco_tpu_torch.hmm.pipeline import SearchPipeline
from gecco_tpu_torch.hmm.profile import profiles_from_arrays
from gecco_tpu_torch.profiling import TIMER

torch.set_num_threads(1)


def _port(profiles):
    """The port's copies of JAX profiles, from their plain fields."""
    return profiles_from_arrays([vars(gm.hmm) for gm in profiles])


def stage_spans():
    """The names of the timer's search stage spans, in the order they opened."""
    return [span["name"] for span in TIMER.export()["spans"]
            if span["name"] in ("filter", "viterbi", "forward", "domains")]


def multidomain_inputs():
    """JAX profiles (calibrated) and proteins of the multidomain workload."""
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


@pytest.fixture(scope="module")
def multidomain():
    profiles, seqs = multidomain_inputs()
    reference = JaxSearchPipeline(profiles, Z=6, domZ=6, backend="xla")
    hits = reference.search(seqs)
    return _port(profiles), seqs, hits, reference.stage_counts


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_slice_matches_jax_pipeline(multidomain, backend):
    profiles, seqs, expected, expected_counts = multidomain
    pipeline = SearchPipeline(profiles, device="cpu", Z=6, domZ=6, backend=backend)
    TIMER.reset()
    hits = pipeline.search(seqs)
    assert pipeline.stage_counts == expected_counts
    assert stage_spans() == ["filter", "viterbi", "forward", "domains"]
    assert pipeline.stage_cells["filter"] > pipeline.stage_cells["viterbi"] > 0
    assert [(h.sequence_index, h.profile.name) for h in hits] == [
        (h.sequence_index, h.profile.name) for h in expected]
    assert sum(len(h.domains) >= 2 for h in hits) >= 3
    for a, b in zip(hits, expected):
        assert a.score == pytest.approx(b.score, abs=5e-3)
        assert a.evalue == pytest.approx(b.evalue, rel=1e-2)
        assert len(a.domains) == len(b.domains)
        for da, db in zip(a.domains, b.domains):
            assert (da.ienv, da.jenv) == (db.ienv, db.jenv)
            assert (da.target_from, da.target_to) == (db.target_from, db.target_to)
            assert (da.hmm_from, da.hmm_to) == (db.hmm_from, db.hmm_to)
            assert da.bitscore == pytest.approx(db.bitscore, abs=5e-2)


def test_slice_empty_inputs_reset_accounting(multidomain):
    profiles, seqs, _hits, _counts = multidomain
    pipeline = SearchPipeline(profiles, device="cpu", Z=6, domZ=6)
    pipeline.search(seqs[:2])
    assert pipeline.stage_counts
    assert pipeline.search([]) == []
    assert pipeline.stage_counts == {} and pipeline.stage_cells == {}
    with_empty = pipeline.search([seqs[0], numpy.zeros(0, dtype=numpy.int32)])
    assert all(h.sequence_index == 0 for h in with_empty)


def test_pipeline_rejects_unknown_options():
    with pytest.raises(ValueError):
        SearchPipeline([], device="cpu", backend="pallas")
    with pytest.raises(ValueError):
        SearchPipeline([], device="cpu", bit_cutoffs="weird")
    with pytest.raises(ValueError):
        SearchPipeline([], device="meta")


def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        SearchPipeline([], device="cuda")


@pytest.mark.parametrize("jax_backend", [None, "pallas"])
def test_calibrate_matches_jax_package(jax_backend):
    """Both JAX routes: the XLA engines, and the Pallas kernels
    (``_pallas_ssv`` through ``SSVKernel.__call__``, ``_pallas_fwd``) in
    interpret mode."""
    profiles = synthetic_profiles(4, min_length=30, max_length=150, seed=2)
    mine = _port(profiles)
    jax_calibrate(profiles, n=64, L=96, seed=1, backend=jax_backend)
    calibrate(mine, device="cpu", n=64, L=96, seed=1)
    for a, b in zip(mine, profiles):
        for key in ("MSV", "VITERBI", "FORWARD"):
            assert a.hmm.stats[key][0] == pytest.approx(b.hmm.stats[key][0], abs=1e-3), key
            assert a.hmm.stats[key][1] == b.hmm.stats[key][1]
