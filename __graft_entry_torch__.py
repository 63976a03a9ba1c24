"""Entry points of the PyTorch port: a one-card kernel check and a mesh dry run.

The twin of ``__graft_entry__.py``, on ``gecco_tpu_torch`` alone.

``entry()`` returns the flagship step — the dense all-pairs Forward of
kernel H (``hmm.kernels.dense_scores``) over a tiny synthetic bank and
protein batch on the card — with its example arguments.

``dryrun_multichip(n)`` builds an ``n``-slot ``(data, model)`` mesh of
the local cards (slots beyond the cards name them again in turn), and
runs one step of each distributed path on tiny shapes: the bank split
over ``model`` and the proteins over ``data`` (``sharded_forward_scores``
in both semirings), the data-parallel CRF training step
(``crf_train_step``), and the search sharded over the slots
(``SearchPipeline(devices=...)``) against the one-device search.
"""

import numpy


def _tiny_workload(n_profiles=8, n_seqs=8, seq_len=32):
    """A host ``ProfileBank`` of synthetic profiles and encoded proteins."""
    from gecco_tpu_torch.hmm.bank import ProfileBank
    from gecco_tpu_torch.hmm.synthetic import synthetic_profiles, synthetic_proteins

    profiles = synthetic_profiles(n_profiles, min_length=24, max_length=48, seed=0)
    seqs = synthetic_proteins(n_seqs, mean_length=seq_len, seed=1)
    return profiles, ProfileBank.build(profiles), seqs


def entry(device="cuda"):
    """Return ``(fn, example_args)``: kernel H's Forward and its inputs."""
    from gecco_tpu_torch.hmm.bank import TorchBank
    from gecco_tpu_torch.hmm.kernels import SeqPack, dense_scores

    _profiles, bank, seqs = _tiny_workload()
    return dense_scores, (SeqPack(seqs, device), TorchBank.from_numpy(bank, device))


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the sharded scoring, training and search paths on ``n_devices`` slots."""
    import torch

    from gecco_tpu_torch.hmm.pipeline import SearchPipeline
    from gecco_tpu_torch.parallel import crf_train_step, make_mesh, sharded_forward_scores

    mesh = make_mesh(n_devices, model_axis=2 if n_devices % 2 == 0 and n_devices > 1 else 1,
                     device=device)
    data_size, model_size = mesh.devices.shape

    # ---- sharded scoring: bank over 'model', proteins over 'data'
    profiles, bank, seqs = _tiny_workload(n_profiles=max(4, 2 * model_size),
                                          n_seqs=max(4, 2 * data_size))
    scores = sharded_forward_scores(bank, seqs, mesh)
    assert scores.shape == (len(seqs), bank.P)
    assert numpy.isfinite(scores).all()
    vit = sharded_forward_scores(bank, seqs, mesh, viterbi=True)
    assert vit.shape == scores.shape and numpy.isfinite(vit).all()
    assert (vit <= scores + 1e-4).all()  # max path <= sum over paths

    # ---- data-parallel CRF training step (replicated parameters)
    A, W, D = 16, 10, 3
    rng = numpy.random.default_rng(0)
    idx = rng.integers(0, A + 1, size=(4 * data_size, W, D)).astype(numpy.int32)
    y = rng.integers(0, 2, size=(4 * data_size, W)).astype(numpy.int32)
    step_fn, params = crf_train_step(mesh)(A)
    params, loss = step_fn(params, idx, y, 0.1)
    assert numpy.isfinite(float(loss))

    # ---- the search sharded over the slots, equal to one device's
    slots = list(mesh.devices.flat)
    single = SearchPipeline(profiles, device=slots[0], Z=10, domZ=10).search(seqs)
    multi = SearchPipeline(profiles, device=slots[0], Z=10, domZ=10, devices=slots).search(seqs)

    def key(h):
        return (h.sequence_index, h.profile.name, round(h.score, 3),
                tuple((d.ienv, d.jenv, d.target_from, d.target_to) for d in h.domains))

    assert [key(h) for h in single] == [key(h) for h in multi]
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", tuple(fn(*args).shape))
    import torch

    dryrun_multichip(torch.cuda.device_count())
    print("dryrun_multichip ok")
