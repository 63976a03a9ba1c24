"""The port's scale-out layer against the JAX package's (``tests/test_parallel.py``).

Mirrors of the fixture-free tests of ``tests/test_parallel.py``; the
sharded search on the synthetic multidomain workload (``minipfam`` is
not in the tree) over three CPU shards; ``sharded_forward_scores`` on a
4 x 2 CPU mesh; ``crf_train_step`` against JAX's; and a real
two-process ``gloo`` group, which the JAX package never had.
"""

import os
import subprocess
import sys
import textwrap
import threading

import numpy
import pytest
import torch

from gecco_tpu_torch import _build
from gecco_tpu_torch.hmm.bank import ProfileBank, TorchBank
from gecco_tpu_torch.hmm.kernels import SeqPack, dense_scores_plain
from gecco_tpu_torch.hmm.pipeline import SearchPipeline
from gecco_tpu_torch.hmm.synthetic import synthetic_profiles, synthetic_proteins
from gecco_tpu_torch.model import Cluster, Gene, Protein, Strand
from gecco_tpu_torch.parallel import (
    crf_train_step, make_mesh, merge_clusters, pipelined_map, shard_sequences,
    sharded_forward_scores,
)
from gecco_tpu_torch.profiling import TIMER
from gecco_tpu_torch.seq import Seq, SeqRecord

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pm_init(base):
    global _PM_BASE
    _PM_BASE = base


def _pm_host(item):
    return item + _PM_BASE


def test_pipelined_map_threads_and_processes():
    expected = [11, 12, 13]
    got = list(pipelined_map(_pm_host, lambda v: v * 2, [1, 2, 3],
                             initializer=_pm_init, initargs=(10,)))
    assert got == [2 * v for v in expected]
    got = list(pipelined_map(_pm_host, lambda v: v * 2, [1, 2, 3], processes=True,
                             initializer=_pm_init, initargs=(10,)))
    assert got == [2 * v for v in expected]
    assert list(pipelined_map(_pm_host, lambda v: v, [])) == []


def test_make_mesh_shapes():
    mesh = make_mesh(8, model_axis=2, device="cpu")
    assert mesh.devices.shape == (4, 2)
    assert mesh.axis_names == ("data", "model")
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert make_mesh(8, model_axis=1, device="cpu").devices.shape == (8, 1)
    assert make_mesh(6, model_axis=4, device="cpu").devices.shape == (6, 1)
    assert make_mesh(device="cpu").devices.shape == (1, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh(2)


def test_shard_sequences_balanced():
    sequences = [numpy.zeros(n) for n in (500, 300, 300, 100, 100, 100)]
    shards = shard_sequences(sequences, 2)
    loads = [sum(len(sequences[i]) for i in shard) for shard in shards]
    assert abs(loads[0] - loads[1]) <= 100
    assert sorted(i for s in shards for i in s) == list(range(6))


def _cluster(seq_id, cid, start, end):
    source = SeqRecord(id=seq_id, seq=Seq(""))
    gene = Gene(source, start, end, Strand.Coding, Protein(f"{seq_id}_{start}", Seq("M")))
    return Cluster(cid, [gene])


def test_merge_clusters_shard_invariant():
    shard_a = [_cluster("s1", "s1_cluster_1", 100, 200)]
    shard_b = [_cluster("s1", "s1_cluster_1", 500, 600), _cluster("s2", "s2_cluster_1", 10, 20)]
    ids_1 = [(c.id, c.start) for c in merge_clusters([shard_a, shard_b])]
    ids_2 = [(c.id, c.start) for c in merge_clusters([shard_b, shard_a])]
    assert ids_1 == ids_2
    assert ids_1 == [("s1_cluster_1", 100), ("s1_cluster_2", 500), ("s2_cluster_1", 10)]


def test_initialize_single_process():
    from gecco_tpu_torch.parallel.hosts import initialize

    assert initialize() == (0, 1)


def test_launch_counts_survive_threads():
    """Threads counting one kernel's launches side by side lose none; the
    build module's ``launches`` reads them (as the benchmark's child
    process records them) and a reset clears them."""
    TIMER.reset()

    def count():
        for _ in range(5000):
            TIMER.count("launch.ssv_filter")

    threads = [threading.Thread(target=count) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert TIMER.counters["launch.ssv_filter"] == 40000
    assert _build.launches == {"ssv_filter": 40000}
    TIMER.reset()
    assert "launch.ssv_filter" not in TIMER.counters and _build.launches == {}


@pytest.fixture(scope="module")
def multidomain():
    from test_torch_pipeline import _port, multidomain_inputs

    profiles, seqs = multidomain_inputs()
    return _port(profiles), seqs


def _key(h):
    return (h.sequence_index, h.profile.name)


def _stage_spans():
    """The devices of the timer's search stage spans, by name."""
    out = {}
    for span in TIMER.export()["spans"]:
        if span["name"] in ("filter", "viterbi", "forward", "domains"):
            out.setdefault(span["name"], []).append(span["device"])
    return out


@pytest.mark.parametrize("use_accelerator", [True, False], ids=["device", "host"])
def test_pipeline_multi_device_matches_single(multidomain, use_accelerator):
    """Three CPU shards give the one-device search's hits, scores and
    domains; counts and cells sum over the shards that ran, each shard
    times its stages in spans of its own, ``stage_devices`` counts the
    shards."""
    profiles, seqs = multidomain
    if not use_accelerator:
        seqs = seqs[:5]
    single = SearchPipeline(profiles, device="cpu", Z=6, domZ=6,
                            use_accelerator=use_accelerator)
    TIMER.reset()
    expected = single.search(seqs)
    single_spans = _stage_spans()
    multi = SearchPipeline(profiles, device="cpu", Z=6, domZ=6, devices=["cpu"] * 3,
                           use_accelerator=use_accelerator)
    TIMER.reset()
    hits = multi.search(seqs)
    multi_spans = _stage_spans()
    assert expected and [_key(h) for h in hits] == [_key(h) for h in expected]
    for a, b in zip(hits, expected):
        assert a.score == pytest.approx(b.score, abs=1e-4)
        assert [(d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from, d.hmm_to)
                for d in a.domains] == [
            (d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from, d.hmm_to)
            for d in b.domains]
        for da, db in zip(a.domains, b.domains):
            assert da.bitscore == pytest.approx(db.bitscore, abs=1e-2)
    assert multi.stage_devices == 3 and single.stage_devices == 1
    assert multi.stage_counts == single.stage_counts
    assert multi.stage_counts["reported"] == len(hits)
    for key, cells in single.stage_cells.items():
        assert multi.stage_cells[key] == pytest.approx(cells)
    shards = shard_sequences(seqs, 3)
    # each stage span once a shard, naming the shard's device
    assert single_spans and all(devices == [None] for devices in single_spans.values())
    assert multi_spans == {name: ["cpu"] * 3 for name in single_spans}
    assert multi.host_pairs == sum(sub.host_pairs for sub in multi._subs)
    assert multi.candidate_pairs == sorted(single.candidate_pairs)
    got, want = multi.rescored_pairs, single.rescored_pairs
    order = numpy.lexsort((want[1], want[0]))
    assert numpy.array_equal(got[0], want[0][order]) and numpy.array_equal(got[1], want[1][order])
    # every shard searched its own sequences against the whole batch's Z
    assert all(sub.Z == 6 for sub in multi._subs) and all(shards)


def test_pipeline_device_list_pins_one_device(multidomain):
    """A one-device list, or a batch of one sequence, pins the search."""
    profiles, seqs = multidomain
    expected = SearchPipeline(profiles, device="cpu", Z=6, domZ=6).search(seqs)
    pinned = SearchPipeline(profiles, device="cpu", Z=6, domZ=6, devices=["cpu"])
    hits = pinned.search(seqs)
    assert [(_key(h), h.score) for h in hits] == [(_key(h), h.score) for h in expected]
    assert pinned.stage_devices == 1 and len(pinned._subs) == 1
    one = SearchPipeline(profiles, device="cpu", Z=6, domZ=6, devices=["cpu"] * 2)
    solo = SearchPipeline(profiles, device="cpu", Z=6, domZ=6)
    assert [_key(h) for h in one.search(seqs[:1])] == [_key(h) for h in solo.search(seqs[:1])]
    assert one.stage_devices == 1
    # "all" on the CPU is one device: nothing to shard or pin
    every = SearchPipeline(profiles, device="cpu", Z=6, domZ=6, devices="all")
    assert every._resolve_devices() is None
    assert [_key(h) for h in every.search(seqs)] == [_key(h) for h in expected]


@pytest.mark.parametrize("viterbi", [False, True], ids=["forward", "viterbi"])
def test_sharded_forward_scores_matches_one_call(viterbi):
    profiles = synthetic_profiles(8, min_length=24, max_length=48, seed=0)
    seqs = synthetic_proteins(8, mean_length=60, seed=1)
    bank = ProfileBank.build(profiles)
    mesh = make_mesh(8, model_axis=2, device="cpu")
    sharded = sharded_forward_scores(bank, seqs, mesh, viterbi=viterbi)
    plain = dense_scores_plain(SeqPack(seqs, "cpu"), TorchBank.from_numpy(bank, "cpu"),
                               viterbi=viterbi).numpy()
    assert sharded.shape == plain.shape == (8, 8)
    assert numpy.abs(sharded - plain).max() < 1e-4


def _windows(A=12, seed=0):
    rng = numpy.random.default_rng(seed)
    idx = rng.integers(0, A + 1, size=(16, 10, 3)).astype(numpy.int32)
    y = rng.integers(0, 2, size=(16, 10)).astype(numpy.int32)
    return idx, y


def test_crf_train_step_matches_jax():
    """Three steps on a 4-slot data mesh against the JAX package's step
    on its 8-device mesh, from the same zero start."""
    import jax.numpy as jnp

    from gecco_tpu.parallel import crf_train_step as jax_crf_train_step
    from gecco_tpu.parallel import make_mesh as jax_make_mesh

    idx, y = _windows()
    jax_step, jax_params = jax_crf_train_step(jax_make_mesh(8, model_axis=1))(A=12)
    step, params = crf_train_step(make_mesh(4, device="cpu"))(A=12)
    losses = []
    for _ in range(3):
        jax_params, jax_loss = jax_step(jax_params, jnp.asarray(idx), jnp.asarray(y), 0.01)
        params, loss = step(params, idx, y, 0.01)
        assert float(loss) == pytest.approx(float(jax_loss), rel=1e-5)
        for mine, theirs in zip(params, jax_params):
            assert numpy.abs(mine.numpy() - numpy.asarray(theirs)).max() < 1e-5
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_crf_train_step_slots_agree():
    """A 1-slot and a 3-slot data mesh take the same step."""
    idx, y = _windows(seed=3)
    one_step, one = crf_train_step(make_mesh(1, device="cpu"))(A=12)
    three_step, three = crf_train_step(make_mesh(3, device="cpu"))(A=12)
    for _ in range(2):
        one, loss_one = one_step(one, idx, y, 0.05)
        three, loss_three = three_step(three, idx, y, 0.05)
        assert float(loss_three) == pytest.approx(float(loss_one), rel=1e-5)
        for a, b in zip(one, three):
            assert numpy.abs(a.numpy() - b.numpy()).max() < 1e-5


_WORKER = textwrap.dedent("""
    import sys
    import numpy
    import torch
    sys.path.insert(0, sys.argv[1])
    from gecco_tpu_torch.parallel import crf_train_step, make_mesh
    from gecco_tpu_torch.parallel.hosts import initialize

    store, rank, data, out = sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    got = initialize(f"file://{store}", 2, rank, timeout_s=60)
    assert got == (rank, 2), got
    windows = numpy.load(data)
    half = slice(0, 8) if rank == 0 else slice(8, 16)
    step, params = crf_train_step(make_mesh(1, device="cpu"))(A=12)
    for _ in range(3):
        params, loss = step(params, windows["idx"][half], windows["y"][half], 0.01)
    numpy.savez(out, state=params[0].numpy(), trans=params[1].numpy(), loss=float(loss))
    torch.distributed.destroy_process_group()
""")


def test_crf_train_step_two_processes(tmp_path):
    """Two ``gloo`` processes, each stepping on its half of the windows,
    end with the parameters of one process stepping on all of them."""
    idx, y = _windows(seed=5)
    data = str(tmp_path / "windows.npz")
    numpy.savez(data, idx=idx, y=y)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    store = str(tmp_path / "store")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("MASTER_", "RANK",
                                                                     "WORLD_SIZE"))}
    procs = [subprocess.Popen([sys.executable, str(script), REPO, store, str(rank), data,
                               str(tmp_path / f"rank{rank}.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for rank in range(2)]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=60)[0].decode())
    finally:
        alive = [proc for proc in procs if proc.poll() is None]
        for proc in alive:
            proc.kill()
            proc.communicate()
    assert not alive, "a worker hung and was killed"
    assert all(proc.returncode == 0 for proc in procs), outputs
    step, params = crf_train_step(make_mesh(1, device="cpu"))(A=12)
    for _ in range(3):
        params, loss = step(params, idx, y, 0.01)
    for rank in range(2):
        got = numpy.load(tmp_path / f"rank{rank}.npz")
        assert numpy.abs(got["state"] - params[0].numpy()).max() < 1e-6
        assert numpy.abs(got["trans"] - params[1].numpy()).max() < 1e-6
        assert float(got["loss"]) == pytest.approx(float(loss), rel=1e-6)


def test_graft_entry_on_cpu():
    """``__graft_entry_torch__``: kernel H's Forward on the tiny workload,
    and the dry run of every distributed path on a 4-slot CPU mesh."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "graft_entry_torch", os.path.join(REPO, "__graft_entry_torch__.py"))
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    fn, args = graft.entry(device="cpu")
    scores = fn(*args)
    assert tuple(scores.shape) == (8, 8) and bool(torch.isfinite(scores).all())
    graft.dryrun_multichip(4, device="cpu")
