"""Scale-out of the port: device meshes, sharded scoring, merged results.

Port of ``gecco_tpu.parallel``.  The JAX package runs one program over a
``Mesh`` of chips and lets XLA place the shards and insert the
collectives; here one process holds a ``(data, model)`` grid of
``torch.device`` slots and places each block itself:

* **data parallelism** — sequence (or window) batches split over the
  ``data`` axis: :func:`shard_sequences`, and the sharded search of
  ``SearchPipeline(devices=...)``;
* **model parallelism** — the profile bank's profile axis split over the
  ``model`` axis (:func:`sharded_forward_scores`);
* **deterministic merge** — per-shard cluster candidates renumbered in
  coordinate order, so that output IDs are shard-invariant
  (:func:`merge_clusters`);
* **data-parallel CRF training** — windows split over ``data``, each
  slot's gradient summed on the first one, and over the processes of a
  ``torch.distributed`` group when one is up (:func:`crf_train_step`).

A mesh may name one card in several slots (one card has no other to
share with): that runs the splitting, placement and merging, but no two
cards at once.  :func:`pipelined_map` and :func:`merge_clusters` are
copies of the JAX package's host code.
"""

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy
import torch

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_sequences",
    "sharded_forward_scores",
    "merge_clusters",
    "crf_train_step",
    "pipelined_map",
]


def pipelined_map(host_fn, device_fn, items, processes: bool = False,
                  initializer=None, initargs=()):
    """Two-stage host/device software pipeline over a work list.

    Yields ``device_fn(host_fn(item))`` per item, with the NEXT item's
    ``host_fn`` running in a worker while the device processes the
    current one.  This is how a batch ``run`` keeps the card busy:
    gene calling of genome *k+1* overlaps the annotation search of
    genome *k*, so steady-state throughput is set by
    ``max(host, device)`` instead of their sum.  The reference's analog
    is its per-contig ``ThreadPool`` inside ONE stage
    (``gecco/orf.py:95``); this pipelines ACROSS stages, which only pays
    off with an accelerator to keep fed.

    ``processes=True`` runs ``host_fn`` in a spawned worker PROCESS
    instead of a thread: the device path's own host-side work (batch
    packing, result assembly) holds the GIL for most of a search, so a
    thread-based overlap degrades to the serial sum — a subprocess
    overlaps fully.  ``host_fn``/``items`` must then be picklable;
    ``initializer(*initargs)`` runs once in the worker (build finders,
    banks, …) and must NOT touch the accelerator.
    """
    items = list(items)
    if not items:
        return
    if processes:
        import multiprocessing

        from concurrent.futures import ProcessPoolExecutor

        ctx = multiprocessing.get_context("spawn")
        pool = ProcessPoolExecutor(
            max_workers=1, mp_context=ctx,
            initializer=initializer, initargs=initargs,
        )
    else:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=1)
        if initializer is not None:
            initializer(*initargs)
    with pool:
        future = pool.submit(host_fn, items[0])
        for k in range(len(items)):
            prepared = future.result()
            if k + 1 < len(items):
                future = pool.submit(host_fn, items[k + 1])
            yield device_fn(prepared)


@dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` grid of device slots in one process."""

    #: ``[data, model]`` object array of ``torch.device``
    devices: "numpy.ndarray"
    axis_names: Tuple[str, str] = ("data", "model")


def make_mesh(n_devices: Optional[int] = None, model_axis: int = 1, *,
              device="cuda") -> Mesh:
    """Build a ``(data, model)`` mesh of ``n_devices`` slots.

    For ``device="cuda"`` the slots are the machine's cards (all of them
    by default); slots beyond the cards name them again in turn, so a
    mesh on one card names it in every slot.  For ``device="cpu"`` the
    slots are CPU slots (one by default).  As in the JAX package, the
    ``model`` axis has ``model_axis`` slots when that divides
    ``n_devices``, else one.
    """
    kind = torch.device(device).type
    if kind == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh(device='cuda'): torch.cuda.is_available() is False")
        n = count if n_devices is None else n_devices
        slots = [torch.device("cuda", k % count) for k in range(n)]
    elif kind == "cpu":
        n = 1 if n_devices is None else n_devices
        slots = [torch.device("cpu")] * n
    else:
        raise ValueError(f"unsupported device: {device}")
    if n < 1:
        raise ValueError(f"a mesh needs at least one slot, not {n}")
    if model_axis > 1 and n % model_axis == 0:
        shape = (n // model_axis, model_axis)
    else:
        shape = (n, 1)
    grid = numpy.empty(n, dtype=object)
    grid[:] = slots
    return Mesh(grid.reshape(shape))


def shard_sequences(
    sequences: Sequence["numpy.ndarray"], n_shards: int
) -> List[List[int]]:
    """Round-robin-by-size assignment of sequences to shards (balanced)."""
    order = sorted(range(len(sequences)), key=lambda i: -len(sequences[i]))
    loads = [0] * n_shards
    shards: List[List[int]] = [[] for _ in range(n_shards)]
    for i in order:
        s = loads.index(min(loads))
        shards[s].append(i)
        loads[s] += len(sequences[i])
    return shards


def sharded_forward_scores(bank, sequences: Sequence["numpy.ndarray"], mesh: Mesh,
                           viterbi: bool = False) -> "numpy.ndarray":
    """Forward (or Viterbi) scores (nats) of every (sequence, profile) pair,
    ``[S, P]``, with the profiles of the host ``ProfileBank`` ``bank`` split
    over the mesh's ``model`` axis and the encoded ``sequences`` over its
    ``data`` axis.

    Each block is scored by the dense all-pairs kernel H
    (:func:`~gecco_tpu_torch.hmm.kernels.dense_scores`; its plain version
    in a CPU slot) on its slot's device, one thread a block, and the
    blocks are gathered on the host.  The JAX package's twin runs XLA's
    dense Forward on each block.
    """
    from .._device import on_device
    from ..hmm.bank import TorchBank
    from ..hmm.kernels import SeqPack, dense_scores

    data, model = mesh.devices.shape
    seq_parts = numpy.array_split(numpy.arange(len(sequences)), data)
    prof_parts = numpy.array_split(numpy.arange(bank.P), model)
    out = numpy.zeros((len(sequences), bank.P), dtype=numpy.float32)
    errors: List[BaseException] = []

    def work(d: int, m: int) -> None:
        try:
            s_idx, p_idx = seq_parts[d], prof_parts[m]
            if not len(s_idx) or not len(p_idx):
                return
            device = mesh.devices[d, m]
            with on_device(device):
                block = TorchBank.from_numpy(bank.select(p_idx), device)
                pack = SeqPack([sequences[i] for i in s_idx], device)
                scores = dense_scores(pack, block, viterbi=viterbi).cpu().numpy()
            out[numpy.ix_(s_idx, p_idx)] = scores
        except BaseException as exc:  # raised after the join
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(d, m))
               for d in range(data) for m in range(model)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def merge_clusters(cluster_lists: Sequence[Sequence]) -> List:
    """Merge per-shard cluster candidates deterministically.

    Clusters are reordered by (sequence id, start, end) and renumbered
    ``{seq}_cluster_{i}`` per sequence in coordinate order, so the result
    does not depend on how contigs were sharded.
    """
    from ..model import Cluster

    merged = [c for clusters in cluster_lists for c in clusters]
    merged.sort(key=lambda c: (c.source.id, c.start, c.end))
    counters: Dict[str, int] = {}
    renumbered = []
    for cluster in merged:
        seq_id = cluster.source.id
        counters[seq_id] = counters.get(seq_id, 0) + 1
        renumbered.append(Cluster(
            f"{seq_id}_cluster_{counters[seq_id]}",
            cluster.genes, cluster.type, cluster.type_probabilities,
        ))
    return renumbered


def crf_train_step(mesh: Mesh):
    """Build a data-parallel CRF training step over ``mesh``.

    Returns ``make(A) -> (step_fn, init)``, with ``step_fn(params, idx, y,
    lr) -> (params, loss)`` a plain SGD step of the summed negative
    log-likelihood :func:`gecco_tpu_torch.crf.train.nll` over windows
    ``idx`` (``[N, W, D]`` feature rows, ``A`` the padding row) and labels
    ``y`` (``[N, W]``), and ``init`` the zero ``(state [A + 1, 2], trans [2,
    2])``.  The windows are split over the ``data`` slots; each slot
    computes its loss and gradient under ``torch.autograd``, and the
    gradients are summed on the first slot's device, then over the
    processes of a ``torch.distributed`` group of more than one process
    when one is up (each process stepping on its own windows).  The
    parameters stay replicated: every slot and process takes the same
    step.
    """
    from ..crf.train import nll

    slots = [mesh.devices[d, 0] for d in range(mesh.devices.shape[0])]
    first = slots[0]

    def make(A: int):
        def step_fn(params, idx, y, lr):
            state, trans = (torch.as_tensor(p, dtype=torch.float32, device=first)
                            for p in params)
            idx, y = torch.as_tensor(idx), torch.as_tensor(y)
            bounds = numpy.linspace(0, idx.shape[0], len(slots) + 1).round().astype(int)
            loss = torch.zeros((), dtype=torch.float32, device=first)
            g_state, g_trans = torch.zeros_like(state), torch.zeros_like(trans)
            for device, a, b in zip(slots, bounds[:-1], bounds[1:]):
                if a == b:
                    continue
                s = state.detach().to(device).requires_grad_(True)
                t = trans.detach().to(device).requires_grad_(True)
                value = nll(s, t, idx[a:b].to(device), y[a:b].to(device))
                gs, gt = torch.autograd.grad(value, (s, t))
                loss += value.detach().to(first)
                g_state += gs.to(first)
                g_trans += gt.to(first)
            if torch.distributed.is_available() and torch.distributed.is_initialized() \
                    and torch.distributed.get_world_size() > 1:
                for tensor in (g_state, g_trans, loss):
                    torch.distributed.all_reduce(tensor)
            return (state - lr * g_state, trans - lr * g_trans), loss

        init = (torch.zeros((A + 1, 2), dtype=torch.float32, device=first),
                torch.zeros((2, 2), dtype=torch.float32, device=first))
        return step_fn, init

    return make
