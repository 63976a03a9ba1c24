"""Multi-process start-up and contig sharding for multi-host runs.

* :func:`initialize` — the ``torch.distributed`` bootstrap of a group of
  processes (the twin of ``gecco_tpu.parallel.hosts.initialize`` on
  ``jax.distributed``); nothing for a single process;
* :func:`contig_shard` and :func:`parse_shard` — copies of the JAX
  package's: a deterministic, length-balanced assignment of contigs to
  processes, identical on every host (no communication); the CLI's
  ``--shard K/N`` keeps one shard.
"""

import datetime
from typing import List, Optional, Sequence, Tuple

__all__ = ["initialize", "contig_shard", "parse_shard"]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    timeout_s: float = 600.0,
) -> Tuple[int, int]:
    """Join a ``torch.distributed`` group and return ``(rank, world size)``.

    ``coordinator_address`` is ``host:port`` (``tcp://`` is prepended) or
    a full init method such as ``file:///shared/store``.  The backend is
    ``nccl`` on a machine with a card and ``gloo`` without one;
    ``timeout_s`` bounds the wait for the other processes.  With no address and no group up this does nothing and
    returns ``(0, 1)``; with a group up it returns that group's rank and
    size.
    """
    import torch
    import torch.distributed as dist

    if not dist.is_available():
        if coordinator_address is not None:
            raise RuntimeError("this PyTorch build has no torch.distributed")
        return 0, 1
    if coordinator_address is not None and not dist.is_initialized():
        method = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group(
            "nccl" if torch.cuda.is_available() else "gloo",
            init_method=method, world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def contig_shard(
    lengths: Sequence[int], process_id: int, process_count: int
) -> List[int]:
    """Deterministic length-balanced contig assignment (LPT greedy).

    Every process computes the same global assignment from the same
    contig length list and keeps its own slice — no communication.
    Returns the indices owned by ``process_id`` in input order.
    """
    if not 0 <= process_id < process_count:
        raise ValueError(f"process_id {process_id} not in [0, {process_count})")
    order = sorted(range(len(lengths)), key=lambda i: (-int(lengths[i]), i))
    loads = [0] * process_count
    owner = {}
    for i in order:
        s = min(range(process_count), key=lambda k: (loads[k], k))
        owner[i] = s
        loads[s] += int(lengths[i])
    return [i for i in range(len(lengths)) if owner[i] == process_id]


def parse_shard(spec: Optional[str]) -> Tuple[int, int]:
    """Parse a ``K/N`` CLI shard spec (1-based K) into ``(index, count)``."""
    if spec is None:
        return 0, 1
    try:
        k_str, n_str = spec.split("/", 1)
        k, n = int(k_str), int(n_str)
    except ValueError:
        raise ValueError(f"invalid shard spec {spec!r}; expected K/N") from None
    if not 1 <= k <= n:
        raise ValueError(f"shard index {k} not in [1, {n}]")
    return k - 1, n
