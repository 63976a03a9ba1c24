"""Contig sharding for multi-host runs.

A copy of ``contig_shard`` and ``parse_shard`` from
``gecco_tpu.parallel.hosts``: a deterministic, length-balanced
assignment of contigs to processes, identical on every host (no
communication); the CLI's ``--shard K/N`` keeps one shard.  Process
start-up across hosts is not ported yet (``ROADMAP.md`` Queue 1 item 12).
"""

from typing import List, Optional, Sequence, Tuple

__all__ = ["contig_shard", "parse_shard"]


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
