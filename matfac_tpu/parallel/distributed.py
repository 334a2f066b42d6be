"""Multi-host runtime initialization.

The reference has no distributed backend (OpenMP only — SURVEY.md §2);
this is the from-scratch multi-host story: `jax.distributed` process
bootstrap + host-local data loading helpers so each host stages only
its own shard of the rating stream (ratings partitioned by user block,
matching the row-sharded factor tables of parallel/dsgd — the host
network carries only the initial distribution, the device links carry
the training collectives).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    No-op for single-process runs."""
    import jax
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=(num_processes
                       or int(os.environ.get("JAX_NUM_PROCESSES", "1"))),
        process_id=(process_id
                    or int(os.environ.get("JAX_PROCESS_ID", "0"))))


def host_user_range(n_users: int, n_shards: int, shard_id: int
                    ) -> Tuple[int, int]:
    """Contiguous user-row range owned by a shard (matches the
    row-sharding of parallel/dsgd: block i = rows [i*bu, (i+1)*bu))."""
    bu = -(-n_users // n_shards)
    return shard_id * bu, min((shard_id + 1) * bu, n_users)


def host_local_ratings(train_mat, n_users: int, n_shards: int,
                       shard_id: int):
    """Filter a host's local rating rows (users it owns) — what each
    process would load/stage in a multi-host run so no host holds the
    full stream."""
    lo, hi = host_user_range(n_users, n_shards, shard_id)
    r, c, v = train_mat.to_coo()
    keep = (r >= lo) & (r < hi)
    return r[keep], c[keep], v[keep]
