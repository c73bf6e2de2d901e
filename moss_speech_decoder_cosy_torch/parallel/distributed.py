"""Process groups and host sharding over ``torch.distributed``, after the
JAX package's ``parallel/distributed.py`` (the reference initializes
torch.distributed from env vars, train_utils.py:39-51).

- ``initialize()``: one process group from torchrun's environment
  (``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``) or from
  the arguments; ``nccl`` when the process uses a card, ``gloo`` on the
  CPU.  A no-op in a single process (no address, world size 1) or once a
  group is up.
- ``host_shard``: each rank's share of a work list, the same ``[rank::n]``
  slice as the JAX package (the reference's RANK-sharded eval,
  benchmark_moss_decoder.py:175-189).
- ``local_rows``: each rank's rows of a global batch, the counterpart of
  JAX ``global_batch`` (which stacks per-host batches into one sharded
  array; here each rank keeps its rows and the train steps all-reduce).
- ``all_reduce_sum`` / ``all_reduce_max``: the step's collectives, a no-op
  without a group.

Uneven data across ranks: every rank runs the same number of steps (the
JAX package sizes epochs to the shortest host's; the trainer stops at
``--max_steps`` or at the first rank whose data ends, ``bin/train.py``).
"""

from __future__ import annotations

import datetime
import os
from typing import Mapping, Optional, Sequence

import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(address: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               device=None, timeout_s: float = 300.0) -> bool:
    """Joins the process group; returns whether one is up.  ``address``
    ``host:port`` (default ``MASTER_ADDR:MASTER_PORT``), ``world_size`` and
    ``rank`` default to torchrun's ``WORLD_SIZE`` / ``RANK``.  ``backend``
    defaults to ``nccl`` for a CUDA ``device`` (the card unless the caller
    asks for the CPU) and ``gloo`` for the CPU; on a card the process uses
    ``cuda:LOCAL_RANK`` (default the rank modulo the cards)."""
    if is_initialized():
        return True
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(env.get("RANK", "0"))
    if address is None and "MASTER_ADDR" in env:
        address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if address is None:
        if world_size > 1:
            raise ValueError(f"world size {world_size} needs an address "
                             "(MASTER_ADDR / MASTER_PORT or address=)")
        return False
    dev = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(
        backend, init_method=f"tcp://{address}", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()


def rank(group=None) -> int:
    return dist.get_rank(group) if is_initialized() else 0


def world_size(group=None) -> int:
    return dist.get_world_size(group) if is_initialized() else 1


def host_shard(items: Sequence, rank_: Optional[int] = None,
               world: Optional[int] = None) -> list:
    """Rank ``rank_``'s items: every ``world``-th from its own index."""
    r = rank() if rank_ is None else rank_
    n = world_size() if world is None else world
    return list(items)[r::n]


def local_rows(batch: Mapping, rank_: Optional[int] = None,
               world: Optional[int] = None) -> dict:
    """Rank ``rank_``'s rows of a global batch (a mapping of arrays or
    tensors with the rows first): consecutive blocks of B / world rows in
    rank order, as a mesh's data axis shards them."""
    r = rank() if rank_ is None else rank_
    n = world_size() if world is None else world
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"a global batch of {b} rows does not split over "
                         f"{n} ranks")
    k = b // n
    return {key: v[r * k:(r + 1) * k] for key, v in batch.items()}


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks (a new tensor; ``t`` itself
    without a group)."""
    if not is_initialized():
        return t
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    if not is_initialized():
        return t
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out
