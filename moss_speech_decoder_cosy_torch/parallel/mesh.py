"""Devices and data-parallel sharding, after the JAX package's
``parallel/mesh.py``.

The reference's distributed surface is data parallelism (DDP / DeepSpeed
ZeRO-2) plus process-sharded eval.  On ``torch.distributed``:

- ``make_mesh``: the devices a fan-out runs on (one replica each: the
  SPMD session, ``pipeline/spmd_session.py``);
- ``zero_sharding``: the JAX package's ZeRO rule, each tensor split along
  its largest dimension divisible by the group's size, else replicated;
  the train steps keep only their rank's slice of the AdamW moments
  (``training/train_step.AdamW(zero=...)``);
- ``DataGroup``: the collectives of a data-parallel train step over one
  process group (every rank a replica of the weights; the gradients summed
  in one flat all-reduce).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from . import distributed as D


def make_mesh(n_devices: Optional[int] = None, device_type=None
              ) -> List[torch.device]:
    """The first ``n_devices`` cards (all of them by default), or, with
    ``device_type="cpu"``, ``n_devices`` CPU replicas."""
    kind = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
    if kind == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    n = torch.cuda.device_count() if n_devices is None else n_devices
    if n > torch.cuda.device_count():
        raise ValueError(f"{n} cards asked for, "
                         f"{torch.cuda.device_count()} present")
    return [torch.device("cuda", i) for i in range(n)]


def zero_dim(shape: Sequence[int], n: int) -> Optional[int]:
    """The dimension ``zero_sharding`` splits a tensor of ``shape`` along
    over ``n`` ranks: its largest dimension divisible by ``n`` (the first
    of equals), or None (replicated)."""
    dims = [(d, s) for d, s in enumerate(shape) if s % n == 0 and s >= n]
    if not dims:
        return None
    return max(dims, key=lambda t: t[1])[0]


def zero_sharding(tensors: Sequence[torch.Tensor], n: int
                  ) -> List[Optional[int]]:
    """For each tensor, the dimension its ZeRO shards split along over
    ``n`` ranks, or None (replicated): the JAX package's rule
    (``mesh.py:41-57``)."""
    return [zero_dim(tuple(t.shape), n) for t in tensors]


class DataGroup:
    """A data-parallel process group (default: every rank): its rank, its
    size and the collectives the train steps issue."""

    def __init__(self, group=None):
        if not D.is_initialized():
            raise RuntimeError("a data group needs an initialized process "
                               "group (parallel.distributed.initialize)")
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return D.all_reduce_sum(t, self.group)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return D.all_reduce_max(t, self.group)

    def sum_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sums each tensor over the ranks in place: one all-reduce of the
        tensors flattened into one buffer."""
        tensors = list(tensors)
        if not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        parts = flat.split([t.numel() for t in tensors])
        torch._foreach_copy_(tensors, [p.view_as(t)
                                       for p, t in zip(parts, tensors)])

    def gather_slices(self, params: Sequence[torch.Tensor],
                      dims: Sequence[Optional[int]]) -> None:
        """Every rank's slice (chunk ``rank`` of ``world`` along ``dims[i]``)
        of each sharded tensor, written into the others' tensors in place:
        one all-gather of the slices flattened into one buffer."""
        pairs = [(p, d) for p, d in zip(params, dims) if d is not None]
        if not pairs:
            return
        mine = torch.cat([p.chunk(self.world, d)[self.rank].reshape(-1)
                          for p, d in pairs])
        got = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(got, mine, group=self.group)
        off = 0
        for p, d in pairs:
            shape = p.chunk(self.world, d)[0].shape
            n = shape.numel()
            for r in range(self.world):
                if r != self.rank:
                    p.chunk(self.world, d)[r].copy_(
                        got[r][off:off + n].view(shape))
            off += n


def data_group(group=None) -> Optional[DataGroup]:
    """The data group of an initialized process group, else None."""
    return DataGroup(group) if D.is_initialized() else None
