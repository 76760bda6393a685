"""One rank's slice of a sharded env batch, and the collectives over it.

JAX runs one program over a mesh and XLA inserts the collectives; here each
rank is a process that steps its own rows of the batch. An :class:`EnvShard`
says which rows a rank holds (``index`` of ``count`` equal slices of the env
axis) and over which process group the rows of all ranks meet. The code that
steps a local batch reads the shard of the step in progress from
:func:`active` (set by :func:`use`): random hooks draw for the whole batch and
keep their rows (:meth:`EnvShard.take`), and statistics over the batch reduce
over ``group`` (:meth:`EnvShard.all_reduce`).

Every collective the port makes goes through this module, which counts it in
:data:`collectives` by operation and group size. This module imports no
``torch.distributed.tensor``, so a step on one device pays no import.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any, Iterator

import torch
import torch.distributed as dist

__all__ = ["EnvShard", "active", "collectives", "use"]

#: Collectives made since the last ``clear()``, by ``(operation, group size)``.
collectives: collections.Counter = collections.Counter()

_ACTIVE: contextvars.ContextVar[EnvShard | None] = contextvars.ContextVar("env_shard", default=None)


@dataclass(frozen=True, eq=False)
class EnvShard:
    """Rows ``[index * n / count, (index + 1) * n / count)`` of an env batch of ``n``.

    ``mesh`` and ``placements`` are the DeviceMesh and the DTensor placements
    of a per-env leaf (``Shard(0)`` on the mesh dimensions the env axis
    spans); ``group`` is the process group over those dimensions (``None``:
    the default group).
    """

    mesh: Any
    placements: tuple
    index: int
    count: int
    group: Any

    def local_count(self, num_envs: int) -> int:
        """Envs a rank holds of a batch of ``num_envs``."""
        if num_envs % self.count:
            raise ValueError(f"{num_envs} envs do not split evenly over {self.count} shards")
        return num_envs // self.count

    def take(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of ``x``, whose ``dim`` is the whole env axis."""
        per = self.local_count(x.shape[dim])
        return x.narrow(dim, self.index * per, per)

    @property
    def group_size(self) -> int:
        return dist.get_world_size(self.group)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the env axes' ranks, in place on a copy."""
        out = x.contiguous().clone()
        collectives["all_reduce", self.group_size] += 1
        dist.all_reduce(out, group=self.group)
        return out

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The whole env axis: every rank's ``x`` joined along ``dim`` in shard order."""
        # gloo gathers no bool tensor
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x
        wire = wire.movedim(dim, 0).contiguous()
        parts = [torch.empty_like(wire) for _ in range(self.group_size)]
        collectives["all_gather", self.group_size] += 1
        dist.all_gather(parts, wire, group=self.group)
        # a group lists its ranks in mesh order, which is shard order
        return torch.cat(parts).movedim(0, dim).to(x.dtype)

    def merge_moments(self, mean: torch.Tensor, var: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The whole batch's mean and population variance from each rank's
        (equal counts): one all-gather, then Chan et al.'s merge in shard
        order, the same on every rank. A group of one gives its own back."""
        parts = self.all_gather(torch.stack([mean, var])[None])
        mean, var = parts[0]
        for i in range(1, self.count):
            # i shards merged so far, one more of the same count
            delta = parts[i][0] - mean
            mean = mean + delta / (i + 1)
            var = (var * i + parts[i][1] + torch.square(delta) * i / (i + 1)) / (i + 1)
        return mean, var


def active() -> EnvShard | None:
    """The shard of the step in progress, or None on one device."""
    return _ACTIVE.get()


@contextlib.contextmanager
def use(shard: EnvShard | None) -> Iterator[None]:
    """Make ``shard`` the :func:`active` one inside the block."""
    token = _ACTIVE.set(shard)
    try:
        yield
    finally:
        _ACTIVE.reset(token)
