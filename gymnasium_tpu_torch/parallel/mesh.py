"""Device meshes and env-batch sharding over ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``. JAX runs one program
over a ``Mesh`` of devices and XLA inserts the collectives. Here every rank
is a process of the default process group with one device (a card under
NCCL, or the CPU under gloo), and the mesh is a ``DeviceMesh`` over the ranks
with JAX's axis names. A sharded leaf is a ``DTensor``: ``Shard(0)`` on the
mesh dimensions the env axis spans, ``Replicate()`` elsewhere. A step on a
sharded carry runs the unchanged eager step on each rank's local rows
(``to_local()`` in, ``DTensor.from_local`` out), as ``shard_map`` runs the
Pallas call on each device's block; its collectives are explicit, over the
env axes' process group (:mod:`gymnasium_tpu_torch.parallel.shard`).

A ``torch.Generator`` is never sharded: every rank keeps the whole batch's
generator, made equal on all ranks, and a random hook draws for the whole
batch and keeps its own rows, so a sharded trajectory equals the unsharded
one from the same seed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from gymnasium_tpu_torch.functional import tree_map
from gymnasium_tpu_torch.parallel.shard import EnvShard, use

__all__ = [
    "make_mesh",
    "make_mesh_two_level",
    "shard_env_batch",
    "replicated",
    "shard_ppo_state",
    "gather_trajectory",
    "scaling_report",
    "NamedSharding",
]


def _mesh(devices: str | torch.device | None, shape: Callable[[int], tuple[int, int]],
          names: tuple[str, str]) -> DeviceMesh:
    """A 2-D mesh over every rank of the default group, one device each."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the default process group: call torch.distributed.init_process_group first")
    device_type = "cuda" if devices is None else torch.device(devices).type
    n = dist.get_world_size()
    return DeviceMesh(device_type, torch.arange(n).reshape(shape(n)), mesh_dim_names=names)


def make_mesh(devices: str | torch.device | None = None, tp: int = 1) -> DeviceMesh:
    """A ``(dp, tp)`` mesh over the ranks of the default process group, one
    device each: CUDA (NCCL, one rank a card) unless ``devices`` names
    another device type (``"cpu"`` under gloo, as the tests run). Every
    rank calls it.

    ``tp`` splits off a tensor-parallel axis for the learner; the remaining
    ranks form the data-parallel env axis.
    """

    def shape(n):
        assert n % tp == 0, f"device count {n} not divisible by tp={tp}"
        return n // tp, tp

    return _mesh(devices, shape, ("dp", "tp"))


def make_mesh_two_level(devices: str | torch.device | None = None, hosts: int = 2) -> DeviceMesh:
    """A ``(hosts, chips)`` mesh: the multi-host factorization (NVLink inside
    a host row, the network across rows). The env batch shards over BOTH
    axes; env stepping needs no collective on either, the learner's
    all-reduces span both. ``devices`` as in :func:`make_mesh`."""

    def shape(n):
        assert n % hosts == 0, f"device count {n} not divisible by hosts={hosts}"
        return hosts, n // hosts

    return _mesh(devices, shape, ("hosts", "chips"))


@dataclass(frozen=True)
class NamedSharding:
    """JAX's ``NamedSharding(mesh, PartitionSpec(*spec))`` for a DeviceMesh.

    ``spec[i]`` is the mesh axis name (or a tuple of names, or None) that
    tensor dimension ``i`` is split over; ``()`` replicates. A tuple of names
    splits the dimension over those axes in mesh order, the first outermost,
    as ``P(("hosts", "chips"))`` does.
    """

    mesh: DeviceMesh
    spec: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "spec", tuple(self.spec))
        names = self.mesh.mesh_dim_names or ()
        seen = [n for entry in self.spec for n in _names(entry)]
        unknown = [n for n in seen if n not in names]
        if unknown or len(seen) != len(set(seen)):
            raise ValueError(f"spec {self.spec} does not name distinct axes of the mesh {names}")
        for entry in self.spec:
            dims = [names.index(n) for n in _names(entry)]
            if dims != sorted(dims):
                raise ValueError(f"{entry} must list mesh axes in mesh order {names}")

    @property
    def placements(self) -> tuple:
        """The DTensor placements: ``Shard(i)`` on each mesh dimension that
        ``spec[i]`` names, ``Replicate()`` on the others."""
        out = [Replicate()] * self.mesh.ndim
        for dim, entry in enumerate(self.spec):
            for name in _names(entry):
                out[self.mesh.mesh_dim_names.index(name)] = Shard(dim)
        return tuple(out)

    @property
    def is_fully_replicated(self) -> bool:
        return all(p.is_replicate() for p in self.placements)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def replicated(mesh: DeviceMesh) -> NamedSharding:
    """Sharding that replicates a tree over the whole mesh."""
    return NamedSharding(mesh, ())


# -- env shards ---------------------------------------------------------------

#: ``(id(mesh), placements)`` -> shard. Keyed on the mesh object, not its
#: value: a mesh made anew after the default group was (its groups are new)
#: compares equal to the old one. An entry holds its mesh, so its id stays taken.
_SHARDS: dict = {}


def _mesh_group(mesh: DeviceMesh, dims: Sequence[int]):
    """The process group over mesh dimensions ``dims`` that holds this rank
    (None: the default group)."""
    dims = tuple(dims)
    if len(dims) == mesh.ndim and mesh.size() == dist.get_world_size():
        return None
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    return mesh[tuple(mesh.mesh_dim_names[d] for d in dims)]._flatten().get_group()


def shard_for(sharding: NamedSharding | EnvShard | DTensor) -> EnvShard:
    """The :class:`EnvShard` of a sharding over the env axis (dimension 0),
    or of a sharded leaf; one object a mesh object and placements, made on
    first use."""
    if isinstance(sharding, EnvShard):
        return sharding
    if isinstance(sharding, DTensor):
        mesh, placements = sharding.device_mesh, tuple(sharding.placements)
        placements = tuple(Shard(0) if p.is_shard() else p for p in placements)
    else:
        mesh, placements = sharding.mesh, sharding.placements
    key = (id(mesh), placements)
    shard = _SHARDS.get(key)
    if shard is None or shard.mesh is not mesh:
        dims = [d for d, p in enumerate(placements) if p.is_shard()]
        if not dims or any(placements[d].dim != 0 for d in dims):
            raise ValueError(f"the env axis (dimension 0) must be sharded, got {placements}")
        coordinate = mesh.get_coordinate()
        if coordinate is None:
            raise ValueError("this rank is not in the mesh")
        sizes = [mesh.size(d) for d in dims]
        index = int(np.ravel_multi_index([coordinate[d] for d in dims], sizes))
        group = _mesh_group(mesh, dims)
        if dist.get_rank(group) != index:
            raise ValueError("the mesh's ranks must increase along the axes the env batch is sharded over")
        shard = _SHARDS[key] = EnvShard(mesh, placements, index, int(np.prod(sizes)), group)
    return shard


def shard_of(leaf: Any) -> EnvShard | None:
    """The shard of a sharded leaf, None for any other."""
    if isinstance(leaf, DTensor) and any(p.is_shard() for p in leaf.placements):
        return shard_for(leaf)
    return None


def _placements(shard: EnvShard, dim: int) -> tuple:
    return tuple(Shard(dim) if p.is_shard() else p for p in shard.placements)


def local(tree: Any) -> Any:
    """``tree`` with each DTensor replaced by this rank's local tensor."""
    return tree_map(lambda leaf: leaf.to_local() if isinstance(leaf, DTensor) else leaf, tree)


def sharded_mask(tree: Any) -> Any:
    """Tree of bools: True where a leaf is a DTensor sharded over the env axis."""
    return tree_map(lambda leaf: isinstance(leaf, DTensor) and any(p.is_shard() for p in leaf.placements), tree)


def wrap(tree: Any, per_env: Any, shard: EnvShard, dim: int = 0) -> Any:
    """Local tensors as DTensors: per-env leaves (``per_env`` True, or every
    tensor for ``per_env=True``) sharded along ``dim``, the others replicated.
    Generators and other leaves stay as they are."""
    sharded = _placements(shard, dim)
    replicate = (Replicate(),) * shard.mesh.ndim
    if per_env is True:
        per_env = tree_map(lambda _: True, tree)

    def put(leaf, is_per_env):
        if not isinstance(leaf, torch.Tensor) or isinstance(leaf, DTensor):
            return leaf
        return DTensor.from_local(leaf, shard.mesh, sharded if is_per_env else replicate, run_check=False)

    return tree_map(put, tree, per_env)


def on_shard(fn: Callable, shard: EnvShard, carry: Any, *rest: Any, dims: Sequence[int | None] = (0,)) -> tuple:
    """``fn(carry, *rest)`` as this rank's part of a step on a sharded
    ``carry``: each DTensor passed in as its local tensor, ``shard`` active
    meanwhile (:func:`~gymnasium_tpu_torch.parallel.shard.use`). ``fn``
    returns ``(carry, *outputs)``; the carry comes back placed as it came in,
    and ``outputs[i]`` sharded along dimension ``dims[i]`` (``None``: as it is)."""
    mask = sharded_mask(carry)
    with use(shard):
        carry, *outputs = fn(local(carry), *(local(x) for x in rest))
    placed = [out if dim is None else wrap(out, True, shard, dim) for out, dim in zip(outputs, dims, strict=True)]
    return (wrap(carry, mask, shard), *placed)


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _broadcast(x: torch.Tensor, mesh: DeviceMesh) -> None:
    """Overwrite ``x`` with the mesh's first rank's ``x``, through the mesh's device."""
    group = _mesh_group(mesh, range(mesh.ndim))
    src = int(mesh.mesh.flatten()[0])
    wire = x.detach().to(_mesh_device(mesh))
    dist.broadcast(wire, src=src, group=group)
    if wire is not x:
        x.data.copy_(wire)


def _replicate_generator(g: torch.Generator, mesh: DeviceMesh) -> torch.Generator:
    """``g`` set to the state of the mesh's first rank's: the counterpart of
    placing a PRNG key replicated."""
    state = g.get_state()
    _broadcast(state, mesh)
    g.set_state(state)
    return g


def _scatter(tree: Any, per_env: Any, shard: EnvShard) -> Any:
    """This rank's part of a whole tree: per-env leaves cut to its rows,
    generators made equal on every rank, every leaf a DTensor."""
    device = _mesh_device(shard.mesh)
    if per_env is True:
        per_env = tree_map(lambda _: True, tree)

    def put(leaf, is_per_env):
        if isinstance(leaf, torch.Generator):
            return _replicate_generator(leaf, shard.mesh)
        if leaf is None or isinstance(leaf, DTensor):
            return leaf
        leaf = torch.as_tensor(leaf, device=device)
        return shard.take(leaf).clone() if is_per_env else leaf

    return wrap(tree_map(put, tree, per_env), per_env, shard)


def shard_env_batch(
    tree: Any,
    mesh: DeviceMesh,
    batch_size: int | None = None,
    axis: str | tuple = "dp",
) -> Any:
    """Place a batched env tree with its leading axis split over ``axis``
    (one mesh axis name, or a tuple of names for multi-level meshes, e.g.
    ``("hosts", "chips")``).

    Every rank passes the same whole tree (numpy arrays or tensors) and gets
    its rows back as DTensors. Leaves whose leading dimension equals
    ``batch_size`` (inferred as the most common leading dim when ``None``)
    shard over ``axis``; every other tensor replicates, and a
    ``torch.Generator`` stays a generator set to the first rank's state.
    """
    leaves: list = []
    tree_map(leaves.append, tree)
    if batch_size is None:
        dims = [np.shape(leaf)[0] for leaf in leaves if isinstance(leaf, (torch.Tensor, np.ndarray))
                and np.ndim(leaf) >= 1]
        assert dims, "cannot infer batch size from a tree of scalars"
        batch_size = max(set(dims), key=dims.count)
    per_env = tree_map(
        lambda leaf: isinstance(leaf, (torch.Tensor, np.ndarray)) and np.ndim(leaf) >= 1
        and np.shape(leaf)[0] == batch_size,
        tree,
    )
    return _scatter(tree, per_env, shard_for(NamedSharding(mesh, (axis,))))


def gather_trajectory(traj: Any, mesh: DeviceMesh) -> Any:
    """All-gather a dp-sharded trajectory tree onto every rank: each sharded
    leaf becomes a replicated DTensor holding the whole env axis, through one
    all-gather over the env axes' group. Use only at learner boundaries; the
    rollout itself should stay sharded."""

    def gather(leaf):
        if not isinstance(leaf, DTensor):
            return leaf
        dims = {p.dim for p in leaf.placements if p.is_shard()}
        if not dims:
            return leaf
        (dim,) = dims
        full = shard_for(leaf).all_gather(leaf.to_local(), dim)
        return DTensor.from_local(full, leaf.device_mesh, (Replicate(),) * leaf.device_mesh.ndim, run_check=False)

    return tree_map(gather, traj)


def _whole(tree: Any, mesh: DeviceMesh) -> Any:
    """The whole batch of a sharded tree as plain tensors on every rank, its
    generators copied (the caller's stay untouched)."""

    def copy(leaf):
        if not isinstance(leaf, torch.Generator):
            return leaf
        twin = torch.Generator(device=leaf.device)
        twin.set_state(leaf.get_state())
        return twin

    return tree_map(copy, local(gather_trajectory(tree, mesh)))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def scaling_report(step_fn: Callable, args: Sequence[Any], mesh: DeviceMesh, iters: int = 10) -> dict:
    """Time ``step_fn(*args)`` on each rank's shard against the mesh's first
    rank alone on the whole batch.

    ``sharded_s`` is a call with every rank stepping its shard (a barrier
    before and after, the device synced); ``single_device_s`` is the first
    rank running ``step_fn`` on the gathered batch while the others wait.
    ``step_fn`` must leave ``args`` usable (generators in them are copied
    for the single-device run). Returns JAX's four keys, the same dict on
    every rank."""
    device = _mesh_device(mesh)
    group = _mesh_group(mesh, range(mesh.ndim))
    first = int(mesh.mesh.flatten()[0])

    def timed(call_args) -> float:
        step_fn(*call_args)
        _sync(device)
        start = time.perf_counter()
        for _ in range(iters):
            step_fn(*call_args)
        _sync(device)
        return (time.perf_counter() - start) / iters

    dist.barrier(group=group)
    sharded = timed(args)
    dist.barrier(group=group)
    whole = _whole(args, mesh)
    report = [None]
    if dist.get_rank() == first:
        alone = timed(whole)
        n = mesh.size()
        report = [{"devices": n, "sharded_s": sharded, "single_device_s": alone,
                   "scaling_efficiency": alone / (sharded * n)}]
    dist.broadcast_object_list(report, src=first, group=group)
    return report[0]


def shard_ppo_state(state: Any, mesh: DeviceMesh, axis: str | tuple = "dp") -> Any:
    """Lay out a :class:`~gymnasium_tpu_torch.train.ppo.PPOState` on ``mesh``.

    The env carry (its generator replicated) and the observation shard over
    ``axis`` (default the ``dp`` axis; pass ``("hosts", "chips")`` on a
    two-level mesh), the per-env leaves decided by the carry's structure;
    the policy's parameters, the optimizer's state, the trainer's generator
    and the update count are set to the first rank's, which replicates them.
    A train step over the result runs each rank's rows and averages the
    gradient over ``axis``.
    """
    from gymnasium_tpu_torch.wrappers.func import per_env_mask

    with torch.no_grad():
        for p in state.policy.parameters():
            _broadcast(p, mesh)
        for slot in state.optimizer.state.values():
            for value in slot.values():
                if isinstance(value, torch.Tensor):
                    _broadcast(value, mesh)
        _broadcast(state.update_count, mesh)
    shard = shard_for(NamedSharding(mesh, (axis,)))
    return state._replace(
        env_carry=_scatter(state.env_carry, per_env_mask(state.env_carry, state.obs.shape[0]), shard),
        obs=_scatter(state.obs, True, shard),
        rng=_replicate_generator(state.rng, mesh),
    )
