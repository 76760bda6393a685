"""Multi-device mesh and sharding helpers.

The seven names of the JAX package's ``parallel`` load
:mod:`gymnasium_tpu_torch.parallel.mesh` on first use: it imports
``torch.distributed.tensor``, which takes about a second, and a step on one
device needs none of it.
"""

__all__ = [
    "make_mesh",
    "make_mesh_two_level",
    "shard_env_batch",
    "replicated",
    "shard_ppo_state",
    "gather_trajectory",
    "scaling_report",
]


def __getattr__(name: str):
    if name in __all__:
        from gymnasium_tpu_torch.parallel import mesh

        return getattr(mesh, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
