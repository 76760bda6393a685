"""The env batch sharded across ranks, one device a rank: the PyTorch port's
counterpart of ``examples/sharded_rollout.py``. Each rank is a process of one
``torch.distributed`` group; the mesh is a DeviceMesh over them, and each
rank steps its own rows of the batch with no collective on the hot path.

    python examples/torch_sharded_rollout.py [--device cpu|cuda] [--ranks R] [--steps T]

``--device cuda`` (the default) runs one rank a visible card over NCCL;
``--device cpu`` runs 4 ranks over gloo on the host.
"""

import argparse

import torch

from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional
from gymnasium_tpu_torch.parallel import make_mesh, shard_env_batch
from gymnasium_tpu_torch.parallel.launch import run_ranks
from gymnasium_tpu_torch.vector.torch_vector_env import TorchVectorEnv

ENVS_A_RANK = 64


def rank_main(rank: int, ranks: int, device: str, steps: int) -> tuple:
    """One rank: the mesh, the whole batch placed over it, a rollout of this rank's rows."""
    mesh = make_mesh(device)
    if rank == 0:
        print(f"mesh: {mesh}", flush=True)
    num_envs = ENVS_A_RANK * ranks
    env = TorchVectorEnv(CartPoleFunctional(), num_envs=num_envs, max_episode_steps=500, seed=0, device=device)
    env.reset()
    # place the env state across the data-parallel axis; each rank then
    # steps its rows with no collective on the hot path
    env.carry = shard_env_batch(env.carry, mesh)

    carry, traj = env.rollout(steps)
    if device == "cuda":
        torch.cuda.synchronize()
    shape = tuple(traj.obs.to_local().shape)
    print(f"rank {rank}: obs shard {shape} of {tuple(traj.obs.shape)}, placements {traj.obs.placements}", flush=True)
    return shape


def main(device: str = "cuda", ranks: int | None = None, steps: int = 256) -> dict:
    if ranks is None:
        ranks = max(torch.cuda.device_count(), 1) if device == "cuda" else 4
    shards = run_ranks(rank_main, ranks, device, steps, device=device, timeout=600)
    print(f"rolled out {ENVS_A_RANK * ranks}x{steps} steps across {ranks} ranks")
    return {"shards": shards}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    parser.add_argument("--ranks", type=int, default=None)
    parser.add_argument("--steps", type=int, default=256)
    main(**vars(parser.parse_args()))
