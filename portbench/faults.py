"""Faults planted in the program underneath a run, to show that the check
catches them (``portbench/tests/test_pb_faults.py`` on the CPU,
``calibrate.py --faults`` on the card at the cell's size). Each is a
context manager that patches the program and restores it.

- ``unchanged``: the step leaves its state as it was: the robot's
  transition returns the state it was given; the trainer's update gets
  zero gradients, so its parameters do not move.
- ``half``: half of the batch left out: the transition steps the first
  half of the envs only; the trainer's loss is the mean over the first
  half of the envs.
- ``altered``: an answer altered where it is produced: the reward adds the
  control cost where the task subtracts it.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name: str, make):
    old = getattr(owner, name)
    setattr(owner, name, make(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


def plant(fault: str, loop: str, ctrl_cost_weight: float = 0.0):
    """The context manager that plants ``fault`` under a ``loop`` run."""
    from gymnasium_tpu_torch.envs.mujoco.locomotion import MujocoFuncEnv
    from gymnasium_tpu_torch.train import ppo

    if fault == "unchanged" and loop == "rollout":
        return _patched(MujocoFuncEnv, "transition", lambda old: lambda self, state, action, rng, params=None: {
            "qpos": state["qpos"], "qvel": state["qvel"], "prev_x": state["qpos"][:, 0]})
    if fault == "unchanged":
        def zero_grads(old):
            def clip(params, max_norm):
                for p in params:
                    p.grad.zero_()
            return clip
        return _patched(ppo, "_clip_by_global_norm", zero_grads)
    if fault == "half" and loop == "rollout":
        def half_step(old):
            def transition(self, state, action, rng, params=None):
                new = old(self, state, action, rng, params)
                keep = torch.arange(action.shape[0], device=action.device) >= action.shape[0] // 2
                return {k: torch.where(keep.reshape(-1, *[1] * (v.dim() - 1)), state["qpos"][:, 0] if k == "prev_x"
                                       else state[k], v) for k, v in new.items()}
            return transition
        return _patched(MujocoFuncEnv, "transition", half_step)
    if fault == "half":
        def half_loss(old):
            def loss(policy, mb, config):
                return old(policy, [x[:, : x.shape[1] // 2] for x in mb], config)
            return loss
        return _patched(ppo, "_loss", half_loss)
    if fault == "altered":
        def altered(old):
            def reward(self, state, action, next_state, rng, params=None):
                return old(self, state, action, next_state, rng, params) + 2 * ctrl_cost_weight * torch.sum(
                    torch.square(action), dim=-1)
            return reward
        from gymnasium_tpu_torch.envs.mujoco.ant import AntFunctional
        from gymnasium_tpu_torch.envs.mujoco.half_cheetah import HalfCheetahFunctional

        stack = contextlib.ExitStack()
        for cls in (HalfCheetahFunctional, AntFunctional):
            stack.enter_context(_patched(cls, "reward", altered))
        return stack
    raise ValueError(f"unknown fault {fault!r}")


FAULTS = ("unchanged", "half", "altered")
