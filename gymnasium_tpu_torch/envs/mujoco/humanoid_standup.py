"""HumanoidStandup-v5 as a batch-first functional env.

Counterpart of ``HumanoidStandupFunctional`` in the JAX package's
``envs/mujoco/humanoid_standup.py``: the Humanoid's observation on the
supine model; the reward is the torso height over the timestep, minus the
control cost and the capped impact cost of the contact wrenches, plus 1.
It never terminates.
"""

from __future__ import annotations

from typing import Any

import torch

from gymnasium_tpu_torch.envs.mujoco.humanoid import HumanoidFunctional

__all__ = ["HumanoidStandupFunctional"]


class HumanoidStandupFunctional(HumanoidFunctional):
    """Rise from lying down to standing."""

    model_name = "humanoidstandup"

    def reward(self, state, action, next_state, rng, params: Any = None):
        q = next_state["qpos"]
        uph_cost = q[:, 2] / self.model.timestep
        cfrc = self._dyn["contact_wrenches"](q, next_state["qvel"])
        impact = torch.clamp(0.5e-6 * torch.sum(torch.square(cfrc), dim=(1, 2)), max=10.0)
        return uph_cost - 0.1 * torch.sum(torch.square(action), dim=-1) - impact + 1.0

    def terminal(self, state, rng, params: Any = None):
        qpos = state["qpos"]
        return torch.zeros(qpos.shape[0], dtype=torch.bool, device=qpos.device)
