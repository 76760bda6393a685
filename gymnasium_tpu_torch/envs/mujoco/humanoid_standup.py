"""HumanoidStandup-v5: its host env and its batch-first functional env.

Counterpart of ``HumanoidStandupEnv`` (the host class behind ``make``) and
``HumanoidStandupFunctional`` in the JAX package's
``envs/mujoco/humanoid_standup.py``: the Humanoid's observation on the
supine model; the reward is the torso height over the timestep, minus the
control cost and the capped impact cost of the contact wrenches, plus 1.
It never terminates.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch.envs.mujoco.humanoid import HumanoidEnv, HumanoidFunctional
from gymnasium_tpu_torch.utils.ezpickle import EzPickle

__all__ = ["HumanoidStandupEnv", "HumanoidStandupFunctional"]


class HumanoidStandupEnv(HumanoidEnv):
    """Rise from lying down to standing."""

    model_name_default = "humanoidstandup"

    def __init__(
        self,
        uph_cost_weight: float = 1.0,
        ctrl_cost_weight: float = 0.1,
        impact_cost_weight: float = 0.5e-6,
        reset_noise_scale: float = 1e-2,
        render_mode: str | None = None,
        **kwargs: Any,
    ):
        self.uph_cost_weight = uph_cost_weight
        self.impact_cost_weight = impact_cost_weight
        super().__init__(
            ctrl_cost_weight=ctrl_cost_weight,
            terminate_when_unhealthy=False,
            reset_noise_scale=reset_noise_scale,
            render_mode=render_mode,
            **kwargs,
        )
        # record this class's own arguments: HumanoidEnv recorded its
        # signature above, which this class cannot take when unpickled
        EzPickle.__init__(
            self,
            uph_cost_weight,
            ctrl_cost_weight,
            impact_cost_weight,
            reset_noise_scale,
            render_mode,
            **kwargs,
        )

    def step(self, action):
        self.do_simulation(action)
        self._last_ctrl = np.clip(
            np.asarray(action), self.model.act_ctrlrange[:, 0], self.model.act_ctrlrange[:, 1]
        )
        pos_after = self.torso_z
        uph_cost = float(self.uph_cost_weight * pos_after / self.model.timestep)
        quad_ctrl_cost = self.ctrl_cost_weight * float(np.square(action).sum())
        # over the contact wrenches, clipped to 10 (upstream humanoidstandup_v5.py:448-452)
        quad_impact_cost = float(np.clip(self.impact_cost_weight * np.square(self.cfrc_ext).sum(), -np.inf, 10.0))
        # upstream's grouping
        reward = uph_cost + -quad_ctrl_cost + -quad_impact_cost + 1

        info = {
            # upstream humanoidstandup_v5.py:429-435, without the tendon keys
            "x_position": float(self.qpos[0]),
            "y_position": float(self.qpos[1]),
            "z_distance_from_origin": float(self.qpos[2] - self.init_qpos[2]),
            "reward_linup": uph_cost,
            "reward_quadctrl": -quad_ctrl_cost,
            "reward_impact": -quad_impact_cost,
        }
        if self.render_mode == "human":
            self.render()
        return self._get_obs(), reward, False, False, info

    def _reset_info(self):
        return {
            "x_position": self.qpos[0],
            "y_position": self.qpos[1],
            "z_distance_from_origin": self.qpos[2] - self.init_qpos[2],
        }


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
