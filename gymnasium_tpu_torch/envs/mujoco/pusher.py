"""Pusher-v5: its host env and its batch-first functional env.

Counterpart of ``PusherEnv`` (the host class behind ``make``) and
``PusherFunctional`` in the JAX package's
``envs/mujoco/pusher.py``: a seven-joint arm pushes a cylinder to a goal on
a table. The observation is the arm's positions and velocities and the
world positions of the arm's tip, the object and the goal by forward
kinematics; the reward, on the state before the step, is minus the object's
distance from the goal, minus 0.1 times the squared action, minus half the
tip's distance from the object.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.mujoco.locomotion import MujocoFuncEnv
from gymnasium_tpu_torch.envs.mujoco.mujoco_env import MujocoEnv
from gymnasium_tpu_torch.utils.draws import uniform_map
from gymnasium_tpu_torch.utils.ezpickle import EzPickle

__all__ = ["PusherEnv", "PusherFunctional"]


class PusherEnv(MujocoEnv, EzPickle):
    """Push the object onto the goal."""

    def __init__(
        self,
        reward_near_weight: float = 0.5,
        reward_dist_weight: float = 1.0,
        reward_control_weight: float = 0.1,
        render_mode: str | None = None,
        **kwargs: Any,
    ):
        EzPickle.__init__(
            self, reward_near_weight, reward_dist_weight, reward_control_weight, render_mode, **kwargs
        )
        self._reward_near_weight = reward_near_weight
        self._reward_dist_weight = reward_dist_weight
        self._reward_control_weight = reward_control_weight
        super().__init__(
            "pusher_v5",
            frame_skip=kwargs.pop("frame_skip", 5),
            observation_space=spaces.Box(-np.inf, np.inf, (23,), np.float64),
            render_mode=render_mode,
            **kwargs,
        )
        names = self.meta["body_names"]
        self._tips_idx = names.index("tips_arm") if "tips_arm" in names else len(names) - 3
        self._obj_idx = names.index("object") if "object" in names else len(names) - 2
        self._goal_idx = names.index("goal") if "goal" in names else len(names) - 1

    def _sample_initial_state(self):
        qpos = self.init_qpos.copy()
        # the object's xy on the table, away from the goal
        while True:
            cyl_pos = np.array(
                [
                    self.np_random.uniform(low=-0.3, high=0),
                    self.np_random.uniform(low=-0.2, high=0.2),
                ]
            )
            goal_pos = np.array([0.0, 0.0])
            if np.linalg.norm(cyl_pos - goal_pos) > 0.17:
                break
        # the object's two slides follow the arm's 7 joints
        qpos[7:9] = cyl_pos
        qvel = self.init_qvel + self.np_random.uniform(-0.005, 0.005, self.model.nv)
        qvel[7:] = 0.0
        return qpos, qvel

    def _positions(self):
        return self._helper("fk")[1]

    def _get_obs(self) -> np.ndarray:
        p = self._positions()
        return np.concatenate(
            [self.qpos[:7], self.qvel[:7], p[self._tips_idx], p[self._obj_idx], p[self._goal_idx]]
        ).astype(np.float64)

    def step(self, action):
        p = self._positions()
        vec_1 = p[self._obj_idx] - p[self._tips_idx]
        vec_2 = p[self._obj_idx] - p[self._goal_idx]
        # each term carries its weight; the reward is their sum (upstream pusher_v5.py:229-233)
        reward_near = -float(np.linalg.norm(vec_1)) * self._reward_near_weight
        reward_dist = -float(np.linalg.norm(vec_2)) * self._reward_dist_weight
        reward_ctrl = -float(np.square(action).sum()) * self._reward_control_weight
        reward = reward_dist + reward_ctrl + reward_near

        self.do_simulation(action)
        if self.render_mode == "human":
            self.render()
        return (
            self._get_obs(),
            reward,
            False,
            False,
            {"reward_dist": reward_dist, "reward_ctrl": reward_ctrl, "reward_near": reward_near},
        )


class PusherFunctional(MujocoFuncEnv):
    """Push the object onto the goal."""

    model_name = "pusher_v5"
    frame_skip = 5

    def __init__(self, options: dict[str, Any] | None = None):
        super().__init__(options)
        self.observation_space = spaces.Box(-np.inf, np.inf, (23,), np.float32)
        names = self.meta["body_names"]
        self._tips_idx = names.index("tips_arm") if "tips_arm" in names else len(names) - 3
        self._obj_idx = names.index("object") if "object" in names else len(names) - 2
        self._goal_idx = names.index("goal") if "goal" in names else len(names) - 1

    def reset_values(self, ux: torch.Tensor, uy: torch.Tensor, uv: torch.Tensor) -> dict:
        """The reset state of draws ``ux``, ``uy ~ U[0, 1)`` (N,) and
        ``uv ~ U[0, 1)`` (N, nv), as the JAX ``initial`` maps them: the
        object at ``x in [-0.3, 0)``, ``y in [-0.2, 0.2)``, moved to
        ``x = -0.25`` where it lies within 0.17 of the goal; the arm's
        velocities in ``[-0.005, 0.005)`` and the object's at rest."""
        init = self.constant("init_qpos", self._init_qpos, ux.device)
        cyl_x = uniform_map(ux, -0.3, 0.0)
        cyl_y = uniform_map(uy, -0.2, 0.2)
        too_close = torch.sqrt(cyl_x**2 + cyl_y**2) <= 0.17
        cyl_x = torch.where(too_close, -0.25, cyl_x)
        qpos = init.expand(ux.shape[0], -1)
        qpos = torch.cat([qpos[:, :7], cyl_x[:, None], cyl_y[:, None], qpos[:, 9:]], dim=1)
        qvel = uniform_map(uv, -0.005, 0.005)
        qvel = torch.cat([qvel[:, :7], torch.zeros_like(qvel[:, 7:])], dim=1)
        return {"qpos": qpos, "qvel": qvel, "prev_x": qpos[:, 0]}

    def reset_draws(self, rng: torch.Generator, n: int) -> tuple:
        """The draws of ``n`` resets: U[0, 1) (n,), (n,) and (n, nv)."""
        ux = torch.rand((n,), generator=rng, device=rng.device)
        uy = torch.rand((n,), generator=rng, device=rng.device)
        uv = torch.rand((n, self.model.nv), generator=rng, device=rng.device)
        return ux, uy, uv

    def observation(self, state, rng, params: Any = None):
        _, p = self._dyn["fk"](state["qpos"])
        return torch.cat(
            [
                state["qpos"][:, :7],
                state["qvel"][:, :7],
                p[:, self._tips_idx],
                p[:, self._obj_idx],
                p[:, self._goal_idx],
            ],
            dim=1,
        )

    def reward(self, state, action, next_state, rng, params: Any = None):
        _, p = self._dyn["fk"](state["qpos"])
        reward_near = -torch.linalg.vector_norm(p[:, self._obj_idx] - p[:, self._tips_idx], dim=-1)
        reward_dist = -torch.linalg.vector_norm(p[:, self._obj_idx] - p[:, self._goal_idx], dim=-1)
        return reward_dist + 0.1 * (-torch.sum(torch.square(action), dim=-1)) + 0.5 * reward_near
