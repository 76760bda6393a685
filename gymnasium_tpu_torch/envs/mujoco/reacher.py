"""Reacher-v5: its host env and its batch-first functional env.

Counterpart of ``ReacherEnv`` (the host class behind ``make``) and
``ReacherFunctional`` in the JAX package's
``envs/mujoco/reacher.py``: a two-link arm reaches for a target in the
plane. The observation reads the fingertip and the target by forward
kinematics; the reward, on the state before the step, is minus the
fingertip's distance from the target minus the squared action.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.mujoco.locomotion import MujocoFuncEnv
from gymnasium_tpu_torch.envs.mujoco.mujoco_env import MujocoEnv
from gymnasium_tpu_torch.utils.draws import uniform_map
from gymnasium_tpu_torch.utils.ezpickle import EzPickle

__all__ = ["ReacherEnv", "ReacherFunctional"]


class ReacherEnv(MujocoEnv, EzPickle):
    """Move the arm's fingertip onto the target."""

    def __init__(
        self,
        reward_dist_weight: float = 1.0,
        reward_control_weight: float = 1.0,
        render_mode: str | None = None,
        **kwargs: Any,
    ):
        EzPickle.__init__(self, reward_dist_weight, reward_control_weight, render_mode, **kwargs)
        self._reward_dist_weight = reward_dist_weight
        self._reward_control_weight = reward_control_weight
        super().__init__(
            "reacher",
            frame_skip=kwargs.pop("frame_skip", 2),
            observation_space=spaces.Box(-np.inf, np.inf, (10,), np.float64),
            render_mode=render_mode,
            **kwargs,
        )
        self._fingertip_idx = self.body_index("fingertip")
        self._target_idx = self.body_index("target")

    def _sample_initial_state(self):
        qpos = self.init_qpos + self.np_random.uniform(-0.1, 0.1, self.model.nv)
        while True:
            goal = self.np_random.uniform(low=-0.2, high=0.2, size=2)
            if np.linalg.norm(goal) < 0.2:
                break
        qpos[2:4] = goal  # the target's slides (absolute)
        qvel = self.init_qvel + self.np_random.uniform(-0.005, 0.005, self.model.nv)
        qvel[2:4] = 0.0
        self.goal = goal
        return qpos, qvel

    def _body_positions(self):
        return self._helper("fk")[1]

    def _get_obs(self) -> np.ndarray:
        p = self._body_positions()
        theta = self.qpos[:2]
        vec = p[self._fingertip_idx] - p[self._target_idx]
        return np.concatenate(
            [np.cos(theta), np.sin(theta), self.qpos[2:4], self.qvel[:2], vec[:2]]
        ).astype(np.float64)

    def step(self, action):
        p = self._body_positions()
        vec = p[self._fingertip_idx] - p[self._target_idx]
        reward_dist = -float(np.linalg.norm(vec)) * self._reward_dist_weight
        reward_ctrl = -float(np.square(action).sum()) * self._reward_control_weight
        reward = reward_dist + reward_ctrl

        self.do_simulation(action)
        if self.render_mode == "human":
            self.render()
        return self._get_obs(), reward, False, False, {"reward_dist": reward_dist, "reward_ctrl": reward_ctrl}


class ReacherFunctional(MujocoFuncEnv):
    """Move the fingertip onto the target."""

    model_name = "reacher"
    frame_skip = 2

    def __init__(self, options: dict[str, Any] | None = None):
        super().__init__(options)
        self.observation_space = spaces.Box(-np.inf, np.inf, (10,), np.float32)
        self._fingertip_idx = self.meta["body_names"].index("fingertip")
        self._target_idx = self.meta["body_names"].index("target")

    def reset_values(self, u: torch.Tensor, r_u: torch.Tensor, th_u: torch.Tensor) -> dict:
        """The reset state of draws ``u ~ U[0, 1)`` (N, nv) and ``r_u``,
        ``th_u ~ U[0, 1)`` (N,), as the JAX ``initial`` maps them. JAX draws
        the position noise and the velocity from one key with one shape, so
        both are the same uniforms: one ``u`` feeds both here too. The target
        lies at radius ``0.2 sqrt(r_u)`` and angle ``2 pi th_u``."""
        init = self.constant("init_qpos", self._init_qpos, u.device)
        qpos = init + uniform_map(u, -0.1, 0.1)
        r = 0.2 * torch.sqrt(r_u)
        th = uniform_map(th_u, 0.0, 2 * math.pi)
        qpos = torch.cat([qpos[:, :2], (r * torch.cos(th))[:, None], (r * torch.sin(th))[:, None]], dim=1)
        qvel = uniform_map(u, -0.005, 0.005)
        qvel = torch.cat([qvel[:, :2], torch.zeros_like(qvel[:, 2:4])], dim=1)
        return {"qpos": qpos, "qvel": qvel, "prev_x": qpos[:, 0]}

    def reset_draws(self, rng: torch.Generator, n: int) -> tuple:
        """The draws of ``n`` resets: U[0, 1) (n, nv), (n,) and (n,)."""
        u = torch.rand((n, self.model.nv), generator=rng, device=rng.device)
        r_u = torch.rand((n,), generator=rng, device=rng.device)
        th_u = torch.rand((n,), generator=rng, device=rng.device)
        return u, r_u, th_u

    def _vec(self, state):
        _, p = self._dyn["fk"](state["qpos"])
        return p[:, self._fingertip_idx] - p[:, self._target_idx]

    def observation(self, state, rng, params: Any = None):
        theta = state["qpos"][:, :2]
        vec = self._vec(state)
        return torch.cat(
            [torch.cos(theta), torch.sin(theta), state["qpos"][:, 2:4], state["qvel"][:, :2], vec[:, :2]],
            dim=1,
        )

    def reward(self, state, action, next_state, rng, params: Any = None):
        vec = self._vec(state)
        return -torch.linalg.vector_norm(vec, dim=-1) - torch.sum(torch.square(action), dim=-1)
