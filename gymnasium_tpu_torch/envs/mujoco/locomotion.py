"""The planar locomotion host env and the functional MuJoCo-class robots.

Counterpart of the JAX package's ``envs/mujoco/locomotion.py``.
:class:`PlanarLocomotionEnv` is the host class of the robots rewarded for
their x velocity (HalfCheetah, Hopper, Walker2d, Swimmer), over
:class:`~gymnasium_tpu_torch.envs.mujoco.mujoco_env.MujocoEnv`; it computes
in float64 numpy on the state the env step reads back.

``MujocoFuncEnv``'s hooks are batch-first: ``transition`` is one call of the fused step (:mod:`gymnasium_tpu_torch.ops.articulated_step`)
over the whole batch, which is the JAX ``transition`` and
``transition_batched`` in one hook. It launches the generated CUDA kernel on
a CUDA batch and runs the plain twin on a CPU batch. Observations and rewards
that read kinematics (contact wrenches, forward kinematics, limit torques,
centres of mass) take them from the batched helpers of
:func:`~gymnasium_tpu_torch.physics.articulated.make_dynamics`, built once an
env.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.mujoco.mujoco_env import MujocoEnv, load_model
from gymnasium_tpu_torch.functional import FuncEnv, tree_map
from gymnasium_tpu_torch.ops.articulated_step import fused_step
from gymnasium_tpu_torch.physics.articulated import init_qpos, make_dynamics
from gymnasium_tpu_torch.utils.draws import uniform_map

__all__ = ["PlanarLocomotionEnv", "MujocoFuncEnv"]


class PlanarLocomotionEnv(MujocoEnv):
    """A planar robot rewarded for its x velocity: ``qpos[0]`` is the root's
    x slide."""

    # subclass configuration
    forward_reward_weight: float = 1.0
    ctrl_cost_weight: float = 0.0
    healthy_reward: float = 0.0
    terminate_when_unhealthy: bool = True
    velocity_clip: float = np.inf
    exclude_x: bool = True
    # a robot with a root z slide reports info["z_distance_from_origin"]
    # (upstream hopper_v5.py:294): the qpos index of that slide
    z_index: int | None = None
    # a robot in the xy plane (Swimmer) also reports its y position and
    # velocity and its distance from the origin (upstream swimmer_v5.py:250-262)
    report_xy: bool = False

    def control_cost(self, action) -> float:
        """Quadratic actuation cost."""
        return self.ctrl_cost_weight * float(np.sum(np.square(action)))

    def is_healthy(self) -> bool:
        """Override for termination conditions."""
        return True

    def _get_obs(self) -> np.ndarray:
        qpos = self.qpos[1:] if self.exclude_x else self.qpos
        qvel = np.clip(self.qvel, -self.velocity_clip, self.velocity_clip)
        return np.concatenate([qpos, qvel]).astype(np.float64)

    def step(self, action):
        x_before = self.qpos[0]
        y_before = self.qpos[1] if self.report_xy else 0.0
        self.do_simulation(action)
        x_after = self.qpos[0]
        x_velocity = (x_after - x_before) / self.dt

        ctrl_cost = float(self.control_cost(action))
        forward_reward = float(self.forward_reward_weight * x_velocity)
        healthy = self.is_healthy()
        healthy_reward = float(self.healthy_reward * (healthy or not self.terminate_when_unhealthy))

        # summed in upstream's grouping of its info terms (its reward-sum test)
        reward = forward_reward + healthy_reward + -ctrl_cost
        terminated = self.terminate_when_unhealthy and not healthy
        info = {
            "x_position": x_after,
            "x_velocity": x_velocity,
            "reward_forward": forward_reward,
            "reward_ctrl": -ctrl_cost,
            "reward_survive": healthy_reward,
        }
        if self.z_index is not None:
            info["z_distance_from_origin"] = float(self.qpos[self.z_index] - self.init_qpos[self.z_index])
        if self.report_xy:
            info["y_position"] = float(self.qpos[1])
            info["y_velocity"] = float((self.qpos[1] - y_before) / self.dt)
            info["distance_from_origin"] = float(np.linalg.norm(self.qpos[0:2] - self.init_qpos[0:2]))
        if self.render_mode == "human":
            self.render()
        return self._get_obs(), reward, terminated, False, info

    def _reset_info(self):
        # upstream's v5 reset info: the step info's position keys at the reset state
        info = {"x_position": self.qpos[0]}
        if self.z_index is not None:
            info["z_distance_from_origin"] = self.qpos[self.z_index] - self.init_qpos[self.z_index]
        if self.report_xy:
            info["y_position"] = self.qpos[1]
            info["distance_from_origin"] = np.linalg.norm(self.qpos[0:2] - self.init_qpos[0:2])
        return info


class MujocoFuncEnv(FuncEnv):
    """A compiled robot model as a batch-first functional env.

    State: ``{"qpos" (N, nq), "qvel" (N, nv), "prev_x" (N,)}``, float32.
    Subclasses set the model name, ``frame_skip``, the observation space and
    the reward.
    """

    model_name: str = ""
    frame_skip: int = 5
    reset_noise_scale: float = 0.1

    def __init__(self, options: dict[str, Any] | None = None):
        options = dict(options or {})
        self.reset_noise_scale = options.pop("reset_noise_scale", self.reset_noise_scale)
        super().__init__(options)
        self.model, self.meta = load_model(self.model_name)
        self._init_qpos = init_qpos(self.model)
        self._step = fused_step(self.model_name, self.frame_skip)
        self._dyn = make_dynamics(self.model)
        self._constants: dict = {}
        self.action_space = spaces.Box(
            low=np.asarray(self.model.act_ctrlrange[:, 0], dtype=np.float32),
            high=np.asarray(self.model.act_ctrlrange[:, 1], dtype=np.float32),
        )

    @property
    def dt(self) -> float:
        return self.model.timestep * self.frame_skip

    def constant(self, name: str, value, device: torch.device) -> torch.Tensor:
        """``value`` as a float32 tensor on ``device``, copied there once:
        a copy from the host at every step would wait for the card."""
        key = (name, device)
        if key not in self._constants:
            self._constants[key] = torch.as_tensor(np.asarray(value, np.float32), device=device)
        return self._constants[key]

    def reset_values(self, u: torch.Tensor, z: torch.Tensor) -> dict:
        """The reset state of draws ``u ~ U[0, 1)`` (N, nq) and ``z ~ N(0, 1)``
        (N, nv), as the JAX ``initial`` maps its uniform and normal draws."""
        noise = self.reset_noise_scale
        init = self.constant("init_qpos", self._init_qpos, u.device)
        qpos = init + uniform_map(u, -noise, noise)
        if self.model.root_free:
            # noise lands on the raw quaternion; renormalise it
            quat = qpos[:, 3:7]
            norm = torch.sqrt(
                quat[:, 0] * quat[:, 0]
                + quat[:, 1] * quat[:, 1]
                + quat[:, 2] * quat[:, 2]
                + quat[:, 3] * quat[:, 3]
                + 1e-24
            )
            qpos = torch.cat([qpos[:, :3], quat / norm[:, None], qpos[:, 7:]], dim=1)
        return {"qpos": qpos, "qvel": noise * z, "prev_x": qpos[:, 0]}

    def initial(self, rng: torch.Generator, params: Any = None):
        return tree_map(lambda x: x[0], self.initial_batched(rng, 1, params))

    def reset_draws(self, rng: torch.Generator, n: int) -> tuple:
        """The draws of ``n`` resets that :meth:`reset_values` maps: U[0, 1)
        (n, nq) and N(0, 1) (n, nv)."""
        u = torch.rand((n, self.model.nq), generator=rng, device=rng.device)
        z = torch.randn((n, self.model.nv), generator=rng, device=rng.device)
        return u, z

    def initial_batched(self, rng: torch.Generator, n: int, params: Any = None):
        return self.reset_values(*self.reset_draws(rng, n))

    def transition(self, state, action, rng, params: Any = None):
        q, qd = self._step(state["qpos"], state["qvel"], action)
        return {"qpos": q, "qvel": qd, "prev_x": state["qpos"][:, 0]}

    def observation(self, state, rng, params: Any = None):
        return torch.cat([state["qpos"][:, 1:], state["qvel"]], dim=1)

    def terminal(self, state, rng, params: Any = None):
        qpos = state["qpos"]
        return torch.zeros(qpos.shape[0], dtype=torch.bool, device=qpos.device)
