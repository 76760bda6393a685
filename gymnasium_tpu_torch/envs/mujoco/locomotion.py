"""Functional MuJoCo-class robots over the fused articulated step.

Counterpart of ``MujocoFuncEnv`` in the JAX package's
``envs/mujoco/locomotion.py``. The hooks are batch-first: ``transition`` is
one call of the fused step (:mod:`gymnasium_tpu_torch.ops.articulated_step`)
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
from gymnasium_tpu_torch.envs.mujoco.mujoco_env import load_model
from gymnasium_tpu_torch.functional import FuncEnv, tree_map
from gymnasium_tpu_torch.ops.articulated_step import fused_step
from gymnasium_tpu_torch.physics.articulated import init_qpos, make_dynamics
from gymnasium_tpu_torch.utils.draws import uniform_map

__all__ = ["MujocoFuncEnv"]


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
