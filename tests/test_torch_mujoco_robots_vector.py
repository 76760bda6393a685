"""The new MuJoCo-class robots of the port through ``TorchVectorEnv``
against the JAX functionals through ``JaxVectorEnv``, across autoresets
(Humanoid and HumanoidStandup, whose JAX hooks take the longest to compile,
each in a file of its own: ``tests/test_torch_mujoco_humanoid*_vector.py``).

Threefry and torch generators draw different numbers, so both sides reset to
the same states: the port's ``reset_values`` of numpy draws, which
``tests/test_torch_mujoco_robots.py`` holds to JAX's own ``initial``. Then
every step takes the same actions on both sides, and the states must agree
within the engine tolerance of ``tests/test_torch_mujoco.py`` (``Q_TOL``,
``QD_TOL``: the JAX kernel test's); the step counters and the flags are
equal; the observations and rewards agree within ``QD_TOL``, the looser
of the two (they hold velocities and contact forces). The JAX hooks run
jitted on the CPU (``transition_batched`` gives no kernel there, so JAX steps
``make_dynamics``); the port runs the articulated twin and launches nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu.vector.jax_vector_env import JaxVectorEnv
from gymnasium_tpu_torch.ops import articulated_step
from gymnasium_tpu_torch.vector import TorchVectorEnv
from tests.test_torch_mujoco import Q_TOL, QD_TOL
from tests.test_torch_mujoco_robots import ROBOTS

N, STEPS, TIME_LIMIT = 8, 8, 3


def _reset_states(robot, func, count, seed=0):
    """``count`` batches of reset states, from numpy draws through the
    port's ``reset_values``, as numpy."""
    rng = np.random.default_rng(seed)
    nq, nv = func.model.nq, func.model.nv

    def u(*shape):
        return torch.from_numpy(rng.uniform(0.0, 1.0, (N, *shape)).astype(np.float32))

    out = []
    for _ in range(count):
        if robot == "reacher":
            draws = (u(nv), u(), u())
        elif robot == "pusher":
            draws = (u(), u(), u(nv))
        else:
            draws = (u(nq), torch.from_numpy(rng.standard_normal((N, nv)).astype(np.float32)))
        out.append({k: v.numpy() for k, v in func.reset_values(*draws).items()})
    return out


def _injected(cls, resets, to_array, jit=False):
    """``cls`` whose batched reset returns the given states, in order."""

    class Injected(cls):
        def __init__(self):
            super().__init__()
            self.resets = iter(resets)
            if jit:  # the env runs eagerly to take a new reset each step; its hooks compile once
                for hook in ("transition", "observation", "reward", "terminal"):
                    setattr(self, hook, jax.jit(getattr(super(), hook)))

        def initial_batched(self, rng, n, params=None):
            return {k: to_array(v) for k, v in next(self.resets).items()}

    return Injected()


def run_against_jax(request, robot):
    port_cls, jax_cls, _ = ROBOTS[robot]
    resets = _reset_states(robot, port_cls(), STEPS + 1)
    tenv = TorchVectorEnv(_injected(port_cls, resets, torch.from_numpy), N, max_episode_steps=TIME_LIMIT,
                          device="cpu")
    jenv = JaxVectorEnv(_injected(jax_cls, resets, jnp.asarray, jit=True), num_envs=N,
                        max_episode_steps=TIME_LIMIT, jit=False)
    tobs, _ = tenv.reset(seed=0)
    jobs, _ = jenv.reset(seed=0)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **QD_TOL)
    model = tenv.func_env.model
    lo, hi = model.act_ctrlrange[:, 0], model.act_ctrlrange[:, 1]
    actions = np.random.default_rng(1).uniform(lo, hi, (STEPS, N, model.nu)).astype(np.float32)
    before = dict(articulated_step.launches)
    worst = dict.fromkeys(("qpos", "qvel", "obs", "reward"), 0.0)
    truncations = 0
    for s in range(STEPS):
        jo, jr, jte, jtr, _ = jenv.step(jnp.asarray(actions[s]))
        to, tr, tte, ttr, _ = tenv.step(torch.from_numpy(actions[s]))
        state, jstate = tenv.carry.state, jenv.carry.state
        for key, got, want, tol in (("qpos", state["qpos"], jstate["qpos"], Q_TOL),
                                    ("qvel", state["qvel"], jstate["qvel"], QD_TOL),
                                    ("obs", to, jo, QD_TOL), ("reward", tr, jr, QD_TOL)):
            got, want = got.numpy(), np.asarray(want)
            np.testing.assert_allclose(got, want, **tol, err_msg=f"step {s} {key}")
            worst[key] = max(worst[key], float(np.abs(got - want).max()))
        np.testing.assert_array_equal(tte.numpy(), np.asarray(jte))
        np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
        np.testing.assert_array_equal(tenv.carry.steps.numpy(), np.asarray(jenv.carry.steps))
        np.testing.assert_array_equal(tenv.carry.prev_done.numpy(), np.asarray(jenv.carry.prev_done))
        truncations += int(ttr.sum())
    for key, value in worst.items():
        request.node.user_properties.append((f"max_abs_d{key}", value))
    assert truncations > 0
    assert articulated_step.launches == before


@pytest.mark.parametrize("robot", ["ant", "hopper", "inverted_double_pendulum", "inverted_pendulum", "pusher",
                                   "reacher", "walker2d"])
def test_vector_env_matches_jax_across_autoresets(request, robot):
    run_against_jax(request, robot)
