"""The port's MuJoCo-class robots against the JAX package's functionals.

For Ant, Hopper, Walker2d, InvertedPendulum, InvertedDoublePendulum,
Reacher, Pusher, Humanoid and HumanoidStandup:

- ``observation``, ``reward`` and ``terminal`` on the same numpy states, the
  JAX hooks vmapped and jitted on the CPU. Tolerance ``1e-5 * max |JAX| +
  1e-6`` an output, that of the kinematics helpers they read
  (``tests/test_torch_mujoco_kinematics.py``); the flags are equal;
- the reset: JAX's own ``initial`` on a batch of keys, against the port's
  ``reset_values`` fed the uniforms and normals that ``initial`` draws from
  those keys (recomputed from the same key splits). Reacher's position noise
  and velocity come from one key and one shape in JAX, so they are the same
  uniforms; Pusher moves an object that lies within 0.17 of the goal.
"""

import jax
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.mujoco import ant as jax_ant
from gymnasium_tpu.envs.mujoco import hopper as jax_hopper
from gymnasium_tpu.envs.mujoco import humanoid as jax_humanoid
from gymnasium_tpu.envs.mujoco import humanoid_standup as jax_humanoid_standup
from gymnasium_tpu.envs.mujoco import inverted_double_pendulum as jax_idp
from gymnasium_tpu.envs.mujoco import inverted_pendulum as jax_ip
from gymnasium_tpu.envs.mujoco import pusher as jax_pusher
from gymnasium_tpu.envs.mujoco import reacher as jax_reacher
from gymnasium_tpu.envs.mujoco import walker2d as jax_walker2d
from gymnasium_tpu_torch.envs import mujoco as port
from tests.test_torch_mujoco_kinematics import assert_close, states

N = 16
# robot: (port class, JAX class, (qpos index of the root's height, how far every other lane is lowered))
ROBOTS = {
    "ant": (port.AntFunctional, jax_ant.AntFunctional, (2, 0.3)),
    "hopper": (port.HopperFunctional, jax_hopper.HopperFunctional, (1, 0.1)),
    "walker2d": (port.Walker2dFunctional, jax_walker2d.Walker2dFunctional, (1, 0.1)),
    "inverted_pendulum": (port.InvertedPendulumFunctional, jax_ip.InvertedPendulumFunctional, (None, 0.0)),
    "inverted_double_pendulum": (
        port.InvertedDoublePendulumFunctional, jax_idp.InvertedDoublePendulumFunctional, (None, 0.0)),
    "reacher": (port.ReacherFunctional, jax_reacher.ReacherFunctional, (None, 0.0)),
    "pusher": (port.PusherFunctional, jax_pusher.PusherFunctional, (None, 0.0)),
    "humanoid": (port.HumanoidFunctional, jax_humanoid.HumanoidFunctional, (2, 0.9)),
    "humanoid_standup": (
        port.HumanoidStandupFunctional, jax_humanoid_standup.HumanoidStandupFunctional, (None, 0.0)),
}
OBS_DIMS = {"ant": 105, "hopper": 11, "walker2d": 17, "inverted_pendulum": 4, "inverted_double_pendulum": 9,
            "reacher": 10, "pusher": 23, "humanoid": 348, "humanoid_standup": 348}
FRAME_SKIPS = {"ant": 5, "hopper": 4, "walker2d": 4, "inverted_pendulum": 2, "inverted_double_pendulum": 5,
               "reacher": 2, "pusher": 5, "humanoid": 5, "humanoid_standup": 5}


def _state(q, qd, prev_x):
    return {"qpos": q, "qvel": qd, "prev_x": prev_x}


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_hooks_match_jax(robot):
    port_cls, jax_cls, lower = ROBOTS[robot]
    func, jfunc = port_cls(), jax_cls()
    model = func.model
    q, qd = states(model, N, seed=1, lower=lower)
    nq, nqd = states(model, N, seed=2, lower=lower)
    rng = np.random.default_rng(3)
    lo, hi = model.act_ctrlrange[:, 0], model.act_ctrlrange[:, 1]
    action = rng.uniform(lo, hi, (N, model.nu)).astype(np.float32)
    tq, tqd = q.copy(), qd.copy()
    tqd[0, 0] = np.nan  # a non-finite lane for the terminal tests
    state, next_state, term_state = _state(q, qd, q[:, 0]), _state(nq, nqd, q[:, 0]), _state(tq, tqd, tq[:, 0])

    def hooks(s, a, ns, ts):
        return jfunc.observation(s, None), jfunc.reward(s, a, ns, None), jfunc.terminal(ts, None)

    want = [np.asarray(x) for x in jax.jit(jax.vmap(hooks))(state, action, next_state, term_state)]
    as_torch = lambda s: {k: torch.from_numpy(np.asarray(v)) for k, v in s.items()}  # noqa: E731
    got = [
        func.observation(as_torch(state), None),
        func.reward(as_torch(state), torch.from_numpy(action), as_torch(next_state), None),
        func.terminal(as_torch(term_state), None),
    ]
    assert got[0].shape == (N, OBS_DIMS[robot]) == (N, *func.observation_space.shape)
    assert got[0].dtype == got[1].dtype == torch.float32 and func.observation_space.dtype == np.float32
    assert_close(got[0].numpy(), want[0], f"{robot} observation")
    assert_close(got[1].numpy(), want[1], f"{robot} reward")
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert func.frame_skip == jfunc.frame_skip == FRAME_SKIPS[robot]
    assert func.reset_noise_scale == jfunc.reset_noise_scale and func.dt == jfunc.dt


def _jax_initial(robot, jfunc, keys):
    """JAX's ``initial`` on each key, and the draws it takes from the key
    (recomputed from the same splits), as numpy."""
    nq, nv = jfunc.model.nq, jfunc.model.nv

    def draws(key):
        if robot == "reacher":
            k1, k2, k3 = jax.random.split(key, 3)
            return jax.random.uniform(k1, (nv,)), jax.random.uniform(k2, ()), jax.random.uniform(k3, ())
        if robot == "pusher":
            k1, k2, k3 = jax.random.split(key, 3)
            return jax.random.uniform(k1, ()), jax.random.uniform(k2, ()), jax.random.uniform(k3, (nv,))
        k1, k2 = jax.random.split(key)
        return jax.random.uniform(k1, (nq,)), jax.random.normal(k2, (nv,))

    state, drawn = jax.jit(jax.vmap(lambda k: (jfunc.initial(k), draws(k))))(keys)
    return {k: np.asarray(v) for k, v in state.items()}, [torch.from_numpy(np.array(x)) for x in drawn]


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_reset_matches_jax_initial(robot):
    port_cls, jax_cls, _ = ROBOTS[robot]
    func = port_cls()
    want, drawn = _jax_initial(robot, jax_cls(), jax.random.split(jax.random.PRNGKey(7), 64))
    got = func.reset_values(*drawn)
    for key in ("qpos", "qvel", "prev_x"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0, atol=1e-6, err_msg=key)


def test_reacher_reset_shares_one_draw_between_position_and_velocity():
    """Known reference result: JAX draws the position noise and the velocity
    from the same key with the same shape, so the velocity is the position
    noise rescaled, ``qvel = (qpos - init) / 20`` on the arm's joints."""
    func = port.ReacherFunctional()
    want, drawn = _jax_initial("reacher", jax_reacher.ReacherFunctional(), jax.random.split(jax.random.PRNGKey(3), 32))
    got = func.reset_values(*drawn)
    init = func._init_qpos[:2].astype(np.float32)
    for state in (want, {k: v.numpy() for k, v in got.items()}):
        np.testing.assert_allclose(state["qvel"][:, :2], (state["qpos"][:, :2] - init) / 20, atol=1e-8)
        np.testing.assert_array_equal(state["qvel"][:, 2:], 0.0)
        assert np.linalg.norm(state["qpos"][:, 2:4], axis=1).max() <= 0.2


def test_pusher_reset_moves_an_object_too_close_to_the_goal():
    func = port.PusherFunctional()
    rng = np.random.default_rng(5)
    ux, uy = (torch.from_numpy(rng.uniform(0, 1, 256).astype(np.float32)) for _ in range(2))
    uv = torch.from_numpy(rng.uniform(0, 1, (256, func.model.nv)).astype(np.float32))
    state = func.reset_values(ux, uy, uv)
    cyl_x, cyl_y = -0.3 + 0.3 * ux.double(), -0.2 + 0.4 * uy.double()
    close = torch.sqrt(cyl_x**2 + cyl_y**2) <= 0.17
    assert 0 < int(close.sum()) < 256
    assert (state["qpos"][close, 7] == -0.25).all()
    assert torch.allclose(state["qpos"][~close, 7].double(), cyl_x[~close], atol=1e-6)
    assert torch.allclose(state["qpos"][:, 8].double(), cyl_y, atol=1e-6)
    assert (state["qvel"][:, 7:] == 0).all() and state["qvel"][:, :7].abs().max() <= 0.005
    init = torch.as_tensor(func._init_qpos, dtype=torch.float32)
    assert torch.equal(state["qpos"][:, :7], init[:7].expand(256, 7))
