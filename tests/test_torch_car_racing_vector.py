"""CarRacing through ``TorchVectorEnv`` against ``JaxVectorEnv``, across autoresets.

Eight envs take 30 steps with a step limit of 10, in both action modes.
Threefry and torch generators draw different numbers, so both sides reset to
the same states: the port's ``reset_values`` of numpy draws (which
``tests/test_torch_car_racing.py`` holds to JAX's own ``initial``), with
lane 0 of every reset put at the playfield's edge, heading out, so that it
leaves the field and terminates. The JAX hooks are jitted on the instance
and the vector env runs eagerly.

At every step the flags, step counters, visits and rewards are equal; hull,
wheels and steering agree within ``1e-5 * max |JAX| + 1e-6``; the
observations are equal but at pixels within ``EDGE_MARGIN`` of a road edge or
a checker line of the port's state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.box2d.car_racing_functional import CarRacingFunctional as JaxCarRacing
from gymnasium_tpu.vector.jax_vector_env import JaxVectorEnv
from gymnasium_tpu_torch.envs.box2d.car_racing_functional import PLAYFIELD, CarRacingFunctional
from gymnasium_tpu_torch.vector import TorchVectorEnv
from tests.test_torch_mujoco_kinematics import assert_close

N, STEPS, TIME_LIMIT = 8, 30, 10


def reset_batches(count, seed=0):
    rng = np.random.default_rng(seed)
    func = CarRacingFunctional()
    out = []
    for _ in range(count):
        u = torch.from_numpy(rng.uniform(0.0, 1.0, (N, 2, 12)).astype(np.float32))
        s = {k: v.numpy().copy() for k, v in func.reset_values(u).items()}
        s["hull"][0, :2] = (PLAYFIELD - 0.5, 0.0)
        s["hull"][0, 3] = 40.0
        out.append(s)
    return out


def injected(cls, options, resets, to_array, jit=False):
    class Injected(cls):
        def __init__(self):
            super().__init__(dict(options))
            self.resets = iter(resets)
            if jit:
                for hook in ("transition", "observation", "reward", "terminal"):
                    setattr(self, hook, jax.jit(getattr(super(), hook)))

        def initial_batched(self, rng, n, params=None):
            return {k: to_array(v) for k, v in next(self.resets).items()}

    return Injected()


@pytest.mark.parametrize("mode", ["continuous", "discrete"])
def test_vector_env_matches_jax_across_autoresets(request, mode):
    options = {"continuous": mode == "continuous"}
    resets = reset_batches(STEPS + 1)
    tenv = TorchVectorEnv(injected(CarRacingFunctional, options, resets, torch.from_numpy), N,
                          max_episode_steps=TIME_LIMIT, device="cpu")
    jenv = JaxVectorEnv(injected(JaxCarRacing, options, resets, jnp.asarray, jit=True), num_envs=N,
                        max_episode_steps=TIME_LIMIT, jit=False)
    tobs, _ = tenv.reset(seed=0)
    jobs, _ = jenv.reset(seed=0)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    rng = np.random.default_rng(1)
    if mode == "continuous":
        acts = np.stack([rng.uniform(-1, 1, (STEPS, N)), rng.uniform(0, 1, (STEPS, N)),
                         rng.uniform(0, 1, (STEPS, N)) ** 4], axis=-1).astype(np.float32)
    else:
        acts = rng.integers(0, 5, (STEPS, N)).astype(np.int32)
    ends = {"terminated": 0, "truncated": 0}
    edge_share, differ = 0.0, 0
    for s in range(STEPS):
        jo, jr, jte, jtr, _ = jenv.step(jnp.asarray(acts[s]))
        to, tr, tte, ttr, _ = tenv.step(torch.from_numpy(acts[s]))
        state, jstate = tenv.carry.state, jenv.carry.state
        for key in ("hull", "steer_angle", "wheel_omega"):
            assert_close(state[key].numpy(), np.asarray(jstate[key]), f"step {s} {key}")
        for key in ("visited", "done"):
            np.testing.assert_array_equal(state[key].numpy(), np.asarray(jstate[key]), err_msg=f"step {s} {key}")
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr), err_msg=f"step {s} reward")
        np.testing.assert_array_equal(tte.numpy(), np.asarray(jte))
        np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
        np.testing.assert_array_equal(tenv.carry.steps.numpy(), np.asarray(jenv.carry.steps))
        np.testing.assert_array_equal(tenv.carry.prev_done.numpy(), np.asarray(jenv.carry.prev_done))
        assert to.dtype == torch.uint8 and to.shape == (N, 96, 96, 3)
        edge = tenv.func_env.edge_pixels(state).numpy()
        mismatch = (to.numpy() != np.asarray(jo)).any(-1)
        assert not (mismatch & ~edge).any(), f"step {s}: {int((mismatch & ~edge).sum())} pixels differ off an edge"
        edge_share, differ = max(edge_share, float(edge.mean())), differ + int(mismatch.sum())
        ends["terminated"] += int(tte.sum())
        ends["truncated"] += int(ttr.sum())
    request.node.user_properties.append(("max_edge_pixel_share", edge_share))
    request.node.user_properties.append(("differing_pixels", differ))
    assert ends["terminated"] > 0 and ends["truncated"] > 0, ends
