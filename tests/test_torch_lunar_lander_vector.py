"""LunarLander under ``TorchVectorEnv`` against ``JaxVectorEnv``.

Threefry and torch generators draw different numbers, so the same numpy
draws are injected into both sides: the port maps them with its own
``reset_values`` and ``transition_values``, the JAX side through
``dyn.initial_state(jnp, ...)`` and a ``transition_batched`` factory over
``dyn.full_step(jnp, ...)`` (whose solver ticks are ``world_step``). After
the reset both carries take the same state with the landers just above the
helipad, so the run passes through touchdown, crashes, truncation and the
autoresets after them, and the two must agree step for step.
"""

import jax.numpy as jnp
import numpy as np
import torch

import gymnasium_tpu.envs.dynamics.lunar_lander as L
from gymnasium_tpu.envs.box2d.lunar_lander import LunarLanderFunctional as JaxLunarLander
from gymnasium_tpu.vector.jax_vector_env import JaxVectorEnv
from gymnasium_tpu_torch.envs.box2d.lunar_lander import LunarLanderFunctional
from gymnasium_tpu_torch.envs.dynamics import lunar_lander as dyn
from gymnasium_tpu_torch.vector import TorchVectorEnv

# tests/ops/test_pallas_planar.py:107-110, the JAX kernel's test against
# world_step; the observation is the hull's row scaled by at most 1
BODY_TOL = {"rtol": 0.0, "atol": 2e-4}
IMPULSE_TOL = {"rtol": 0.0, "atol": 1e-4}
# the reward is a difference of shaping potentials of about -100 to -300
SHAPING_TOL = {"rtol": 1e-6, "atol": 1e-4}
N, STEPS, TIME_LIMIT = 8, 5, 3


class _JaxInjected(JaxLunarLander):
    """JAX LunarLander whose reset and transition take injected draws."""

    def __init__(self, reset_draws, step_draws):
        super().__init__()
        self.reset_draws = reset_draws
        self.step_draws = iter(step_draws)
        self._reset_state = None

    def initial_batched(self, rng, n, params=None):
        # every reset of the run takes the same draws: its state is made once
        if self._reset_state is None:
            tu, fu = (jnp.asarray(x) for x in self.reset_draws)
            self._reset_state = L.initial_state(jnp, tu, fu, self.get_default_params())
        return self._reset_state

    def transition_batched(self, num_envs, sharding=None):
        def step(state, action, rng, params=None):
            disp = jnp.asarray(next(self.step_draws))
            wind = jnp.zeros((num_envs, 2))
            return L.full_step(jnp, state, action, disp, wind, params or self.get_default_params(), False)

        return step


class _TorchInjected(LunarLanderFunctional):
    def __init__(self, reset_draws, step_draws):
        super().__init__()
        self.reset_draws = reset_draws
        self.step_draws = iter(step_draws)

    def initial_batched(self, rng, n, params=None):
        return self.reset_values(*(torch.from_numpy(x) for x in self.reset_draws), params)

    def transition(self, state, action, rng, params=None):
        disp = torch.from_numpy(next(self.step_draws))
        return self.transition_values(state, action, disp, None, params)


def _near_ground_state(seed):
    """Reset states lowered, legs first, to 1-15 cm above the helipad, falling
    at 0.1-1 m/s; one lane in four at 7 m/s."""
    rng = np.random.default_rng(seed)
    tu = rng.uniform(0, 1, (N, dyn.CHUNKS + 1)).astype(np.float32)
    fu = rng.uniform(-1, 1, (N, 2)).astype(np.float32)
    state = LunarLanderFunctional().reset_values(torch.from_numpy(tu), torch.from_numpy(fu))
    body = state["body"].clone()
    feet = body[:, 1:, 1] - dyn.LEG_H / dyn.SCALE * torch.cos(body[:, 1:, 2]) - dyn.LEG_W / dyn.SCALE
    gap = torch.from_numpy(rng.uniform(0.01, 0.15, N).astype(np.float32))
    body[:, :, 1] += (0.99 * dyn.HELIPAD_Y + gap - feet.amin(dim=1))[:, None]
    vy = torch.from_numpy(rng.uniform(-1.0, -0.1, N).astype(np.float32))
    vy[::4] = -7.0
    body[:, :, 3], body[:, :, 4], body[:, :, 5] = 0.0, vy[:, None], 0.0
    shaping = dyn.shaping(dyn.observe(body, state["leg1"], state["leg2"]))
    return {k: v.numpy() for k, v in dict(state, body=body, prev_shaping=shaping).items()}


def test_lunar_lander_matches_jax_vector_env_through_touchdown_and_autoreset():
    rng = np.random.default_rng(0)
    reset_draws = (
        rng.uniform(0, 1, (N, dyn.CHUNKS + 1)).astype(np.float32),
        rng.uniform(-1, 1, (N, 2)).astype(np.float32),
    )
    step_draws = [rng.uniform(-1, 1, (N, 2)).astype(np.float32) for _ in range(STEPS)]
    actions = rng.integers(0, 4, (STEPS, N)).astype(np.int32)
    jenv = JaxVectorEnv(_JaxInjected(reset_draws, step_draws), num_envs=N,
                        max_episode_steps=TIME_LIMIT, jit=False)
    tenv = TorchVectorEnv(_TorchInjected(reset_draws, step_draws), N,
                          max_episode_steps=TIME_LIMIT, device="cpu")
    jobs, _ = jenv.reset(seed=0)
    tobs, _ = tenv.reset(seed=0)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **BODY_TOL)

    start = _near_ground_state(seed=1)
    jenv.carry = jenv.carry._replace(state={k: jnp.asarray(v) for k, v in start.items()})
    tenv.carry = tenv.carry._replace(state={k: torch.from_numpy(v) for k, v in start.items()})

    touched = crashed = truncated = resets = 0
    for s in range(STEPS):
        resets += int(tenv.carry.prev_done.sum())
        jo, jr, jte, jtr, _ = jenv.step(jnp.asarray(actions[s]))
        to, tr, tte, ttr, _ = tenv.step(torch.from_numpy(actions[s]))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **BODY_TOL, err_msg=f"obs, step {s}")
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **SHAPING_TOL, err_msg=f"reward, step {s}")
        np.testing.assert_array_equal(tte.numpy(), np.asarray(jte))
        np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
        np.testing.assert_array_equal(tenv.carry.steps.numpy(), np.asarray(jenv.carry.steps))
        np.testing.assert_array_equal(tenv.carry.prev_done.numpy(), np.asarray(jenv.carry.prev_done))
        state, jstate = tenv.carry.state, jenv.carry.state
        for key in ("leg1", "leg2", "done"):
            assert state[key].dtype == torch.bool
            np.testing.assert_array_equal(state[key].numpy(), np.asarray(jstate[key]), err_msg=key)
        np.testing.assert_allclose(state["body"].numpy(), np.asarray(jstate["body"]), **BODY_TOL)
        np.testing.assert_allclose(state["jimp"].numpy(), np.asarray(jstate["jimp"]), **IMPULSE_TOL)
        np.testing.assert_allclose(state["cimp"].numpy(), np.asarray(jstate["cimp"]), **IMPULSE_TOL)
        np.testing.assert_array_equal(state["terrain"].numpy(), np.asarray(jstate["terrain"]))
        np.testing.assert_allclose(state["sleep_timer"].numpy(), np.asarray(jstate["sleep_timer"]),
                                   rtol=1e-6, atol=0.0)
        touched += int((state["leg1"] | state["leg2"]).sum())
        crashed += int((tte & (tr == -100.0)).sum())
        truncated += int(ttr.sum())
    # the run went through touchdown, crashes, the time limit and resets
    assert touched > 0 and crashed > 0 and truncated > 0 and resets > 0
