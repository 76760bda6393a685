"""The port's host ``CarRacing`` class against the JAX package's, through
``make("CarRacing-v3")``. JAX's class is plain numpy in float64 and calls no
JAX; the port's is the same code over the port's ``Env``, spaces, canvas and
``Car``, so every output is equal bit for bit: the reset and 30 steps
(observations, rewards, flags, ``info``), the generators, and an
``rgb_array`` frame."""

import numpy as np
import pytest

import gymnasium_tpu as jgym
import gymnasium_tpu_torch as gym
from gymnasium_tpu.envs.box2d import car_dynamics as jcd
from gymnasium_tpu_torch import error
from gymnasium_tpu_torch.envs.box2d import car_dynamics as cd
from tests.torch_compare import assert_same_space

STEPS = 30
FORMS = {
    "continuous": {},
    "discrete": {"continuous": False},
    "domain_randomize": {"domain_randomize": True},
}


def actions(env, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if env.unwrapped.continuous:
        steer = rng.uniform(-1, 1, n)
        # mostly gas, some braking, so the car moves and the wheels lock
        return [np.array([s, g, b], np.float32)
                for s, g, b in zip(steer, rng.uniform(0.3, 1, n), rng.uniform(0, 1, n) * (rng.uniform(size=n) < 0.2))]
    return [int(a) for a in rng.choice([0, 1, 2, 3, 3, 3, 4], n)]


@pytest.mark.parametrize("form", sorted(FORMS))
def test_reset_and_steps_equal_jax_bit_for_bit(form):
    port, jax_env = gym.make("CarRacing-v3", **FORMS[form]), jgym.make("CarRacing-v3", **FORMS[form])
    assert_same_space(port.action_space, jax_env.action_space)
    assert_same_space(port.observation_space, jax_env.observation_space)
    got, want = port.reset(seed=8), jax_env.reset(seed=8)
    assert got[0].dtype == want[0].dtype == np.uint8 and np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert np.array_equal(port.unwrapped.road_color, jax_env.unwrapped.road_color)
    moved = 0.0
    for i, action in enumerate(actions(port, STEPS, seed=8)):
        got, want = port.step(action), jax_env.step(action)
        assert np.array_equal(got[0], want[0]), f"step {i} obs"
        assert type(got[1]) is type(want[1]) and got[1] == want[1], f"step {i} reward"
        assert got[2:] == want[2:], f"step {i} flags or info"
        assert np.array_equal(port.unwrapped.car.hull, jax_env.unwrapped.car.hull)
        moved = port.unwrapped.car.speed
    assert moved > 0.0
    assert port.unwrapped.tile_visited_count == jax_env.unwrapped.tile_visited_count > 0
    assert port.unwrapped.np_random.bit_generator.state == jax_env.unwrapped.np_random.bit_generator.state


def test_frame_equals_jax():
    port = gym.make("CarRacing-v3", render_mode="rgb_array")
    jax_env = jgym.make("CarRacing-v3", render_mode="rgb_array")
    port.reset(seed=1)
    jax_env.reset(seed=1)
    for action in actions(port, 5, seed=1):
        port.step(action)
        jax_env.step(action)
    got, want = port.render(), jax_env.render()
    assert got.shape == (400, 600, 3) and got.dtype == np.uint8 and np.array_equal(got, want)


def test_invalid_discrete_action_raises_as_jax():
    port, jax_env = gym.make("CarRacing-v3", continuous=False), jgym.make("CarRacing-v3", continuous=False)
    port.reset(seed=0)
    jax_env.reset(seed=0)
    with pytest.raises(error.InvalidAction) as got:
        port.unwrapped.step(7)
    with pytest.raises(jgym.error.InvalidAction) as want:
        jax_env.unwrapped.step(7)
    assert str(got.value) == str(want.value)


def test_car_steps_as_jax_and_keeps_the_constants():
    assert (cd.CAR_MASS, cd.CAR_COM, cd.CAR_INERTIA, cd.WHEEL_W) == (jcd.CAR_MASS, jcd.CAR_COM, jcd.CAR_INERTIA,
                                                                     jcd.WHEEL_W)
    car, jcar = cd.Car(0.3, 1.0, -2.0), jcd.Car(0.3, 1.0, -2.0)
    for i in range(40):
        for c in (car, jcar):
            c.steer(np.sin(i / 5))
            c.gas(0.8)
            c.brake(0.95 if i == 30 else 0.1 * (i % 3 == 0))
            c.step(1 / 50, lambda x, y: x > 0.5)
        assert np.array_equal(car.hull, jcar.hull) and np.array_equal(car.wheel_omega, jcar.wheel_omega)
    assert np.array_equal(car.wheel_positions(), jcar.wheel_positions()) and car.speed == jcar.speed > 0
