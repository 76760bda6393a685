"""The render hooks of the port's four functionals and its six named
adapter classes, against the JAX package's.

For ``phys2d/CartPole-v1``, ``phys2d/Pendulum-v0``,
``tabular/CliffWalking-v0`` and ``tabular/Blackjack-v0``, the port's
``make(id, render_mode="rgb_array", device="cpu")`` renders the frame that
JAX's ``render_image`` draws from the same state (the port env's state
handed to JAX as device arrays), equal in every bit, after ``reset(seed=0)``
and after each of 3 steps. The frames have JAX's shapes. Each named class
(``CartPoleTorchEnv``, ``CartPoleTorchVectorEnv``, ``PendulumTorchEnv``,
``PendulumTorchVectorEnv``, ``CliffWalkingTorchEnv``, ``BlackJackTorchEnv``)
carries its JAX class's metadata with ``"torch"`` for ``"jax"``, and takes a
reset and a step on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gymnasium_tpu.envs.phys2d as jphys2d
import gymnasium_tpu.envs.tabular as jtabular
import gymnasium_tpu_torch as gym
import gymnasium_tpu_torch.envs.phys2d as phys2d
import gymnasium_tpu_torch.envs.tabular as tabular
from gymnasium_tpu.envs.phys2d.cartpole import CartPoleFunctional, CartPoleJaxVectorEnv
from gymnasium_tpu.envs.phys2d.pendulum import PendulumFunctional, PendulumJaxVectorEnv
from gymnasium_tpu.envs.tabular.blackjack import BlackjackFunctional
from gymnasium_tpu.envs.tabular.cliffwalking import CliffWalkingFunctional
from gymnasium_tpu_torch.functional import tree_map
from tests.torch_compare import assert_identical

# id -> (JAX functional, frame shape, actions)
RENDERED = {
    "phys2d/CartPole-v1": (CartPoleFunctional, (400, 600, 3), [0, 1, 1]),
    "phys2d/Pendulum-v0": (PendulumFunctional, (500, 500, 3), [np.array([1.5], np.float32)] * 3),
    "tabular/CliffWalking-v0": (CliffWalkingFunctional, (160, 480, 3), [0, 1, 2]),
    "tabular/Blackjack-v0": (BlackjackFunctional, (160, 240, 3), [1, 1, 0]),
}


def jax_frame(func, state) -> np.ndarray:
    """JAX's hook on the port env's ``state``."""
    jax_state = tree_map(lambda leaf: jnp.asarray(leaf.numpy()), state)
    render_state, frame = func.render_image(jax_state, func.render_init())
    func.render_close(render_state)
    return frame


@pytest.mark.parametrize("env_id", sorted(RENDERED))
def test_frame_equals_jax_hook_on_the_same_state(env_id):
    cls, shape, actions = RENDERED[env_id]
    env = gym.make(env_id, render_mode="rgb_array", device="cpu")
    assert env.metadata["render_modes"] == ["rgb_array"]
    func = cls()
    env.reset(seed=0)
    for k in range(len(actions) + 1):
        frame = env.render()
        assert frame.shape == shape and frame.dtype == np.uint8, env_id
        assert_identical(frame, jax_frame(func, env.unwrapped.state), f"{env_id} after {k} steps")
        if k < len(actions):
            env.step(actions[k])
    env.close()


# port class -> (JAX class, single action or None for the vector classes' batch)
NAMED = {
    phys2d.CartPoleTorchEnv: (jphys2d.CartPoleJaxEnv, 1),
    phys2d.CartPoleTorchVectorEnv: (CartPoleJaxVectorEnv, None),
    phys2d.PendulumTorchEnv: (jphys2d.PendulumJaxEnv, np.array([0.5], np.float32)),
    phys2d.PendulumTorchVectorEnv: (PendulumJaxVectorEnv, None),
    tabular.CliffWalkingTorchEnv: (jtabular.CliffWalkingJaxEnv, 2),
    tabular.BlackJackTorchEnv: (jtabular.BlackJackJaxEnv, 1),
}


@pytest.mark.parametrize("cls", list(NAMED), ids=lambda c: c.__name__)
def test_named_class_has_jax_metadata_and_steps(cls):
    ref, action = NAMED[cls]
    assert cls.__name__ == ref.__name__.replace("Jax", "Torch")
    want = {("torch" if k == "jax" else k): v for k, v in ref.metadata.items()}
    assert cls.metadata == want
    if action is None:
        env = cls(4, device="cpu")
        assert env.time_limit == 200 and env.num_envs == 4
        assert {k: v for k, v in env.metadata.items() if k != "autoreset_mode"} == want
        obs, _ = env.reset(seed=0)
        out = env.step(env.action_space.sample())
        assert out[0].shape == obs.shape == (4, *env.single_observation_space.shape)
    else:
        env = cls(render_mode="rgb_array", device="cpu")
        assert env.metadata == want and env.device == torch.device("cpu")
        obs, _ = env.reset(seed=0)
        out = env.step(action)
        assert env.observation_space.contains(out[0]) and isinstance(out[1], float)
        assert env.render().dtype == np.uint8
    env.close()


def test_named_classes_are_exported_as_jax_exports_its_own():
    for port, ref in ((phys2d, jphys2d), (tabular, jtabular)):
        want = {name.replace("Jax", "Torch") for name in ref.__all__ if "Jax" in name}
        assert want <= set(port.__all__)
        assert all(getattr(port, name).__module__.startswith(port.__name__) for name in want)
