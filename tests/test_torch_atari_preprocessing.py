"""The port's ``AtariPreprocessing`` against the JAX package's, over the
synthetic pixel env of ``tests/wrappers/test_atari_preprocessing.py`` (no
ALE env is registered in either package): each of that file's cases runs
the same env class over each package's ``Env``, and every reset and step of
the wrapped pair is equal in every bit (``assert_identical``), observation
space included; the no-op resets draw from the env's generator, which ends
where JAX's does."""

import types

import numpy as np
import pytest

import gymnasium_tpu
import gymnasium_tpu.wrappers as jw
import gymnasium_tpu_torch
import gymnasium_tpu_torch.wrappers as tw
from tests.torch_compare import assert_identical, assert_same_space

PACKAGES = {"jax": (gymnasium_tpu, jw), "torch": (gymnasium_tpu_torch, tw)}


def pixel_env(gym, height=60, width=48, episode_len=100, action_start=0):
    """The JAX test's ``_pixel_env`` over the package ``gym``: flat frames
    whose value counts the steps, reward 1 a step, an episode of
    ``episode_len`` steps, frame-skip free."""

    class PixelEnv(gym.Env):
        metadata = {"render_modes": ["rgb_array"], "render_fps": 30}

        def __init__(self):
            self.render_mode = "rgb_array"
            self.observation_space = gym.spaces.Box(0, 255, (height, width, 3), np.uint8)
            self.action_space = gym.spaces.Discrete(4, start=action_start)
            self.t = 0
            self._frameskip = 1

        def frame(self):
            return np.full((height, width, 3), self.t % 255, dtype=np.uint8)

        def reset(self, *, seed=None, options=None):
            gym.Env.reset(self, seed=seed)
            self.t = 0
            return self.frame(), {}

        def step(self, action):
            self.t += 1
            return self.frame(), 1.0, self.t >= episode_len, False, {}

        def render(self):
            return self.frame()

    return PixelEnv()


# name -> AtariPreprocessing kwargs, as in tests/wrappers/test_atari_preprocessing.py
CASES = {
    "grayscale_resize_shape": {"frame_skip": 4, "screen_size": 84, "noop_max": 0},
    "grayscale_newaxis": {"frame_skip": 4, "noop_max": 0, "grayscale_newaxis": True},
    "rgb_mode": {"frame_skip": 4, "noop_max": 0, "grayscale_obs": False},
    "scale_obs_float": {"frame_skip": 4, "noop_max": 0, "scale_obs": True},
    "rectangular_screen_size": {"frame_skip": 2, "noop_max": 0, "screen_size": (100, 60)},
    "frame_skip_accumulates_reward": {"frame_skip": 4, "noop_max": 0},
    "noop_reset_advances_env": {"frame_skip": 1, "noop_max": 10},
    "terminal_on_life_loss": {"frame_skip": 3, "noop_max": 5, "terminal_on_life_loss": True},
}


def run(pkg, kwargs, seed):
    gym, W = PACKAGES[pkg]
    env = W.AtariPreprocessing(pixel_env(gym, episode_len=30), **kwargs)
    calls = [env.reset(seed=seed)]
    for k in range(12):
        calls.append(env.step(k % 4))
        if calls[-1][2] or calls[-1][3]:
            calls.append(env.reset())
    return env, calls


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_atari_preprocessing_equals_jax(name, seed):
    port, got = run("torch", CASES[name], seed)
    ref, want = run("jax", CASES[name], seed)
    assert_same_space(port.observation_space, ref.observation_space)
    assert_identical(got, want, name)
    assert port.unwrapped.np_random.bit_generator.state == ref.unwrapped.np_random.bit_generator.state
    assert got[0][0].shape == port.observation_space.shape


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_invalid_arguments_are_refused_as_jax(pkg):
    gym, W = PACKAGES[pkg]
    with pytest.raises(AssertionError):
        W.AtariPreprocessing(pixel_env(gym), frame_skip=0)
    with pytest.raises(AssertionError):
        W.AtariPreprocessing(pixel_env(gym, action_start=1), noop_max=5)
    env = pixel_env(gym)
    env.spec = types.SimpleNamespace(id="Pong-v5")
    env._frameskip = 4
    with pytest.raises(ValueError, match="Disable frame-skipping"):
        W.AtariPreprocessing(env, frame_skip=4)
