"""A third-party ``MujocoEnv`` subclass over its own MJCF file, in the port:
the counterpart of ``tests/envs/test_custom_mujoco_env.py``. The subclass
points the port's ``MujocoEnv`` at an ``.xml``, which compiles on the fly
(``envs/mujoco/mjcf.py``), and overrides ``_get_obs``, ``step`` and
``_get_reset_info``. Its trajectory is held to the same subclass over the
JAX package's ``MujocoEnv`` within ``1e-5 * max |JAX| + 1e-6``.
"""

import pickle

import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.mujoco.mujoco_env import MujocoEnv as JaxMujocoEnv
from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.mujoco.mujoco_env import MujocoEnv, kernel_name
from gymnasium_tpu_torch.utils.ezpickle import EzPickle
from tests.envs.test_custom_mujoco_env import CART_XML, MiniCartEnv as JaxMiniCartEnv


class MiniCartEnv(MujocoEnv, EzPickle):
    def __init__(self, xml_file, frame_skip=2, **kwargs):
        EzPickle.__init__(self, xml_file, frame_skip, **kwargs)
        MujocoEnv.__init__(self, xml_file, frame_skip=frame_skip, observation_space=None, **kwargs)
        size = self.data.qpos.size + self.data.qvel.size
        self.observation_space = spaces.Box(-np.inf, np.inf, (size,), np.float64)

    def _get_obs(self):
        return np.concatenate([self.data.qpos.flat.copy(), self.data.qvel.flat.copy()])

    def step(self, action):
        before = self.data.qpos[0]
        self.do_simulation(action, self.frame_skip)
        reward = float(self.data.qpos[0] - before)
        return self._get_obs(), reward, False, False, {}

    def _get_reset_info(self):
        return {"custom": True}


@pytest.fixture(scope="module")
def xml_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("mjcf") / "minicart.xml"
    path.write_text(CART_XML)
    return str(path)


def test_custom_xml_env_steps_as_jax_does(xml_path):
    env, ref = MiniCartEnv(xml_path, device="cpu"), JaxMiniCartEnv(xml_path)
    assert issubclass(JaxMiniCartEnv, JaxMujocoEnv)
    obs, info = env.reset(seed=0)
    want, want_info = ref.reset(seed=0)
    assert info == want_info == {"custom": True}
    assert obs.shape == (2,) and obs.dtype == np.float64 and np.array_equal(obs, want)
    for _ in range(20):
        action = np.array([1.0], np.float32)
        obs, reward, *_ = env.step(action)
        want, want_reward, *_ = ref.step(action)
        assert np.max(np.abs(obs - want)) <= 1e-5 * np.max(np.abs(want)) + 1e-6
        assert abs(reward - want_reward) <= 1e-5 * max(abs(want_reward), np.max(np.abs(want))) + 1e-6
    assert obs[0] > 0.01, "a constant push must move the cart forward"
    assert obs.dtype == np.float64
    assert env._step.name == kernel_name(xml_path) and env._step.name.startswith("xml_minicart_")
    env.close()


def test_custom_env_pickles_with_its_device(xml_path):
    env = MiniCartEnv(xml_path, device="cpu")
    clone = pickle.loads(pickle.dumps(env))
    assert clone.device == torch.device("cpu")
    clone.reset(seed=3)
    obs, *_ = clone.step(clone.action_space.sample())
    assert clone.observation_space.contains(obs)
    clone.close()
    env.close()


def test_missing_xml_raises():
    with pytest.raises(OSError, match="does not exist"):
        MiniCartEnv("no_such_model.xml", device="cpu")
