"""The port's MuJoCo renderers against the JAX package's.

After the same seeded reset, HalfCheetah's and Ant's ``rgb_array`` and
``depth_array`` frames (480 x 480, the software rasterizer of
``envs/mujoco/render3d.py`` over the env's forward kinematics) equal JAX's
but at no more than 0.5 % of the pixels, the rule of the CarRacing frames:
the two sides' float32 kinematics may differ in a last bit, which moves an
edge pixel. A depth pixel is a float32 distance along the camera axis; it
counts as equal within the articulated tests' ``1e-5 * |JAX| + 1e-6``
(Ant's free root turns the whole robot through a rotation whose last bits
differ, which moves most depths by an ulp: at most 2.6e-6 m of 3-47 m). ``rgbd_tuple``, overlays, the side view of a model without
render geoms and the ``OffScreenViewer`` seam are checked on the port alone.
"""

import numpy as np
import pytest

import gymnasium_tpu as jgym
import gymnasium_tpu_torch as gym

MAX_DIFFERENT = 0.005


@pytest.mark.parametrize("env_id", ["HalfCheetah-v5", "Ant-v5"])
@pytest.mark.parametrize("mode", ["rgb_array", "depth_array"])
def test_frames_match_jax(env_id, mode):
    frames = []
    for make, kwargs in ((jgym.make, {}), (gym.make, {"device": "cpu"})):
        env = make(env_id, render_mode=mode, **kwargs)
        env.reset(seed=5)
        env.step(np.full(env.action_space.shape, 0.3, np.float32))
        frames.append(env.render())
        env.close()
    want, got = frames
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.shape == ((480, 480) if mode == "depth_array" else (480, 480, 3))
    assert got.dtype == (np.float32 if mode == "depth_array" else np.uint8)
    if mode == "depth_array":
        differ = np.abs(got - want) > 1e-5 * np.abs(want) + 1e-6
    else:
        differ = (got != want).any(axis=-1)
    assert differ.mean() <= MAX_DIFFERENT, f"{differ.mean():.4%} of the pixels differ"
    assert np.unique(got).size > 1


def test_rgbd_tuple_and_overlays():
    env = gym.make("HalfCheetah-v5", render_mode="rgbd_tuple", device="cpu", width=64, height=48)
    env.reset(seed=0)
    rgb, depth = env.render()
    assert rgb.shape == (48, 64, 3) and rgb.dtype == np.uint8
    assert depth.shape == (48, 64) and depth.dtype == np.float32
    renderer = env.unwrapped.mujoco_renderer
    viewer = renderer._get_viewer("rgb_array")
    viewer.add_overlay(0, "step", "1")
    viewer.cam.distance = 5.0
    assert env.unwrapped._camera_config["distance"] == 5.0
    env.close()


def test_side_view_of_a_model_without_render_geoms():
    env = gym.make("Hopper-v5", render_mode="rgb_array", device="cpu", width=96, height=72).unwrapped
    env.reset(seed=0)
    env.meta = {**env.meta, "render_geoms": []}
    frame = env.render()
    assert frame.shape == (72, 96, 3) and frame.dtype == np.uint8 and np.unique(frame).size > 1
    env.render_mode = "depth_array"
    assert np.all(env.render() == 10.0)


def test_offscreen_viewer_renders_a_port_env():
    from gymnasium_tpu_torch.envs.mujoco.mujoco_rendering import OffScreenViewer

    env = gym.make("Ant-v5", device="cpu").unwrapped
    env.reset(seed=0)
    viewer = OffScreenViewer(env, width=40, height=30)
    frame = viewer.render("rgb_array")
    assert frame.shape == (30, 40, 3)
    viewer.close()
    with pytest.raises(TypeError):
        OffScreenViewer(object())
