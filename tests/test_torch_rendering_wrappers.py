"""The port's rendering wrappers and ``save_video`` against the JAX package's.

``RenderCollection``, ``AddWhiteNoise`` and ``ObstructView`` over
``make("CartPole-v1", render_mode="rgb_array")`` (a numpy host class, equal
to JAX's in every bit) give the same frames in every bit from one seed and
action stream, and leave the env's generator where JAX's leaves it (the
noise is drawn from it). ``make(id, render_mode="rgb_array_list" |
"human")`` wraps an env that lacks the mode as JAX's ``make`` does.

``RecordVideo``, the vector ``RecordVideo`` and ``save_video`` write JAX's
file names, byte for byte the same files: through OpenCV here (moviepy is
not installed), and with both moviepy and OpenCV blocked, JAX's fallback of
``.npz`` frame dumps. ``HumanRendering`` and the vector one show JAX's
window under ``SDL_VIDEODRIVER=dummy``.
"""

import os
import sys

import numpy as np
import pytest

import gymnasium_tpu as jgym
import gymnasium_tpu.wrappers as jw
import gymnasium_tpu_torch as gym
import gymnasium_tpu_torch.wrappers as tw
from gymnasium_tpu.envs.classic_control.cartpole import CartPoleEnv as JCartPoleEnv
from gymnasium_tpu.envs.phys2d.cartpole import CartPoleJaxEnv
from gymnasium_tpu.envs.registration import EnvSpec as JEnvSpec
from gymnasium_tpu.utils.save_video import save_video as jsave_video
from gymnasium_tpu.vector import AutoresetMode as JAutoresetMode
from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleTorchEnv
from gymnasium_tpu_torch.envs.registration import EnvSpec
from gymnasium_tpu_torch.utils.save_video import save_video
from tests.torch_compare import assert_host_env_matches_jax, assert_identical, wrapper_names

PACKAGES = {"jax": (jgym, jw), "torch": (gym, tw)}

# name -> wrap(W, env) with W the package's wrappers
FRAME_CASES = {
    "RenderCollection": lambda W, e: W.RenderCollection(e),
    "RenderCollection[keep]": lambda W, e: W.RenderCollection(e, pop_frames=False, reset_clean=False),
    "AddWhiteNoise": lambda W, e: W.AddWhiteNoise(e, 0.2),
    "AddWhiteNoise[grayscale]": lambda W, e: W.AddWhiteNoise(e, 0.2, is_noise_grayscale=True),
    "ObstructView": lambda W, e: W.ObstructView(e, 0.1, 9),
    "ObstructView[grayscale]": lambda W, e: W.ObstructView(e, 0.05, 4, is_noise_grayscale=True),
}


def plain(metadata: dict) -> dict:
    """``metadata`` with each enum (the packages' own ``AutoresetMode``) by its value."""
    return {k: getattr(v, "value", v) for k, v in metadata.items()}


@pytest.fixture
def declared_cartpole_metadata(monkeypatch):
    """JAX's ``CartPoleEnv.metadata`` as its class declares it, for the test.

    The JAX package's ``SyncVectorEnv`` and ``AsyncVectorEnv`` write their
    autoreset mode into their first sub-env's ``metadata``, which is the
    env class's own dict: after another file on the same worker has built
    one over CartPole in another mode, JAX's single envs report that mode.
    The port's vector envs copy the dict instead
    (``tests/test_torch_sync_vector_env.py::test_vector_env_leaves_the_class_metadata_alone``).
    """
    monkeypatch.setitem(JCartPoleEnv.metadata, "autoreset_mode", JAutoresetMode.NEXT_STEP)
    monkeypatch.setitem(JCartPoleEnv.metadata, "render_modes", ["human", "rgb_array"])


@pytest.mark.parametrize("name", sorted(FRAME_CASES))
def test_frame_wrapper_equals_jax(name, declared_cartpole_metadata):
    wrap = FRAME_CASES[name]
    port = wrap(tw, gym.make("CartPole-v1", render_mode="rgb_array"))
    ref = wrap(jw, jgym.make("CartPole-v1", render_mode="rgb_array"))
    assert port.render_mode == ref.render_mode
    assert plain(port.metadata) == plain(ref.metadata)
    assert assert_host_env_matches_jax(port, ref, steps=40, render_every=3) > 0


def test_make_wraps_a_missing_list_mode_in_render_collection_as_jax():
    port = gym.make("CartPole-v1", render_mode="rgb_array_list")
    ref = jgym.make("CartPole-v1", render_mode="rgb_array_list")
    assert wrapper_names(port)[0] == "RenderCollection"
    assert_host_env_matches_jax(port, ref, steps=30, render_every=7)


@pytest.mark.parametrize("mode", ["rgb_array_list", "human"])
def test_make_of_a_named_adapter_wraps_a_missing_mode_as_jax(mode, monkeypatch):
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    port = gym.make(EnvSpec("CartPoleRender-v0", entry_point=CartPoleTorchEnv, max_episode_steps=50),
                    render_mode=mode, device="cpu")
    ref = jgym.make(JEnvSpec("CartPoleRender-v0", entry_point=CartPoleJaxEnv, max_episode_steps=50),
                    render_mode=mode)
    assert wrapper_names(port)[:-1] == wrapper_names(ref)[:-1]
    assert wrapper_names(port)[0] == {"rgb_array_list": "RenderCollection", "human": "HumanRendering"}[mode]
    assert port.render_mode == ref.render_mode == mode
    port.reset(seed=0)
    for _ in range(3):
        port.step(0)
    frames = port.render()
    if mode == "human":
        assert frames is None and port.get_wrapper_attr("screen_size") == (600, 400)
    else:
        assert len(frames) == 4 and all(f.shape == (400, 600, 3) and f.dtype == np.uint8 for f in frames)
    port.close()
    ref.close()


def test_make_of_half_cheetah_collects_a_frame_a_step():
    env = gym.make("HalfCheetah-v5", render_mode="rgb_array_list", device="cpu")
    assert wrapper_names(env)[0] == "RenderCollection"
    env.reset(seed=0)
    for _ in range(3):
        env.step(np.zeros(6, np.float32))
    frames = env.render()
    assert len(frames) == 4 and all(f.shape == (480, 480, 3) and f.dtype == np.uint8 for f in frames)
    assert env.render() == []
    env.close()


# --- videos ------------------------------------------------------------------


def files(folder) -> dict:
    return {name: (folder / name).read_bytes() for name in sorted(os.listdir(folder))}


def assert_same_files(port_dir, jax_dir, suffix):
    got, want = files(port_dir), files(jax_dir)
    assert list(got) == list(want) and want and all(name.endswith(suffix) for name in want)
    if suffix == ".npz":
        for name in want:
            a, b = np.load(port_dir / name), np.load(jax_dir / name)
            assert sorted(a.files) == sorted(b.files)
            for key in b.files:
                assert_identical(a[key], b[key], f"{name}[{key}]")
    else:
        assert got == want


def record_episodes(pkg, folder, episodes=3):
    """``RecordVideo`` over CartPole-v1: ``episodes`` episodes of one action
    stream under a step trigger every 25 steps (10-frame videos), then three
    short episodes under the default, cubic, episode trigger."""
    make, W = PACKAGES[pkg]
    env = W.RecordVideo(make.make("CartPole-v1", render_mode="rgb_array"), str(folder),
                        step_trigger=lambda k: k % 25 == 0, video_length=10, name_prefix="cart")
    env.reset(seed=0)
    env.action_space.seed(1)
    ended = 0
    while ended < episodes:
        _, _, term, trunc, _ = env.step(env.action_space.sample())
        if term or trunc:
            ended += 1
            env.reset()
    env.close()
    env = W.RecordVideo(make.make("CartPole-v1", render_mode="rgb_array"), str(folder), name_prefix="cubic")
    for seed in range(3):
        env.reset(seed=seed)
        for _ in range(5):
            env.step(0)
    env.close()


def record_vector(pkg, folder):
    make, W = PACKAGES[pkg]
    env = W.vector.RecordVideo(make.make_vec("CartPole-v1", 3, vectorization_mode="sync", render_mode="rgb_array"),
                               str(folder), episode_trigger=lambda k: True, name_prefix="vec")
    env.reset(seed=0)
    env.action_space.seed(1)
    for _ in range(40):
        env.step(env.action_space.sample())
    env.close()


def save_frames(pkg, folder):
    rng = np.random.default_rng(0)
    frames = list(rng.integers(0, 256, (12, 40, 48, 3), dtype=np.uint8))
    writer = {"jax": jsave_video, "torch": save_video}[pkg]
    writer(frames, str(folder), episode_index=8, fps=10, name_prefix="saved")
    writer(frames, str(folder), step_trigger=lambda k: k % 5 == 0, video_length=4, fps=10, name_prefix="steps")


WRITERS = {"RecordVideo": record_episodes, "vector.RecordVideo": record_vector, "save_video": save_frames}


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_video_files_equal_jax_through_opencv(name, tmp_path):
    pytest.importorskip("cv2", reason="the OpenCV path needs cv2")
    WRITERS[name]("torch", tmp_path / "port")
    WRITERS[name]("jax", tmp_path / "jax")
    assert_same_files(tmp_path / "port", tmp_path / "jax", ".mp4")


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_without_moviepy_and_opencv_frames_are_saved_as_jax_saves_them(name, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "moviepy", None)
    monkeypatch.setitem(sys.modules, "moviepy.video.io.ImageSequenceClip", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    WRITERS[name]("torch", tmp_path / "port")
    WRITERS[name]("jax", tmp_path / "jax")
    assert_same_files(tmp_path / "port", tmp_path / "jax", ".npz")


def test_capped_cubic_schedule_equals_jax():
    from gymnasium_tpu.utils import capped_cubic_video_schedule as want
    from gymnasium_tpu_torch.utils import capped_cubic_video_schedule as got
    from gymnasium_tpu_torch.wrappers.rendering import capped_cubic_video_schedule as wrapper_schedule

    for k in range(3001):
        assert got(k) == want(k) == wrapper_schedule(k)


# --- human rendering ---------------------------------------------------------


def shown_frames(pkg, vector: bool) -> list:
    """The window's pixels after a reset and each of 3 steps."""
    import pygame

    make, W = PACKAGES[pkg]
    if vector:
        env = W.vector.HumanRendering(make.make_vec("CartPole-v1", 3, vectorization_mode="sync", render_mode="rgb_array"))
    else:
        env = W.HumanRendering(make.make("CartPole-v1", render_mode="rgb_array"))
    assert env.render_mode == "human" and "human" in env.metadata["render_modes"]
    env.reset(seed=0)
    env.action_space.seed(1)
    shown = [pygame.surfarray.array3d(env._display.window).copy()]
    for _ in range(3):
        env.step(env.action_space.sample())
        shown.append(pygame.surfarray.array3d(env._display.window).copy())
    assert env.render() is None
    env.close()
    return shown


@pytest.mark.parametrize("vector", [False, True], ids=["single", "vector"])
def test_human_rendering_shows_jax_frames(vector, monkeypatch):
    pytest.importorskip("pygame", reason="HumanRendering draws with pygame")
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    got, want = shown_frames("torch", vector), shown_frames("jax", vector)
    assert got[0].shape == ((1200, 800, 3) if vector else (600, 400, 3))
    assert_identical(got, want)
