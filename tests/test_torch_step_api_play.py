"""The port's step-API converters, ``play``, ``PlayableGame`` and
``PlayPlot`` against the JAX package's.

The converters give JAX's returns on single and vector steps, with list and
dict infos; a vector step whose flags are torch tensors converts as JAX's
does its numpy flags. ``play`` over ``make("CartPole-v1",
render_mode="rgb_array")`` under ``SDL_VIDEODRIVER=dummy``, steered by
posted key events and stopped by a posted ``QUIT``, takes JAX's steps and
hands the callback JAX's arguments; ``PlayPlot`` plots under matplotlib's
Agg backend.
"""

import copy
import importlib

import numpy as np
import pytest
import torch

import gymnasium_tpu as jgym
import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch import utils
from tests.torch_compare import assert_identical

# by module path: the port's ``utils.play`` and ``utils.step_api_compatibility``
# are the functions, whichever module was imported first
jplay = importlib.import_module("gymnasium_tpu.utils.play")
jstep_api = importlib.import_module("gymnasium_tpu.utils.step_api_compatibility")
tplay = importlib.import_module("gymnasium_tpu_torch.utils.play")
tstep_api = importlib.import_module("gymnasium_tpu_torch.utils.step_api_compatibility")

OBS = np.arange(6, dtype=np.float32).reshape(3, 2)
TO_NEW = {
    "single_truncated": ((OBS[0], 1.0, True, {"TimeLimit.truncated": True}), False),
    "single_terminated": ((OBS[0], 1.0, True, {}), False),
    "single_running": ((OBS[0], 0.5, False, {"x": 1}), False),
    "single_already_new": ((OBS[0], 1.0, False, True, {}), False),
    "vector_list": ((OBS, np.ones(3), np.array([True, False, True]),
                     [{"TimeLimit.truncated": True}, {}, {"TimeLimit.truncated": False}]), True),
    "vector_dict": ((OBS, np.ones(3), np.array([True, False, True]),
                     {"TimeLimit.truncated": np.array([True, False, False]),
                      "_TimeLimit.truncated": np.array([True, False, True])}), True),
    "vector_dict_without_flag": ((OBS, np.ones(3), np.array([False, True, False]), {"x": np.arange(3)}), True),
}
TO_DONE = {
    "single_truncated": ((OBS[0], 1.0, False, True, {}), False),
    "single_terminated_and_truncated": ((OBS[0], 1.0, True, True, {"x": 2}), False),
    "single_running": ((OBS[0], 1.0, False, False, {}), False),
    "single_already_old": ((OBS[0], 1.0, True, {}), False),
    "vector_list": ((OBS, np.ones(3), np.array([True, False, False]), np.array([False, False, True]),
                     [{}, {}, {}]), True),
    "vector_dict": ((OBS, np.ones(3), np.array([True, False, False]), np.array([True, False, True]),
                     {"x": np.arange(3)}), True),
    "vector_dict_running": ((OBS, np.ones(3), np.zeros(3, bool), np.zeros(3, bool), {}), True),
}
CONVERTERS = {"to_new": (TO_NEW, "convert_to_terminated_truncated_step_api"),
              "to_done": (TO_DONE, "convert_to_done_step_api")}
CASES = [(way, name) for way, (cases, _) in CONVERTERS.items() for name in sorted(cases)]


@pytest.mark.parametrize("way,name", CASES)
def test_converter_equals_jax(way, name):
    cases, fn = CONVERTERS[way]
    step, is_vector = cases[name]
    got = getattr(tstep_api, fn)(copy.deepcopy(step), is_vector)
    want = getattr(jstep_api, fn)(copy.deepcopy(step), is_vector)
    assert_identical(got, want)
    output_truncation_bool = way == "to_new"
    assert_identical(utils.step_api_compatibility(copy.deepcopy(step), output_truncation_bool, is_vector), want)


def as_tensors(step):
    """A vector step's flags as torch tensors, as a ``TorchVectorEnv`` hands them out."""
    return tuple(torch.as_tensor(x) if isinstance(x, np.ndarray) and x.dtype == bool else x for x in step)


@pytest.mark.parametrize("way,name", [case for case in CASES if case[1].startswith("vector")])
def test_vector_converter_reads_tensor_flags_as_jax_reads_numpy(way, name):
    cases, fn = CONVERTERS[way]
    step, _ = cases[name]
    got = getattr(tstep_api, fn)(as_tensors(copy.deepcopy(step)), True)
    want = getattr(jstep_api, fn)(copy.deepcopy(step), True)
    assert_identical(got, want)


def test_round_trip_gives_back_the_flags():
    terminated, truncated = np.array([True, False, False, True]), np.array([False, True, False, True])
    step = (np.zeros((4, 2)), np.ones(4), torch.as_tensor(terminated), torch.as_tensor(truncated), {})
    done_step = utils.convert_to_done_step_api(step, is_vector_env=True)
    _, _, term, trunc, _ = utils.convert_to_terminated_truncated_step_api(done_step, is_vector_env=True)
    assert_identical(term, terminated)  # an episode that also truncated counts as terminated
    assert_identical(trunc, truncated & ~terminated)


# --- play ----------------------------------------------------------------------------

KEYS = {"a": 0, "d": 1}


def played(pkg: str, monkeypatch, steps: int = 12) -> list:
    """``play`` over CartPole: ``d`` pressed after step 3 and released
    after step 7, ``QUIT`` posted after step ``steps``; the callback's
    arguments, one tuple a step."""
    pygame = pytest.importorskip("pygame", reason="play draws with pygame")
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    make, play = {"jax": (jgym.make, jplay.play), "torch": (gym.make, tplay.play)}[pkg]
    env = make("CartPole-v1", render_mode="rgb_array")
    calls = []

    def callback(*args):
        calls.append(copy.deepcopy(args))
        if len(calls) == 3:
            pygame.event.post(pygame.event.Event(pygame.KEYDOWN, key=pygame.K_d))
        elif len(calls) == 7:
            pygame.event.post(pygame.event.Event(pygame.KEYUP, key=pygame.K_d))
        elif len(calls) == steps:
            pygame.event.post(pygame.event.Event(pygame.QUIT))

    play(env, fps=1000, zoom=0.5, callback=callback, keys_to_action=KEYS, seed=4, noop=0)
    env.close()
    return calls


def test_play_takes_jax_steps_with_jax_callback_arguments(monkeypatch):
    got, want = played("torch", monkeypatch), played("jax", monkeypatch)
    assert len(got) == len(want) == 12
    assert [c[2] for c in got] == [0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0]
    assert_identical(got, want)


def test_play_without_a_key_mapping_raises_jax_error():
    got, want = gym.make("CartPole-v1", render_mode="rgb_array"), jgym.make("CartPole-v1", render_mode="rgb_array")
    with pytest.raises(tplay.MissingKeysToAction) as port:
        tplay.play(got)
    with pytest.raises(jplay.MissingKeysToAction) as ref:
        jplay.play(want)
    assert str(port.value) == str(ref.value) == (
        "CartPole-v1 does not have explicit key to action mapping, please specify one manually")


def game_state(module, monkeypatch):
    pygame = pytest.importorskip("pygame", reason="PlayableGame reads pygame events")
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    make = {jplay: jgym.make, tplay: gym.make}[module]
    env = make("CartPole-v1", render_mode="rgb_array")
    env.reset(seed=0)
    game = module.PlayableGame(env, {(ord("a"),): 0, (ord("d"), ord("a")): 1}, zoom=1.5)
    states = [(sorted(game.relevant_keys), game.video_size)]
    for event in (pygame.event.Event(pygame.KEYDOWN, key=ord("a")), pygame.event.Event(pygame.KEYDOWN, key=ord("d")),
                  pygame.event.Event(pygame.KEYDOWN, key=ord("x")), pygame.event.Event(pygame.KEYUP, key=ord("a")),
                  pygame.event.Event(pygame.KEYDOWN, key=pygame.K_ESCAPE)):
        game.process_event(event)
        states.append((list(game.pressed_keys), game.running))
    pygame.quit()
    return states


def test_playable_game_handles_keys_as_jax(monkeypatch):
    got, want = game_state(tplay, monkeypatch), game_state(jplay, monkeypatch)
    assert got == want and want[0] == ([97, 100], (900, 600)) and want[-1] == ([100], False)


def test_playable_game_refuses_a_mode_without_frames_as_jax():
    with pytest.raises(ValueError) as port:
        tplay.PlayableGame(gym.make("CartPole-v1"), {(97,): 0})
    with pytest.raises(ValueError) as ref:
        jplay.PlayableGame(jgym.make("CartPole-v1"), {(97,): 0})
    assert str(port.value) == str(ref.value)


def test_display_arr_draws_jax_pixels(monkeypatch):
    pygame = pytest.importorskip("pygame", reason="display_arr draws with pygame")
    frame = np.random.default_rng(0).integers(0, 255, (40, 60, 3)).astype(np.uint8)
    shown = []
    for module in (tplay, jplay):
        screen = pygame.Surface((90, 60))
        module.display_arr(screen, frame, (90, 60), transpose=True)
        shown.append(pygame.surfarray.array3d(screen))
    assert_identical(shown[0], shown[1])


def test_play_plot_keeps_jax_data_and_reads_tensors_back():
    matplotlib = pytest.importorskip("matplotlib", reason="PlayPlot plots with matplotlib")
    matplotlib.use("Agg")

    def points(obs_t, obs_tp1, action, rew, terminated, truncated, info):
        return [rew, obs_tp1[0]]

    plots = [module.PlayPlot(points, horizon_timesteps=3, plot_names=["reward", "x"]) for module in (tplay, jplay)]
    for t in range(5):
        obs = np.array([0.5 * t, 1.0], dtype=np.float32)
        for plot in plots:
            plot.callback(obs, obs, 0, float(t), False, False, {})
    assert plots[0].t == plots[1].t == 5
    assert_identical([list(d) for d in plots[0].data], [list(d) for d in plots[1].data])
    plots[0].callback(None, torch.tensor([7.0, 1.0]), 0, torch.tensor(2.0), False, False, {})
    assert [d[-1] for d in plots[0].data] == [2.0, 7.0] and isinstance(plots[0].data[1][-1], np.ndarray)
    import matplotlib.pyplot as plt

    plt.close("all")
