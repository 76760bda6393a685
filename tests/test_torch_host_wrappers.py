"""The port's single-env host wrappers against the JAX package's: each
wrapper over the port's ``make(id)`` against the same wrapper over
``gymnasium_tpu.make(id)``, from the same seed and actions.

On the numpy host classes every output is equal in every bit
(``assert_host_env_matches_jax``: the same wrapper stack and spaces, resets
and steps, and the generators after every call, which ``StickyAction``
draws from). FrozenLake's spaces are ``Discrete``, so the two ``Discretize``
wrappers run over MountainCar (a bounded ``Box`` observation) and Pendulum
(a ``Box`` action); FrozenLake and Blackjack take the flattening, filtering
and dtype wrappers. CarRacing's 96×96 frames go through
``GrayscaleObservation`` and ``ResizeObservation``.

HalfCheetah with ``device="cpu"`` steps the articulated twin, so each step
starts from JAX's state (``set_state``) and is held to the tolerance of the
MuJoCo host classes' tests, ``1e-5 * max |JAX| + 1e-6``: the raw
observation, the reward and
``NormalizeObservation``'s running moments. Its normalised observation is
held to that tolerance divided by the running standard deviation, by which
the normalisation scales a difference.
"""

import numpy as np
import pytest

import gymnasium_tpu as jgym
import gymnasium_tpu.wrappers as jw
import gymnasium_tpu.wrappers.utils as jutils
import gymnasium_tpu_torch as gym
import gymnasium_tpu_torch.wrappers as tw
import gymnasium_tpu_torch.wrappers.utils as tutils
from tests.torch_compare import assert_host_env_matches_jax, assert_identical, to_port

# name -> (env id, make kwargs, steps, wrap(W, env) with W the package's wrappers)
CASES = {
    "TransformObservation": ("CartPole-v1", {}, 60, lambda W, e: W.TransformObservation(e, lambda o: o * 2.0 + 1.0, None)),
    "FlattenObservation[Box]": ("CartPole-v1", {}, 40, lambda W, e: W.FlattenObservation(e)),
    "FlattenObservation[Discrete]": ("FrozenLake-v1", {}, 60, lambda W, e: W.FlattenObservation(e)),
    "FlattenObservation[Tuple]": ("Blackjack-v1", {}, 40, lambda W, e: W.FlattenObservation(e)),
    "FilterObservation": ("Blackjack-v1", {}, 40, lambda W, e: W.FilterObservation(e, [0, 2])),
    "ReshapeObservation": ("CartPole-v1", {}, 40, lambda W, e: W.ReshapeObservation(e, (2, 2))),
    "RescaleObservation": ("Pendulum-v1", {}, 40, lambda W, e: W.RescaleObservation(e, -1.0, 1.0)),
    "DtypeObservation[Box]": ("CartPole-v1", {}, 40, lambda W, e: W.DtypeObservation(e, np.float64)),
    "DtypeObservation[Discrete]": ("FrozenLake-v1", {}, 40, lambda W, e: W.DtypeObservation(e, np.int32)),
    "DiscretizeObservation": ("MountainCar-v0", {}, 60, lambda W, e: W.DiscretizeObservation(e, 6)),
    "DiscretizeObservation[multi]": ("MountainCar-v0", {}, 60, lambda W, e: W.DiscretizeObservation(e, (4, 5), True)),
    "AddRenderObservation": ("CartPole-v1", {"render_mode": "rgb_array"}, 12, lambda W, e: W.AddRenderObservation(e)),
    "AddRenderObservation[state]": ("CartPole-v1", {"render_mode": "rgb_array"}, 12,
                                    lambda W, e: W.AddRenderObservation(e, render_only=False)),
    "DelayObservation": ("CartPole-v1", {}, 60, lambda W, e: W.DelayObservation(e, 3)),
    "TimeAwareObservation": ("CartPole-v1", {}, 60, lambda W, e: W.TimeAwareObservation(e)),
    "TimeAwareObservation[dict]": ("Pendulum-v1", {}, 210,
                                   lambda W, e: W.TimeAwareObservation(e, flatten=False, normalize_time=True)),
    "FrameStackObservation": ("CartPole-v1", {}, 60, lambda W, e: W.FrameStackObservation(e, 4)),
    "FrameStackObservation[zero]": ("Pendulum-v1", {}, 30, lambda W, e: W.FrameStackObservation(e, 3, padding_type="zero")),
    "NormalizeObservation": ("CartPole-v1", {}, 80, lambda W, e: W.NormalizeObservation(e)),
    "MaxAndSkipObservation": ("CartPole-v1", {}, 30, lambda W, e: W.MaxAndSkipObservation(e, 4)),
    "TransformAction": ("Pendulum-v1", {}, 40,
                        lambda W, e: W.TransformAction(e, lambda a: 0.5 * a, e.action_space)),
    "ClipAction": ("Pendulum-v1", {}, 40, lambda W, e: W.ClipAction(e)),
    "RescaleAction": ("Pendulum-v1", {}, 40, lambda W, e: W.RescaleAction(e, -1.0, 1.0)),
    "DiscretizeAction": ("Pendulum-v1", {}, 40, lambda W, e: W.DiscretizeAction(e, 5)),
    "StickyAction": ("CartPole-v1", {}, 80, lambda W, e: W.StickyAction(e, 0.25)),
    "StickyAction[duration]": ("CartPole-v1", {}, 80, lambda W, e: W.StickyAction(e, 0.4, (1, 3))),
    "TransformReward": ("Pendulum-v1", {}, 40, lambda W, e: W.TransformReward(e, lambda r: 2.0 * r + 1.0)),
    "ClipReward": ("Pendulum-v1", {}, 40, lambda W, e: W.ClipReward(e, -1.0, 0.0)),
    "NormalizeReward": ("Pendulum-v1", {}, 210, lambda W, e: W.NormalizeReward(e, gamma=0.95)),
    "GrayscaleObservation": ("CarRacing-v3", {}, 8, lambda W, e: W.GrayscaleObservation(e)),
    "GrayscaleObservation[keep_dim]": ("CarRacing-v3", {}, 8, lambda W, e: W.GrayscaleObservation(e, keep_dim=True)),
    "ResizeObservation": ("CarRacing-v3", {}, 8, lambda W, e: W.ResizeObservation(e, (64, 48))),
    "ResizeObservation[gray]": ("CarRacing-v3", {}, 8,
                                lambda W, e: W.ResizeObservation(W.GrayscaleObservation(e), (32, 32))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_wrapper_over_a_host_class_equals_jax(name):
    env_id, kwargs, steps, wrap = CASES[name]
    port = wrap(tw, gym.make(env_id, **kwargs))
    ref = wrap(jw, jgym.make(env_id, **kwargs))
    assert type(port).__module__ == type(ref).__module__.replace("gymnasium_tpu.", "gymnasium_tpu_torch.", 1)
    assert_host_env_matches_jax(port, ref, steps, seed=3, render_every=5 if "render_mode" in kwargs else 0)
    if "NormalizeObservation" in name:
        assert_identical(port.obs_rms.mean, ref.obs_rms.mean)
        assert_identical(port.obs_rms.var, ref.obs_rms.var)
    port.close()
    ref.close()


def test_every_wrapper_class_has_a_case():
    modules = ("transform_observation", "transform_action", "transform_reward", "stateful_observation",
               "stateful_action", "stateful_reward")
    classes = {name for name, module in jw._MODULE_BY_ATTR.items() if module in modules}
    covered = {name.split("[")[0] for name in CASES}
    assert classes == covered


def test_discretize_reverts_as_jax_does():
    port = tw.DiscretizeObservation(gym.make("MountainCar-v0"), (4, 5))
    ref = jw.DiscretizeObservation(jgym.make("MountainCar-v0"), (4, 5))
    for k in range(20):
        assert_identical(port.revert_observation(k), ref.revert_observation(k))
    port_a = tw.DiscretizeAction(gym.make("Pendulum-v1"), 7)
    ref_a = jw.DiscretizeAction(jgym.make("Pendulum-v1"), 7)
    for k in range(7):
        assert_identical(port_a.action(k), ref_a.action(k))


def test_running_mean_std_and_merge_moments_equal_jax():
    rng = np.random.default_rng(0)
    port, ref = tutils.RunningMeanStd(shape=(3,)), jutils.RunningMeanStd(shape=(3,))
    for k in range(20):
        batch = rng.normal(k * 0.1, 1.0 + k, (int(rng.integers(1, 50)), 3))
        port.update(batch)
        ref.update(batch)
        assert_identical((port.mean, port.var, port.count), (ref.mean, ref.var, ref.count), f"batch {k}")
    a = (rng.normal(size=4), rng.random(4), 3.0)
    b = (rng.normal(size=4), rng.random(4), 11.0)
    assert_identical(tutils.merge_moments(a, b), jutils.merge_moments(a, b))
    assert_identical(tutils.update_mean_var_count_from_moments(*a, *b),
                     jutils.update_mean_var_count_from_moments(*a, *b))
    # the merged moments are those of the union
    x, y = rng.normal(size=(5, 2)), rng.normal(size=(9, 2))
    mean, var, count = tutils.merge_moments((x.mean(0), x.var(0), 5), (y.mean(0), y.var(0), 9))
    both = np.concatenate([x, y])
    np.testing.assert_allclose(mean, both.mean(0), rtol=1e-12)
    np.testing.assert_allclose(var, both.var(0), rtol=1e-12)
    assert count == 14


@pytest.mark.parametrize("space", [
    lambda s: s.Box(np.array([-1.0, 2.0]), np.array([1.0, 3.0])),
    lambda s: s.Box(-3.0, -1.0, (2,)),
    lambda s: s.Discrete(4, start=2),
    lambda s: s.MultiDiscrete([3, 4], start=[1, -1]),
    lambda s: s.MultiBinary(3),
    lambda s: s.Tuple((s.Discrete(2), s.Box(0.0, 1.0, (2,)))),
    lambda s: s.Dict({"a": s.Discrete(3), "b": s.Text(4)}),
], ids=["box", "box_negative", "discrete", "multi_discrete", "multi_binary", "tuple", "dict"])
def test_create_zero_array_equals_jax(space):
    import gymnasium_tpu.spaces as js

    jspace = space(js)
    assert_identical(tutils.create_zero_array(to_port(jspace)), jutils.create_zero_array(jspace))


def test_rescale_box_equals_jax():
    import gymnasium_tpu.spaces as js

    jbox = js.Box(np.array([-2.0, 0.0], np.float32), np.array([2.0, 10.0], np.float32))
    got, want = tutils.rescale_box(to_port(jbox), -1.0, np.array([1.0, 2.0], np.float32)), \
        jutils.rescale_box(jbox, -1.0, np.array([1.0, 2.0], np.float32))
    assert repr(got[0]) == repr(want[0])
    x = np.array([0.5, 7.5], np.float32)
    assert_identical(got[1](x), want[1](x))
    assert_identical(got[2](x), want[2](x))


def _tolerance(values) -> float:
    return 1e-5 * float(np.max(np.abs(values))) + 1e-6


def test_normalize_clip_rescale_over_half_cheetah_within_host_class_tolerance():
    def stack(W, env):
        return W.NormalizeObservation(W.ClipAction(W.RescaleAction(env, -1.0, 1.0)))

    port = stack(tw, gym.make("HalfCheetah-v5", device="cpu"))
    ref = stack(jw, jgym.make("HalfCheetah-v5"))
    assert_identical(port.reset(seed=3), ref.reset(seed=3))
    rng = np.random.default_rng(3)
    for k in range(8):
        port.unwrapped.set_state(*ref.unwrapped.get_state())
        action = rng.uniform(-1.5, 1.5, 6).astype(np.float32)  # ClipAction's range, outside the rescaled one
        pobs, prew, pterm, ptrunc, _ = port.step(action)
        jobs, jrew, jterm, jtrunc, _ = ref.step(action)
        raw_p, raw_j = port.unwrapped._get_obs(), ref.unwrapped._get_obs()
        assert np.max(np.abs(raw_p - raw_j)) <= _tolerance(raw_j), f"step {k} raw obs"
        assert abs(prew - jrew) <= _tolerance(jrew), f"step {k} reward"
        for stat in ("mean", "var"):
            got, want = getattr(port.obs_rms, stat), getattr(ref.obs_rms, stat)
            assert np.max(np.abs(got - want)) <= _tolerance(want), f"step {k} running {stat}"
        scale = np.sqrt(ref.obs_rms.var + ref.epsilon)
        assert (np.abs(pobs - jobs) <= 2 * _tolerance(raw_j) / scale).all(), f"step {k} normalised obs"
        assert (pterm, ptrunc) == (jterm, jtrunc)
    port.close()
    ref.close()
