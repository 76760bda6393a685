"""The port's wrapper catalog resolves each name as the JAX package's does:
the same ``__all__``, each name from the module of the same name (the host
wrappers, not the functional ones; the array conversions too), the
functional wrappers only under ``wrappers.func``, and the same messages for
renamed and missing names."""

import pytest

import gymnasium_tpu.wrappers as jw
import gymnasium_tpu_torch.wrappers as tw
from gymnasium_tpu_torch.wrappers import func as tfunc

PORTED = [name for name in jw.__all__ if name != "vector"]

FUNCTIONAL = ("TransformObservation", "RescaleObservation", "DelayObservation", "TimeAwareObservation",
              "FrameStackObservation", "NormalizeObservation", "TransformAction", "ClipAction", "RescaleAction",
              "StickyAction", "TransformReward", "ClipReward", "NormalizeReward")


def test_catalog_lists_jax_names():
    assert tw.__all__ == jw.__all__
    assert len(PORTED) == 38


@pytest.mark.parametrize("name", PORTED)
def test_name_comes_from_the_module_of_the_same_name(name):
    got, want = getattr(tw, name), getattr(jw, name)
    assert got.__module__ == want.__module__.replace("gymnasium_tpu.", "gymnasium_tpu_torch.", 1)
    assert got.__name__ == want.__name__
    assert not got.__module__.endswith(".func")


@pytest.mark.parametrize("name", FUNCTIONAL)
def test_functional_wrappers_stay_under_func(name):
    functional, host = getattr(tfunc, name), getattr(tw, name)
    assert functional.__module__ == "gymnasium_tpu_torch.wrappers.func"
    assert functional is not host and not issubclass(host, tfunc.FuncWrapper)


@pytest.mark.parametrize("name", ["EpisodeStatistics", "FuncWrapper", "WrappedEnvCarry", "episode_stats_to_infos",
                                  "wrap_autoreset_step", "wrap_initial"])
def test_functional_only_names_are_not_at_the_top(name):
    assert hasattr(tfunc, name)
    with pytest.raises(AttributeError):
        getattr(tw, name)
    with pytest.raises(AttributeError):
        getattr(jw, name)


@pytest.mark.parametrize("name", ["AutoResetWrapper", "FrameStack", "PixelObservationWrapper", "VectorListInfo"])
def test_renamed_wrapper_raises_jax_message(name):
    with pytest.raises(AttributeError) as want:
        getattr(jw, name)
    with pytest.raises(AttributeError) as got:
        getattr(tw, name)
    assert str(got.value) == str(want.value)


def test_vector_resolves_to_the_port_subpackage():
    import gymnasium_tpu_torch.wrappers.vector as tvector

    assert tw.vector is tvector
    assert tvector.__all__ == jw.vector.__all__


def test_host_modules_and_func_do_not_import_each_other():
    import ast
    from pathlib import Path

    root = Path(tw.__file__).parent
    host = {"utils", "transform_observation", "transform_action", "transform_reward", "stateful_observation",
            "stateful_action", "stateful_reward"}

    def imported(stem):
        tree = ast.parse((root / f"{stem}.py").read_text())
        return {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom) and node.module}

    assert not {f"gymnasium_tpu_torch.wrappers.{m}" for m in host} & imported("func")
    for stem in host:
        assert "gymnasium_tpu_torch.wrappers.func" not in imported(stem), stem
