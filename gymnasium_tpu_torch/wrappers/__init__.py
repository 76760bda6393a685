"""Wrapper catalog (copy of the JAX package's ``wrappers/__init__.py``, which
follows Gymnasium's gymnasium/wrappers/__init__.py).

Each name imports lazily from its module, as in the JAX package: the
single-env host wrappers of ``common``, ``transform_*``, ``stateful_*``,
``rendering`` and ``atari_preprocessing`` work on any env ``make`` builds,
and ``vector`` is the vector wrappers' subpackage. The functional,
device-side wrappers of the port live only under
:mod:`~gymnasium_tpu_torch.wrappers.func`. The array-conversion wrappers
convert between numpy and torch; ``JaxToNumpy`` and ``JaxToTorch`` resolve
and raise ``DependencyNotInstalled`` when called (the port has no JAX).
"""

from typing import Any

__all__ = [
    # common
    "TimeLimit",
    "Autoreset",
    "PassiveEnvChecker",
    "OrderEnforcing",
    "RecordEpisodeStatistics",
    # observation (stateless)
    "TransformObservation",
    "FilterObservation",
    "FlattenObservation",
    "GrayscaleObservation",
    "ResizeObservation",
    "ReshapeObservation",
    "RescaleObservation",
    "DtypeObservation",
    "AddRenderObservation",
    "DiscretizeObservation",
    # observation (stateful)
    "DelayObservation",
    "TimeAwareObservation",
    "FrameStackObservation",
    "NormalizeObservation",
    "MaxAndSkipObservation",
    # action
    "TransformAction",
    "ClipAction",
    "RescaleAction",
    "DiscretizeAction",
    "StickyAction",
    # reward
    "TransformReward",
    "ClipReward",
    "NormalizeReward",
    # rendering
    "RenderCollection",
    "RecordVideo",
    "HumanRendering",
    "AddWhiteNoise",
    "ObstructView",
    # atari
    "AtariPreprocessing",
    # array conversion
    "ArrayConversion",
    "JaxToNumpy",
    "JaxToTorch",
    "NumpyToTorch",
    # vector submodule
    "vector",
]

_MODULE_BY_ATTR = {
    "TimeLimit": "common",
    "Autoreset": "common",
    "PassiveEnvChecker": "common",
    "OrderEnforcing": "common",
    "RecordEpisodeStatistics": "common",
    "TransformObservation": "transform_observation",
    "FilterObservation": "transform_observation",
    "FlattenObservation": "transform_observation",
    "GrayscaleObservation": "transform_observation",
    "ResizeObservation": "transform_observation",
    "ReshapeObservation": "transform_observation",
    "RescaleObservation": "transform_observation",
    "DtypeObservation": "transform_observation",
    "AddRenderObservation": "transform_observation",
    "DiscretizeObservation": "transform_observation",
    "DelayObservation": "stateful_observation",
    "TimeAwareObservation": "stateful_observation",
    "FrameStackObservation": "stateful_observation",
    "NormalizeObservation": "stateful_observation",
    "MaxAndSkipObservation": "stateful_observation",
    "TransformAction": "transform_action",
    "ClipAction": "transform_action",
    "RescaleAction": "transform_action",
    "DiscretizeAction": "transform_action",
    "StickyAction": "stateful_action",
    "TransformReward": "transform_reward",
    "ClipReward": "transform_reward",
    "NormalizeReward": "stateful_reward",
    "RenderCollection": "rendering",
    "RecordVideo": "rendering",
    "HumanRendering": "rendering",
    "AddWhiteNoise": "rendering",
    "ObstructView": "rendering",
    "AtariPreprocessing": "atari_preprocessing",
    "ArrayConversion": "array_conversion",
    "JaxToNumpy": "jax_to_numpy",
    "JaxToTorch": "jax_to_torch",
    "NumpyToTorch": "numpy_to_torch",
}


# pre-1.0 wrapper names -> their current equivalents
# (reference wrappers/__init__.py:156-162)
_renamed_wrapper = {
    "AutoResetWrapper": "Autoreset",
    "FrameStack": "FrameStackObservation",
    "PixelObservationWrapper": "AddRenderObservation",
    "VectorListInfo": "vector.DictInfoToList",
}


def __getattr__(name: str) -> Any:
    if name in _MODULE_BY_ATTR:
        import importlib

        module = importlib.import_module(f"gymnasium_tpu_torch.wrappers.{_MODULE_BY_ATTR[name]}")
        return getattr(module, name)
    if name in _renamed_wrapper:
        raise AttributeError(
            f"{name!r} has been renamed with `wrappers.{_renamed_wrapper[name]}`"
        )
    if name in ("vector", "func"):
        import importlib

        return importlib.import_module(f"gymnasium_tpu_torch.wrappers.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
