"""Vector wrapper catalog (copy of the JAX package's ``wrappers/vector/__init__.py``,
which follows Gymnasium's gymnasium/wrappers/vector/).

Each name imports lazily from its module. The wrappers are JAX's numpy code;
where JAX lets numpy read a device array, the port reads a tensor back with
:func:`~gymnasium_tpu_torch.utils.device.to_host`. ``JaxToNumpy`` and
``JaxToTorch`` resolve and raise ``DependencyNotInstalled`` when called.
"""

from typing import Any

__all__ = [
    "RecordEpisodeStatistics",
    "DictInfoToList",
    "HumanRendering",
    "RecordVideo",
    "NormalizeObservation",
    "NormalizeReward",
    # observation
    "TransformObservation",
    "VectorizeTransformObservation",
    "FilterObservation",
    "FlattenObservation",
    "GrayscaleObservation",
    "ResizeObservation",
    "ReshapeObservation",
    "RescaleObservation",
    "DtypeObservation",
    # action
    "TransformAction",
    "VectorizeTransformAction",
    "ClipAction",
    "RescaleAction",
    # reward
    "TransformReward",
    "VectorizeTransformReward",
    "ClipReward",
    # conversion
    "ArrayConversion",
    "JaxToNumpy",
    "JaxToTorch",
    "NumpyToTorch",
]

_MODULE_BY_ATTR = {
    "RecordEpisodeStatistics": "common",
    "DictInfoToList": "dict_info_to_list",
    "HumanRendering": "rendering",
    "RecordVideo": "rendering",
    "NormalizeObservation": "stateful_observation",
    "NormalizeReward": "stateful_reward",
    "TransformObservation": "vectorize_observation",
    "VectorizeTransformObservation": "vectorize_observation",
    "FilterObservation": "vectorize_observation",
    "FlattenObservation": "vectorize_observation",
    "GrayscaleObservation": "vectorize_observation",
    "ResizeObservation": "vectorize_observation",
    "ReshapeObservation": "vectorize_observation",
    "RescaleObservation": "vectorize_observation",
    "DtypeObservation": "vectorize_observation",
    "TransformAction": "vectorize_action",
    "VectorizeTransformAction": "vectorize_action",
    "ClipAction": "vectorize_action",
    "RescaleAction": "vectorize_action",
    "TransformReward": "vectorize_reward",
    "VectorizeTransformReward": "vectorize_reward",
    "ClipReward": "vectorize_reward",
    "ArrayConversion": "array_conversion",
    "JaxToNumpy": "array_conversion",
    "JaxToTorch": "array_conversion",
    "NumpyToTorch": "array_conversion",
}


def __getattr__(name: str) -> Any:
    if name in _MODULE_BY_ATTR:
        import importlib

        module = importlib.import_module(f"gymnasium_tpu_torch.wrappers.vector.{_MODULE_BY_ATTR[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
