"""Utility subpackage of the torch port (counterpart of the JAX package's
``utils``; parity: reference gymnasium/utils/__init__.py).

The env checkers, ``play`` and the step-API converters are not ported yet;
asking for one raises ``AttributeError``.
"""

from gymnasium_tpu_torch.utils import seeding
from gymnasium_tpu_torch.utils.colorize import colorize
from gymnasium_tpu_torch.utils.ezpickle import EzPickle
from gymnasium_tpu_torch.utils.record_constructor import RecordConstructorArgs

__all__ = [
    "EzPickle",
    "RecordConstructorArgs",
    "colorize",
    "seeding",
]


def __getattr__(name):
    # The video and throughput helpers import lazily.
    import importlib

    lazy = {
        "save_video": "save_video",
        "capped_cubic_video_schedule": "save_video",
        "benchmark_step": "performance",
        "benchmark_init": "performance",
        "benchmark_render": "performance",
        "benchmark_compiled_rollout": "performance",
    }
    if name in lazy:
        module = importlib.import_module(f"gymnasium_tpu_torch.utils.{lazy[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
