"""Utility subpackage of the torch port (counterpart of the JAX package's
``utils``; parity: reference gymnasium/utils/__init__.py)."""

from gymnasium_tpu_torch.utils import seeding
from gymnasium_tpu_torch.utils.colorize import colorize
from gymnasium_tpu_torch.utils.ezpickle import EzPickle
from gymnasium_tpu_torch.utils.record_constructor import RecordConstructorArgs

# A function named as its own module is bound here, not lazily: an import of
# the submodule (env_checker imports data_equivalence) would otherwise leave
# the module object under the function's name, as it does in the JAX package.
from gymnasium_tpu_torch.utils.data_equivalence import data_equivalence
from gymnasium_tpu_torch.utils.play import play
from gymnasium_tpu_torch.utils.save_video import save_video
from gymnasium_tpu_torch.utils.step_api_compatibility import step_api_compatibility

__all__ = [
    "EzPickle",
    "RecordConstructorArgs",
    "colorize",
    "seeding",
]


def __getattr__(name):
    # The checkers and the benchmarks import lazily.
    import importlib

    lazy = {
        "check_env": "env_checker",
        "check_environments_match": "env_match",
        "PlayPlot": "play",
        "PlayableGame": "play",
        "capped_cubic_video_schedule": "save_video",
        "benchmark_step": "performance",
        "benchmark_init": "performance",
        "benchmark_render": "performance",
        "benchmark_compiled_rollout": "performance",
        "convert_to_terminated_truncated_step_api": "step_api_compatibility",
        "convert_to_done_step_api": "step_api_compatibility",
    }
    if name in lazy:
        module = importlib.import_module(f"gymnasium_tpu_torch.utils.{lazy[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
