"""PyTorch/CUDA port of gymnasium_tpu.

The package mirrors the JAX package's public surface (spaces, the
``Env``/``Wrapper`` protocol, the functional API, the registry with
``make``/``make_vec``, vector envs and wrappers) and its module layout, but
it imports only ``torch`` and ``numpy``. ``make_vec(id)`` returns a
:class:`~gymnasium_tpu_torch.vector.TorchVectorEnv` over the id's functional
env. Entry points run on CUDA unless the caller asks for the CPU
(``make(id, device="cpu")``, ``make_vec(id, vector_kwargs={"device":
"cpu"})``); without a card and without that request they raise instead of
falling back to the CPU. Importing the package builds no kernel.
"""

from gymnasium_tpu_torch import error, logger, spaces
from gymnasium_tpu_torch.core import (
    ActionWrapper,
    ActType,
    Env,
    ObservationWrapper,
    ObsType,
    RewardWrapper,
    Wrapper,
)
from gymnasium_tpu_torch.functional import FuncEnv
from gymnasium_tpu_torch.spaces import Space
from gymnasium_tpu_torch.utils.device import resolve_device

__version__ = "0.1.0"

__all__ = [
    "Env",
    "Wrapper",
    "ObservationWrapper",
    "RewardWrapper",
    "ActionWrapper",
    "Space",
    "FuncEnv",
    "spaces",
    "error",
    "logger",
    "envs",
    "vector",
    "wrappers",
    "utils",
    "register",
    "make",
    "make_vec",
    "spec",
    "registry",
    "pprint_registry",
    "register_envs",
    "VectorizeMode",
    "experimental",
    "VectorEnv",
    "VectorWrapper",
    "VectorObservationWrapper",
    "VectorActionWrapper",
    "VectorRewardWrapper",
    "resolve_device",
    "__version__",
]


def __getattr__(name):
    # The registry and vector layers import lazily, so that space-only and
    # functional-only users pay for neither.
    if name in (
        "register",
        "make",
        "make_vec",
        "spec",
        "registry",
        "pprint_registry",
        "register_envs",
        "VectorizeMode",
    ):
        import gymnasium_tpu_torch.envs  # noqa: F401  (populates the registry)
        from gymnasium_tpu_torch.envs import registration

        return getattr(registration, name)
    if name in (
        "VectorEnv",
        "VectorWrapper",
        "VectorObservationWrapper",
        "VectorActionWrapper",
        "VectorRewardWrapper",
    ):
        from gymnasium_tpu_torch import vector

        return getattr(vector, name)
    if name in ("envs", "vector", "wrappers", "utils", "functional", "experimental"):
        import importlib

        return importlib.import_module(f"gymnasium_tpu_torch.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
