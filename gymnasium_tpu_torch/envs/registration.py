"""Environment registry and factory: ``register``, ``make``, ``make_vec``.

Copy of the JAX package's ``envs/registration.py``, which follows Gymnasium's
(gymnasium/envs/registration.py:60-985): EnvSpec / WrapperSpec dataclasses
with JSON round-trip, namespaced id parsing and version resolution, the
``make`` wrapper onion (PassiveEnvChecker → OrderEnforcing → TimeLimit →
additional wrappers), and ``make_vec``.

Where the JAX package has its ``jax`` mode, the port has
``vectorization_mode="torch"``: a :class:`~gymnasium_tpu_torch.vector.TorchVectorEnv`
over the functional env a spec's ``torch_entry_point`` names, on CUDA unless
``vector_kwargs`` asks for the CPU. It is the default wherever a spec has
one. ``make(id)`` builds the host env class every string ``entry_point``
names, and the host vector envs (``sync``, ``async``) step such envs one by
one, with numpy batches: on the card for the MuJoCo-class, LunarLander and
BipedalWalker ids unless the caller asks for the CPU.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import importlib.metadata
import json
import re
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch import Env, Wrapper, error, logger

__all__ = [
    "EnvSpec",
    "WrapperSpec",
    "registry",
    "current_namespace",
    "register",
    "make",
    "make_vec",
    "spec",
    "pprint_registry",
    "register_envs",
    "namespace",
    "VectorizeMode",
    "parse_env_id",
    "get_env_id",
    "find_highest_version",
    "load_env_creator",
]

ENV_ID_RE = re.compile(
    r"^(?:(?P<namespace>[\w:-]+)\/)?(?:(?P<name>[\w:.-]+?))(?:-v(?P<version>\d+))?$"
)


class VectorizeMode(Enum):
    """How ``make_vec`` builds the vector env (reference registration.py:247)."""

    ASYNC = "async"
    SYNC = "sync"
    VECTOR_ENTRY_POINT = "vector_entry_point"
    TORCH = "torch"


def parse_env_id(env_id: str) -> tuple[str | None, str, int | None]:
    """Parse ``[namespace/]name[-vV]`` into its components."""
    match = ENV_ID_RE.fullmatch(env_id)
    if not match:
        raise error.Error(
            f"Malformed environment ID: {env_id}. (Currently all IDs must be of the form [namespace/](env-name)-v(version). (namespace is optional))"
        )
    ns, name, version = match.group("namespace", "name", "version")
    if version is not None:
        version = int(version)
    return ns, name, version


def get_env_id(ns: str | None, name: str, version: int | None) -> str:
    """Assemble an env id from components."""
    full_name = name
    if version is not None:
        full_name += f"-v{version}"
    if ns is not None:
        full_name = ns + "/" + full_name
    return full_name


@dataclass
class WrapperSpec:
    """Specification to reconstruct a wrapper (reference registration.py:60)."""

    name: str
    entry_point: str
    kwargs: dict[str, Any] | None


@dataclass
class EnvSpec:
    """Specification of an environment id (reference registration.py:74-190)."""

    id: str
    entry_point: Callable | str | None = field(default=None)

    # Environment attributes
    reward_threshold: float | None = field(default=None)
    nondeterministic: bool = field(default=False)

    # Wrappers
    max_episode_steps: int | None = field(default=None)
    order_enforce: bool = field(default=True)
    disable_env_checker: bool = field(default=False)

    # Environment arguments
    kwargs: dict = field(default_factory=dict)

    # post-init attributes
    namespace: str | None = field(init=False)
    name: str = field(init=False)
    version: int | None = field(init=False)

    # applied wrappers
    additional_wrappers: tuple[WrapperSpec, ...] = field(default_factory=tuple)

    # Vectorized environment entry points
    vector_entry_point: Callable | str | None = field(default=None)
    # A FuncEnv entry point run by TorchVectorEnv.
    torch_entry_point: Callable | str | None = field(default=None)

    def __post_init__(self):
        self.namespace, self.name, self.version = parse_env_id(self.id)

    def make(self, **kwargs: Any) -> Env:
        """Instantiate this spec through :func:`make`."""
        return make(self, **kwargs)

    def to_json(self) -> str:
        """Serialize to JSON (callable entry points are not serializable)."""
        env_spec_dict = dataclasses.asdict(self)
        env_spec_dict.pop("namespace")
        env_spec_dict.pop("name")
        env_spec_dict.pop("version")

        for key, value in env_spec_dict.items():
            if callable(value):
                raise ValueError(
                    f"Callable found in {self.id} for {key} attribute with value={value}. Currently, Gymnasium does not support serialising callables."
                )
        return json.dumps(env_spec_dict)

    @staticmethod
    def from_json(json_env_spec: str) -> EnvSpec:
        """Deserialize from :meth:`to_json` output."""
        parsed = json.loads(json_env_spec)
        applied_wrapper_specs: list[WrapperSpec] = []
        for wrapper_spec_json in parsed.pop("additional_wrappers", []):
            try:
                applied_wrapper_specs.append(WrapperSpec(**wrapper_spec_json))
            except Exception as e:
                raise ValueError(f"An issue occurred when trying to make {wrapper_spec_json} a WrapperSpec") from e
        try:
            env_spec = EnvSpec(**parsed)
            env_spec.additional_wrappers = tuple(applied_wrapper_specs)
        except Exception as e:
            raise ValueError(f"An issue occurred when trying to make {parsed} an EnvSpec") from e
        return env_spec

    def pprint(
        self,
        disable_print: bool = False,
        include_entry_points: bool = False,
        print_all: bool = False,
    ) -> str | None:
        """Pretty print the spec."""
        output = f"id={self.id}"
        if print_all or include_entry_points:
            output += f"\nentry_point={self.entry_point}"
        if print_all or self.reward_threshold is not None:
            output += f"\nreward_threshold={self.reward_threshold}"
        if print_all or self.nondeterministic is not False:
            output += f"\nnondeterministic={self.nondeterministic}"
        if print_all or self.max_episode_steps is not None:
            output += f"\nmax_episode_steps={self.max_episode_steps}"
        if print_all or self.order_enforce is not True:
            output += f"\norder_enforce={self.order_enforce}"
        if print_all or self.disable_env_checker is not False:
            output += f"\ndisable_env_checker={self.disable_env_checker}"
        if print_all or self.additional_wrappers:
            wrapper_output: list[str] = []
            for wrapper_spec in self.additional_wrappers:
                if include_entry_points:
                    wrapper_output.append(
                        f"\n\tname={wrapper_spec.name}, entry_point={wrapper_spec.entry_point}, kwargs={wrapper_spec.kwargs}"
                    )
                else:
                    wrapper_output.append(f"\n\tname={wrapper_spec.name}, kwargs={wrapper_spec.kwargs}")
            if len(wrapper_output) == 0:
                output += "\nadditional_wrappers=[]"
            else:
                output += f"\nadditional_wrappers=[{','.join(wrapper_output)}\n]"
        if disable_print:
            return output
        print(output)
        return None


# --- registry -------------------------------------------------------------

registry: dict[str, EnvSpec] = {}
current_namespace: str | None = None


def _check_namespace_exists(ns: str | None):
    if ns is None:
        return
    namespaces = {spec_.namespace for spec_ in registry.values() if spec_.namespace is not None}
    if ns in namespaces:
        return
    suggestion = _closest(ns, namespaces)
    suggestion_msg = f"Did you mean: `{suggestion}`?" if suggestion else f"Have you installed the proper package for {ns}?"
    raise error.NamespaceNotFound(f"Namespace {ns} not found. {suggestion_msg}")


def _closest(value: str, options) -> str | None:
    import difflib

    matches = difflib.get_close_matches(value, options, n=1)
    return matches[0] if matches else None


def _check_name_exists(ns: str | None, name: str):
    _check_namespace_exists(ns)
    names = {spec_.name for spec_ in registry.values() if spec_.namespace == ns}
    if name in names:
        return
    suggestion = _closest(name, names)
    namespace_msg = f" in namespace {ns}" if ns else ""
    suggestion_msg = f" Did you mean: `{suggestion}`?" if suggestion else ""
    raise error.NameNotFound(f"Environment `{name}` doesn't exist{namespace_msg}.{suggestion_msg}")


def _check_version_exists(ns: str | None, name: str, version: int | None):
    if get_env_id(ns, name, version) in registry:
        return
    _check_name_exists(ns, name)
    if version is None:
        return

    message = f"Environment version `v{version}` for environment `{get_env_id(ns, name, None)}` doesn't exist."
    versioned_specs = [
        spec_ for spec_ in registry.values()
        if spec_.namespace == ns and spec_.name == name and spec_.version is not None
    ]
    default_spec = registry.get(get_env_id(ns, name, None))
    if default_spec is not None:
        message += f" It provides the default version `{default_spec.id}`."
        if len(versioned_specs) == 0:
            raise error.DeprecatedEnv(message)

    latest_spec = max(versioned_specs, key=lambda s: s.version, default=None)  # type: ignore[arg-type]
    if latest_spec is not None and version > latest_spec.version:
        version_list_msg = ", ".join(f"`v{s.version}`" for s in sorted(versioned_specs, key=lambda s: s.version))
        message += f" It provides versioned environments: [ {version_list_msg} ]."
        raise error.VersionNotFound(message)
    if latest_spec is not None and version < latest_spec.version:
        raise error.DeprecatedEnv(
            f"Environment version v{version} for `{get_env_id(ns, name, None)}` is deprecated. Please use `{latest_spec.id}` instead."
        )


def find_highest_version(ns: str | None, name: str) -> int | None:
    """The highest registered version of ``[ns/]name``."""
    versions = [
        spec_.version
        for spec_ in registry.values()
        if spec_.namespace == ns and spec_.name == name and spec_.version is not None
    ]
    return max(versions, default=None)


@contextmanager
def namespace(ns: str):
    """Context manager under which all ``register`` calls use namespace ``ns``."""
    global current_namespace
    old_namespace = current_namespace
    current_namespace = ns
    try:
        yield
    finally:
        current_namespace = old_namespace


def register_envs(env_module) -> None:
    """No-op marker so IDEs see a plugin module import as used
    (reference registration.py:550)."""


def load_env_creator(name: str) -> Callable:
    """Import and return ``module:attr`` (reference registration.py:535)."""
    mod_name, attr_name = name.split(":")
    mod = importlib.import_module(mod_name)
    return getattr(mod, attr_name)


def _find_spec(env_id: str) -> EnvSpec:
    module, env_name = (None, env_id) if ":" not in env_id else env_id.split(":")
    if module is not None:
        try:
            importlib.import_module(module)
        except ModuleNotFoundError as e:
            raise ModuleNotFoundError(
                f"{e}. Environment registration via importing a module failed. Check whether '{module}' contains env registration and can be imported."
            ) from e

    env_spec = registry.get(env_name)
    ns, name, version = parse_env_id(env_name)
    latest_version = find_highest_version(ns, name)
    if version is not None and latest_version is not None and latest_version > version:
        logger.deprecation(
            f"The environment {env_name} is out of date. You should consider upgrading to version `v{latest_version}`."
        )
    if version is None and latest_version is not None:
        version = latest_version
        new_env_id = get_env_id(ns, name, version)
        env_spec = registry.get(new_env_id)
        logger.warn(f"Using the latest versioned environment `{new_env_id}` instead of the unversioned environment `{env_name}`.")

    if env_spec is None:
        _check_version_exists(ns, name, version)
        raise error.Error(f"No registered env with id: {env_name}")
    return env_spec


def register(
    id: str,
    entry_point: Callable | str | None = None,
    reward_threshold: float | None = None,
    nondeterministic: bool = False,
    max_episode_steps: int | None = None,
    order_enforce: bool = True,
    disable_env_checker: bool = False,
    additional_wrappers: tuple[WrapperSpec, ...] = (),
    vector_entry_point: Callable | str | None = None,
    torch_entry_point: Callable | str | None = None,
    kwargs: dict | None = None,
):
    """Register an environment id with the global registry."""
    assert (
        entry_point is not None or vector_entry_point is not None or torch_entry_point is not None
    ), "Either `entry_point` or `vector_entry_point` (or `torch_entry_point`) must be provided"
    global current_namespace
    ns, name, version = parse_env_id(id)

    if current_namespace is not None:
        kwargs_namespace = ns
        if kwargs_namespace is not None and kwargs_namespace != current_namespace:
            logger.warn(
                f"Custom namespace `{kwargs_namespace}` is being overridden by namespace `{current_namespace}`. "
                "If you are developing a plugin you shouldn't specify a namespace in `register` calls. "
                "The namespace is specified through the entry point key."
            )
        ns_id = current_namespace
    else:
        ns_id = ns

    full_env_id = get_env_id(ns_id, name, version)

    # versioned/unversioned conflict checks (reference registration.py:430-469)
    latest_versioned_spec = max(
        (
            env_spec
            for env_spec in registry.values()
            if env_spec.namespace == ns_id
            and env_spec.name == name
            and env_spec.version is not None
        ),
        key=lambda spec_: int(spec_.version),
        default=None,
    )
    unversioned_spec = next(
        (
            env_spec
            for env_spec in registry.values()
            if env_spec.namespace == ns_id
            and env_spec.name == name
            and env_spec.version is None
        ),
        None,
    )
    if unversioned_spec is not None and version is not None:
        raise error.RegistrationError(
            "Can't register the versioned environment "
            f"`{full_env_id}` when the unversioned environment "
            f"`{unversioned_spec.id}` of the same name already exists."
        )
    elif latest_versioned_spec is not None and version is None:
        raise error.RegistrationError(
            f"Can't register the unversioned environment `{full_env_id}` when the versioned environment "
            f"`{latest_versioned_spec.id}` of the same name already exists. Note: the default behavior is "
            "that `gym.make` with the unversioned environment will return the latest versioned environment"
        )

    if full_env_id in registry:
        logger.warn(f"Overriding environment {full_env_id} already in registry.")

    new_spec = EnvSpec(
        id=full_env_id,
        entry_point=entry_point,
        reward_threshold=reward_threshold,
        nondeterministic=nondeterministic,
        max_episode_steps=max_episode_steps,
        order_enforce=order_enforce,
        disable_env_checker=disable_env_checker,
        kwargs=kwargs if kwargs is not None else {},
        additional_wrappers=additional_wrappers,
        vector_entry_point=vector_entry_point,
        torch_entry_point=torch_entry_point,
    )
    registry[new_spec.id] = new_spec


def make(
    id: str | EnvSpec,
    max_episode_steps: int | None = None,
    disable_env_checker: bool | None = None,
    **kwargs: Any,
) -> Env:
    """Create an environment from its spec with the standard wrapper onion."""
    if isinstance(id, EnvSpec):
        env_spec = id
        if not hasattr(env_spec, "additional_wrappers"):
            logger.warn(f"The env spec passed to `make` does not have a `additional_wrappers`, set it to an empty tuple. Env_spec={env_spec}")
            env_spec.additional_wrappers = ()
    else:
        env_spec = _find_spec(id)

    assert isinstance(env_spec, EnvSpec)

    # kwargs resolution: registered kwargs overridden by call kwargs
    env_spec_kwargs = copy.deepcopy(env_spec.kwargs)
    env_spec_kwargs.update(kwargs)

    if env_spec.entry_point is None:
        raise error.Error(f"{env_spec.id} registered but entry_point is not specified")
    elif callable(env_spec.entry_point):
        env_creator = env_spec.entry_point
    else:
        env_creator = load_env_creator(env_spec.entry_point)

    # render-mode fallback (reference registration.py:708-732)
    render_mode = env_spec_kwargs.get("render_mode")
    apply_human_rendering = False
    apply_render_collection = False

    if render_mode is not None:
        try:
            render_modes = env_creator.metadata.get("render_modes", [])  # type: ignore[union-attr]
        except AttributeError:
            render_modes = []
        if render_mode == "human" and "human" not in render_modes and (
            "rgb_array" in render_modes or "rgb_array_list" in render_modes
        ):
            logger.warn(
                "You are trying to use 'human' rendering for an environment that doesn't natively support it. "
                "The HumanRendering wrapper is being applied to your environment."
            )
            apply_human_rendering = True
            env_spec_kwargs["render_mode"] = (
                "rgb_array" if "rgb_array" in render_modes else "rgb_array_list"
            )
        elif render_mode not in render_modes and render_mode.endswith("_list") and render_mode[: -len("_list")] in render_modes:
            env_spec_kwargs["render_mode"] = render_mode[: -len("_list")]
            apply_render_collection = True
        elif render_mode not in render_modes:
            logger.warn(
                f"The environment is being initialised with render_mode={render_mode!r} "
                f"that is not in the possible render_modes ({render_modes})."
            )

    try:
        env = env_creator(**env_spec_kwargs)
    except TypeError as e:
        if "got an unexpected keyword argument 'render_mode'" in str(e) and apply_human_rendering:
            raise error.Error(
                f"You passed render_mode='human' although {env_spec.id} doesn't implement human-rendering natively."
            ) from e
        raise

    # Set the minimal env spec for the inner env.
    env.unwrapped.spec = EnvSpec(
        id=env_spec.id,
        entry_point=env_spec.entry_point,
        reward_threshold=env_spec.reward_threshold,
        nondeterministic=env_spec.nondeterministic,
        max_episode_steps=None,
        order_enforce=False,
        disable_env_checker=True,
        kwargs=env_spec_kwargs,
        additional_wrappers=(),
        vector_entry_point=env_spec.vector_entry_point,
        torch_entry_point=env_spec.torch_entry_point,
    )

    # entry points may return an already-wrapped env; those wrappers must
    # prefix-match the spec's additional_wrappers (reference :780-797)
    assert env.spec is not None
    num_prior_wrappers = len(env.spec.additional_wrappers)
    if (
        num_prior_wrappers <= len(env_spec.additional_wrappers)
        and env_spec.additional_wrappers[:num_prior_wrappers]
        != env.spec.additional_wrappers
    ):
        for env_spec_wrapper_spec, recreated_wrapper_spec in zip(
            env_spec.additional_wrappers[:num_prior_wrappers],
            env.spec.additional_wrappers,
            strict=True,
        ):
            raise ValueError(
                f"The environment's wrapper spec {recreated_wrapper_spec} is different from the saved `EnvSpec` additional wrapper {env_spec_wrapper_spec}"
            )

    # wrapper onion, inside-out (reference registration.py:798-827)
    from gymnasium_tpu_torch.wrappers.common import OrderEnforcing, PassiveEnvChecker, TimeLimit

    if disable_env_checker is None:
        disable_env_checker = env_spec.disable_env_checker
    if not disable_env_checker:
        env = PassiveEnvChecker(env)
    if env_spec.order_enforce:
        env = OrderEnforcing(env)
    # max_episode_steps == -1 suppresses the TimeLimit wrapper entirely
    # (reference registration.py:809-813)
    if max_episode_steps != -1:
        if max_episode_steps is not None:
            env = TimeLimit(env, max_episode_steps)
        elif env_spec.max_episode_steps is not None:
            env = TimeLimit(env, env_spec.max_episode_steps)

    for wrapper_spec in env_spec.additional_wrappers[num_prior_wrappers:]:
        if wrapper_spec.kwargs is None:
            raise ValueError(
                f"{wrapper_spec.name} wrapper does not inherit from `gymnasium.utils.RecordConstructorArgs`, therefore, the wrapper cannot be recreated."
            )
        env = load_env_creator(wrapper_spec.entry_point)(env=env, **wrapper_spec.kwargs)

    if apply_human_rendering:
        from gymnasium_tpu_torch.wrappers.rendering import HumanRendering

        env = HumanRendering(env)
    elif apply_render_collection:
        from gymnasium_tpu_torch.wrappers.rendering import RenderCollection

        env = RenderCollection(env)

    return env


class SingleEnvFactory:
    """``make(env_spec, **kwargs)`` with ``wrappers`` applied: one sub-env of
    a ``sync`` or ``async`` vector env. An object of a module-level class, so
    the standard library pickles it for a spawned worker (a closure would
    need cloudpickle)."""

    def __init__(self, env_spec: EnvSpec, kwargs: dict[str, Any], wrappers: tuple[Callable[[Env], Wrapper], ...]):
        self.env_spec = env_spec
        self.kwargs = kwargs
        self.wrappers = wrappers

    def __call__(self) -> Env:
        single_kwargs = copy.deepcopy(self.kwargs)
        if len(self.wrappers) == 0:
            return make(copy.deepcopy(self.env_spec), **single_kwargs)
        env = make(copy.deepcopy(self.env_spec), disable_env_checker=True, **single_kwargs)
        for wrapper in self.wrappers:
            env = wrapper(env)
        return env


def make_vec(
    id: str | EnvSpec,
    num_envs: int = 1,
    vectorization_mode: VectorizeMode | str | None = None,
    vector_kwargs: dict[str, Any] | None = None,
    wrappers: tuple[Callable[[Env], Wrapper], ...] = (),
    **kwargs: Any,
):
    """Create a vector environment according to ``vectorization_mode``.

    Default mode: ``torch`` (a registered ``torch_entry_point`` FuncEnv run
    as a :class:`TorchVectorEnv`) where the spec has one and no render mode
    is asked for, else the env's own ``vector_entry_point``, else ``sync``.
    ``vector_kwargs`` go to ``TorchVectorEnv`` (``device``, ``seed``, ...);
    the vector env runs on CUDA unless they ask for the CPU. Wrap the result
    in vector wrappers (:class:`~gymnasium_tpu_torch.vector.VectorWrapper`)
    or pass functional wrappers through ``vector_kwargs["wrappers"]``.

    ``sync`` and ``async`` build each sub-env with ``make(id, **kwargs)``
    (``device="cpu"`` among the kwargs keeps a card env on the CPU) and go
    through ``vector_kwargs`` to :class:`~gymnasium_tpu_torch.vector.SyncVectorEnv`
    or :class:`~gymnasium_tpu_torch.vector.AsyncVectorEnv`. Sub-envs on the card
    in ``async`` mode need ``vector_kwargs={"context": "spawn"}``.
    """
    from gymnasium_tpu_torch.vector import AsyncVectorEnv, SyncVectorEnv

    if isinstance(id, EnvSpec):
        env_spec = id
    elif isinstance(id, str):
        env_spec = _find_spec(id)
    else:
        raise error.Error(f"Invalid id type: {type(id)}. Expected `str` or `EnvSpec`")

    env_spec = copy.deepcopy(env_spec)
    env_spec_kwargs = env_spec.kwargs
    # vectorization parameters recorded in a spec by a previous make_vec are
    # restored here so `make_vec(envs.spec)` roundtrips
    # (reference registration.py:873-881).
    env_spec.kwargs = dict()
    num_envs = env_spec_kwargs.pop("num_envs", num_envs)
    vectorization_mode = env_spec_kwargs.pop("vectorization_mode", vectorization_mode)
    if vector_kwargs is None or len(vector_kwargs) == 0:
        vector_kwargs = env_spec_kwargs.pop("vector_kwargs", vector_kwargs)
    else:
        env_spec_kwargs.pop("vector_kwargs", None)
    if wrappers is None or len(wrappers) == 0:
        wrappers = env_spec_kwargs.pop("wrappers", wrappers)
    else:
        env_spec_kwargs.pop("wrappers", None)
    env_spec_kwargs.update(kwargs)
    num_envs = int(num_envs)

    if vectorization_mode is None:
        # the device path cannot render; a requested render_mode falls back
        # to the reference's resolution order (vector entry point, else sync)
        wants_render = env_spec_kwargs.get("render_mode") is not None
        if env_spec.torch_entry_point is not None and not wants_render:
            vectorization_mode = VectorizeMode.TORCH
        elif env_spec.vector_entry_point is not None:
            vectorization_mode = VectorizeMode.VECTOR_ENTRY_POINT
        else:
            vectorization_mode = VectorizeMode.SYNC
    else:
        try:
            vectorization_mode = VectorizeMode(vectorization_mode)
        except ValueError:
            raise error.Error(
                f"Invalid vectorization mode: {vectorization_mode!r}, "
                f"valid modes: {[mode.value for mode in VectorizeMode]}"
            )
    assert isinstance(vectorization_mode, VectorizeMode)

    vector_kwargs = dict(vector_kwargs or {})

    create_single_env = SingleEnvFactory(env_spec, env_spec_kwargs, wrappers)

    copied_id = copy.deepcopy(env_spec)

    if vectorization_mode == VectorizeMode.SYNC:
        if env_spec.entry_point is None:
            raise error.Error(
                f"Cannot create vectorized environment for {env_spec.id} because it doesn't have an entry point defined."
            )
        env = SyncVectorEnv(
            env_fns=(create_single_env for _ in range(num_envs)),
            **vector_kwargs,
        )
    elif vectorization_mode == VectorizeMode.ASYNC:
        if env_spec.entry_point is None:
            raise error.Error(
                f"Cannot create vectorized environment for {env_spec.id} because it doesn't have an entry point defined."
            )
        env = AsyncVectorEnv(
            env_fns=[create_single_env for _ in range(num_envs)],
            **vector_kwargs,
        )
    elif vectorization_mode == VectorizeMode.VECTOR_ENTRY_POINT:
        if len(vector_kwargs) > 0:
            raise error.Error(
                f"Custom vector environment can be passed arguments only through kwargs and `vector_kwargs` is not empty ({vector_kwargs})"
            )
        elif len(wrappers) > 0:
            raise error.Error(
                f"Cannot use `vector_entry_point` vectorization mode with the wrappers argument ({wrappers})."
            )
        elif len(env_spec.additional_wrappers) > 0:
            raise error.Error(
                f"Cannot use `vector_entry_point` vectorization mode with the additional_wrappers parameter in spec being not empty ({env_spec.additional_wrappers})."
            )

        entry_point = env_spec.vector_entry_point
        if entry_point is None:
            raise error.Error(f"Cannot create vectorized environment for {id} because it doesn't have a vector entry point defined.")
        elif callable(entry_point):
            env_creator = entry_point
        else:
            env_creator = load_env_creator(entry_point)

        if env_spec.max_episode_steps is not None and "max_episode_steps" not in env_spec_kwargs:
            env_spec_kwargs["max_episode_steps"] = env_spec.max_episode_steps
        env = env_creator(num_envs=num_envs, **env_spec_kwargs)
    elif vectorization_mode == VectorizeMode.TORCH:
        entry_point = env_spec.torch_entry_point
        if entry_point is None:
            raise error.Error(f"Cannot create a torch vectorized environment for {env_spec.id} because it doesn't have a `torch_entry_point`.")
        elif callable(entry_point):
            func_env_creator = entry_point
        else:
            func_env_creator = load_env_creator(entry_point)
        if len(wrappers) > 0:
            raise error.Error("Cannot use `wrappers` with torch vectorization mode; use vector wrappers on the result instead.")

        from gymnasium_tpu_torch.vector.torch_vector_env import TorchVectorEnv

        # FuncEnv constructors take a single options dict.
        func_env = func_env_creator(env_spec_kwargs or None)
        if env_spec.max_episode_steps is not None and "max_episode_steps" not in vector_kwargs:
            vector_kwargs["max_episode_steps"] = env_spec.max_episode_steps
        env = TorchVectorEnv(func_env, num_envs=num_envs, **vector_kwargs)
    else:
        raise error.Error(f"Unknown vectorization mode: {vectorization_mode}")

    copied_id.kwargs = env_spec_kwargs.copy()
    # record the vectorization parameters so the spec roundtrips
    # (reference registration.py:967-976)
    if num_envs != 1:
        copied_id.kwargs["num_envs"] = num_envs
    copied_id.kwargs["vectorization_mode"] = vectorization_mode.value
    if vector_kwargs is not None and len(vector_kwargs) > 0:
        copied_id.kwargs["vector_kwargs"] = vector_kwargs
    if wrappers is not None and len(wrappers) > 0:
        copied_id.kwargs["wrappers"] = wrappers
    env.unwrapped.spec = copied_id

    # autoreset-mode metadata validation (reference registration.py:978-985)
    if "autoreset_mode" not in env.metadata:
        logger.warn(
            f"The VectorEnv ({env}) is missing AutoresetMode metadata, metadata={env.metadata}"
        )
    elif not isinstance(env.metadata["autoreset_mode"], gym.vector.AutoresetMode):
        logger.warn(
            f"The VectorEnv ({env}) metadata['autoreset_mode'] is not an instance of AutoresetMode, {type(env.metadata['autoreset_mode'])}."
        )
    return env


def spec(env_id: str) -> EnvSpec:
    """Retrieve the spec for ``env_id`` from the registry."""
    env_spec = registry.get(env_id)
    if env_spec is None:
        ns, name, version = parse_env_id(env_id)
        _check_version_exists(ns, name, version)
        raise error.Error(f"No registered env with id: {env_id}")
    assert isinstance(env_spec, EnvSpec)
    return env_spec


def pprint_registry(
    print_registry: dict[str, EnvSpec] | None = None,
    *,
    num_cols: int = 3,
    exclude_namespaces: list[str] | None = None,
    disable_print: bool = False,
) -> str | None:
    """Pretty print all env ids in the registry, grouped by namespace."""
    if print_registry is None:
        print_registry = registry

    # group env ids by namespace, deriving a pseudo-namespace from the entry
    # point module path when unset (reference registration.py:1033-1059)
    namespace_envs: dict[str, list[str]] = defaultdict(list)
    max_justify = float("-inf")
    for env_spec in print_registry.values():
        ns = env_spec.namespace
        if ns is None and isinstance(env_spec.entry_point, str):
            env_entry_point = re.sub(r":\w+", "", env_spec.entry_point)
            split_entry_point = env_entry_point.split(".")
            if len(split_entry_point) >= 3:
                ns = split_entry_point[2]
            elif len(split_entry_point) > 1:
                ns = split_entry_point[1]
            else:
                ns = env_spec.name
        namespace_envs[ns].append(env_spec.id)
        max_justify = max(max_justify, len(env_spec.name))

    output: list[str] = []
    for ns, env_ids in namespace_envs.items():
        if exclude_namespaces is not None and ns in exclude_namespaces:
            continue

        namespace_output = f"{'=' * 5} {ns} {'=' * 5}\n"
        for count, env_id in enumerate(sorted(env_ids), 1):
            namespace_output += env_id.ljust(max_justify) + " "
            if count % num_cols == 0:
                namespace_output = namespace_output.rstrip(" ")
                if count != len(env_ids):
                    namespace_output += "\n"
        output.append(namespace_output.rstrip(" "))

    if disable_print:
        return "\n".join(output)
    print("\n".join(output))
    return None
