"""Helpers that hold values and spaces of the torch port against the JAX package's."""

from __future__ import annotations

import io
import pickle

import numpy as np
import torch


def assert_same(got, want, path: str = "x") -> None:
    """``got`` (the port's) equals ``want`` (JAX's) exactly: the same
    structure, types of containers, dtypes, shapes and values. Tensors and
    JAX arrays compare as numpy arrays."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), f"{path}: keys {list(got)} vs {list(want)}"
        for key in want:
            assert_same(got[key], want[key], f"{path}[{key!r}]")
        return
    if type(want).__name__ == "GraphInstance":
        assert type(got).__name__ == "GraphInstance", f"{path}: {type(got)}"
        for field in ("nodes", "edges", "edge_links"):
            a, b = getattr(got, field), getattr(want, field)
            assert (a is None) == (b is None), f"{path}.{field}"
            if b is not None:
                assert_same(a, b, f"{path}.{field}")
        return
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), f"{path}: {type(got)} {type(want)}"
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{path}[{i}]")
        return
    if isinstance(want, str) or want is None:
        assert got == want, f"{path}: {got!r} vs {want!r}"
        return
    a = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    b = np.asarray(want)
    assert a.dtype == b.dtype and a.shape == b.shape, f"{path}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
    np.testing.assert_array_equal(a, b, err_msg=path)


def assert_same_space(got, want, path: str = "space") -> None:
    """The port's space ``got`` is JAX's ``want``: the same class name,
    repr, shape and dtype, the same bounds, and the same subspaces."""
    assert type(got).__name__ == type(want).__name__, f"{path}: {type(got)} vs {type(want)}"
    assert repr(got) == repr(want), f"{path}: {got!r} vs {want!r}"
    assert got.shape == want.shape and got.dtype == want.dtype, f"{path}"
    for field in ("low", "high", "nvec", "start", "n"):
        if hasattr(want, field) and isinstance(getattr(want, field), (np.ndarray, np.generic, int)):
            assert_same(getattr(got, field), getattr(want, field), f"{path}.{field}")
    for field in ("spaces", "node_space", "edge_space", "feature_space"):
        sub = getattr(want, field, None)
        if isinstance(sub, dict):
            assert list(got.spaces) == list(sub), path
            for key in sub:
                assert_same_space(got.spaces[key], sub[key], f"{path}.{key}")
        elif isinstance(sub, tuple):
            assert len(getattr(got, field)) == len(sub), path
            for i, (a, b) in enumerate(zip(getattr(got, field), sub)):
                assert_same_space(a, b, f"{path}[{i}]")
        elif sub is not None:
            assert_same_space(getattr(got, field), sub, f"{path}.{field}")
        else:
            assert getattr(got, field, None) is None, f"{path}.{field}"


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "gymnasium_tpu" or module.startswith("gymnasium_tpu."):
            module = "gymnasium_tpu_torch" + module[len("gymnasium_tpu"):]
        return super().find_class(module, name)


def to_port(obj):
    """The port's counterpart of a JAX package space (or sample): the object
    pickled and loaded with every class of the JAX package read from the
    port, so its generator's state comes along too."""
    return _PortUnpickler(io.BytesIO(pickle.dumps(obj))).load()


def assert_identical(got, want, path: str = "x") -> None:
    """Stricter than :func:`assert_same`, for host values: containers of the
    same types, numpy arrays of the same dtype, shape and bytes, and
    scalars of the same type and bits (NaN equals NaN, -0.0 differs from
    0.0). Object arrays compare element by element."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), f"{path}: keys {list(got)} vs {list(want)}"
        for key in want:
            assert_identical(got[key], want[key], f"{path}[{key!r}]")
        return
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), f"{path}: {type(got)} {type(want)}"
        for i, (a, b) in enumerate(zip(got, want)):
            assert_identical(a, b, f"{path}[{i}]")
        return
    assert type(got) is type(want), f"{path}: {type(got)} vs {type(want)}"
    if isinstance(want, np.ndarray) and want.dtype == object:
        # a vector env's ``final_obs`` and the like: compare what each holds
        assert got.dtype == want.dtype and got.shape == want.shape, f"{path}: {got.dtype}{got.shape} vs {want.shape}"
        for index in np.ndindex(want.shape):
            assert_identical(got[index], want[index], f"{path}[{index}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape, f"{path}: {got.dtype}{got.shape} vs {want.dtype}{want.shape}"
        assert got.tobytes() == want.tobytes(), f"{path}: {got!r} vs {want!r}"
    elif isinstance(want, float):
        assert np.float64(got).tobytes() == np.float64(want).tobytes(), f"{path}: {got!r} vs {want!r}"
    else:
        assert got == want, f"{path}: {got!r} vs {want!r}"


def wrapper_names(env) -> list[str]:
    """The class names of ``env``'s wrappers, outermost first, then the env's."""
    names = []
    while hasattr(env, "env"):
        names.append(type(env).__name__)
        env = env.env
    return names + [type(env).__name__]


def assert_host_env_matches_jax(port, ref, steps: int, seed: int = 0, action_seed: int = 1, render_every: int = 0,
                                options=None) -> int:
    """A host env made by the port (``port``) against the JAX package's
    (``ref``), both through ``make``: the same wrappers, step limit and
    spaces, then ``reset(seed=seed, options=options)`` and ``steps`` steps
    of one action stream from ``ref``'s seeded ``action_space.sample()``,
    with a plain ``reset()`` after each episode's end. Every output (obs,
    reward, flags, info) is identical, and so is ``unwrapped.np_random``'s
    state after every reset and step; every ``render_every``-th step both
    renders are identical. Returns the episodes ended."""
    assert wrapper_names(port) == wrapper_names(ref)
    assert port.spec.max_episode_steps == ref.spec.max_episode_steps
    assert_same_space(port.action_space, ref.action_space)
    assert_same_space(port.observation_space, ref.observation_space)

    def same_generators(path):
        got, want = port.unwrapped.np_random.bit_generator.state, ref.unwrapped.np_random.bit_generator.state
        assert got == want, f"{path}: the generators differ"

    assert_identical(port.reset(seed=seed, options=options), ref.reset(seed=seed, options=options), "reset")
    same_generators("reset")
    ref.action_space.seed(action_seed)
    episodes = 0
    for k in range(steps):
        action = ref.action_space.sample()
        want = ref.step(action)
        assert_identical(port.step(action), want, f"step {k}")
        same_generators(f"step {k}")
        if render_every and k % render_every == 0:
            assert_identical(port.render(), ref.render(), f"render at step {k}")
        if want[2] or want[3]:
            episodes += 1
            assert_identical(port.reset(), ref.reset(), f"reset after step {k}")
            same_generators(f"reset after step {k}")
    return episodes
