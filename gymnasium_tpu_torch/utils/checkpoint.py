"""Checkpoint and resume of env and training state (counterpart of the JAX
package's ``utils/checkpoint.py``).

JAX saves a pytree through orbax, or else as one ``.npz`` of its leaves with
the pickled treedef. The port writes the ``.npz`` form with a structure
record of its own (JSON, no pickle), so ``np.load(path, allow_pickle=False)``
reads every leaf. A tree is made of tensors, numpy arrays and scalars,
python scalars and strings, dicts, lists, tuples and NamedTuples, and the
live objects a :class:`~gymnasium_tpu_torch.train.ppo.PPOState` holds:

- a tensor is saved with its dtype and device, by its bits: a dtype numpy
  lacks (bfloat16, the float8 kinds) as an unsigned integer view of the same
  width;
- a ``torch.Generator`` by ``get_state()`` and its device; leaves that are
  one generator stay one generator;
- an ``nn.Module`` by its ``state_dict``, a ``torch.optim.Optimizer`` by its
  ``state_dict`` (its ``step`` tensors and ``param_groups`` included).

A module or an optimizer cannot be rebuilt from a file, so restoring a tree
that holds one loads into the objects of a ``template`` of the same
structure, such as a fresh ``init_ppo``'s state. Any other tree restores
without one, each tensor and generator to the device it was saved from.
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Any

import numpy as np
import torch

__all__ = ["save_pytree", "restore_pytree"]

_UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name.removeprefix("torch."), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown torch dtype {name!r}")
    return dtype


class _Writer:
    """Flattens a tree into a JSON-able record and a list of numpy leaves."""

    def __init__(self):
        self.leaves: list[np.ndarray] = []
        self.generators: dict[int, int] = {}

    def leaf(self, array: np.ndarray) -> int:
        self.leaves.append(array)
        return len(self.leaves) - 1

    def tensor(self, t: torch.Tensor) -> dict:
        host = t.detach().to("cpu").contiguous()
        record = {"t": "tensor", "dtype": str(t.dtype), "device": str(t.device)}
        try:
            array = host.numpy()
        except TypeError:
            # numpy has no such dtype: keep the bits as unsigned integers
            width = host.element_size()
            array = host.view(_SIGNED[width]).numpy().view(_UNSIGNED[width])
            record["view"] = True
        record["i"] = self.leaf(array)
        return record

    def node(self, x: Any) -> dict:
        if isinstance(x, torch.Tensor):
            return self.tensor(x)
        if isinstance(x, torch.Generator):
            if id(x) in self.generators:
                return {"t": "same_generator", "i": self.generators[id(x)]}
            record = {"t": "generator", "device": str(x.device), "i": self.leaf(x.get_state().numpy())}
            self.generators[id(x)] = record["i"]
            return record
        if isinstance(x, torch.nn.Module):
            return {"t": "module", "state": self.node(dict(x.state_dict()))}
        if isinstance(x, torch.optim.Optimizer):
            return {"t": "optimizer", "state": self.node(x.state_dict())}
        if isinstance(x, np.ndarray):
            if x.dtype == object:
                raise TypeError("cannot save a numpy array of objects")
            return {"t": "ndarray", "i": self.leaf(x)}
        if isinstance(x, np.generic):
            return {"t": "np_scalar", "i": self.leaf(np.asarray(x))}
        if x is None or isinstance(x, (bool, int, float, str)):
            return {"t": "value", "v": x}
        if isinstance(x, dict):
            return {"t": "dict", "keys": [self.node(k) for k in x], "items": [self.node(v) for v in x.values()]}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            cls = type(x)
            return {"t": "namedtuple", "cls": f"{cls.__module__}:{cls.__qualname__}",
                    "items": [self.node(v) for v in x]}
        if isinstance(x, (list, tuple)):
            return {"t": type(x).__name__, "items": [self.node(v) for v in x]}
        raise TypeError(f"cannot save a leaf of type {type(x).__name__}")


def save_pytree(path: str, tree: Any) -> str:
    """Save ``tree`` to one ``.npz`` file; returns the path written (``.npz``
    appended when missing)."""
    writer = _Writer()
    structure = writer.node(tree)
    path = _npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez_compressed(
        path,
        structure=np.frombuffer(json.dumps(structure).encode(), dtype=np.uint8),
        **{f"leaf_{i}": leaf for i, leaf in enumerate(writer.leaves)},
    )
    return path


def _namedtuple_class(name: str):
    module, qualname = name.split(":")
    cls = importlib.import_module(module)
    for part in qualname.split("."):
        cls = getattr(cls, part)
    if not (isinstance(cls, type) and issubclass(cls, tuple) and hasattr(cls, "_fields")):
        raise ValueError(f"{name} is not a NamedTuple class")
    return cls


class _Reader:
    """Rebuilds a tree from its record and leaves, into ``template``'s
    objects where one is given."""

    def __init__(self, data):
        self.data = data
        self.generators: dict[int, torch.Generator] = {}

    def tensor(self, record: dict, like) -> torch.Tensor:
        array = self.data[f"leaf_{record['i']}"]
        dtype = _torch_dtype(record["dtype"])
        if record.get("view"):
            t = torch.from_numpy(array.view(np.dtype(f"i{array.itemsize}"))).view(dtype)
        else:
            t = torch.from_numpy(array if array.flags.c_contiguous else array.copy())
        if t.dtype != dtype:
            raise ValueError(f"leaf {record['i']}: {t.dtype} in the file, {dtype} in its record")
        device = like.device if isinstance(like, torch.Tensor) else torch.device(record["device"])
        return t.to(device)

    def node(self, record: dict, like=None) -> Any:
        kind = record["t"]
        if kind == "tensor":
            return self.tensor(record, like)
        if kind == "same_generator":
            return self.generators[record["i"]]
        if kind == "generator":
            gen = like if isinstance(like, torch.Generator) else torch.Generator(device=record["device"])
            gen.set_state(torch.from_numpy(self.data[f"leaf_{record['i']}"].copy()))
            self.generators[record["i"]] = gen
            return gen
        if kind in ("module", "optimizer"):
            want = torch.nn.Module if kind == "module" else torch.optim.Optimizer
            if not isinstance(like, want):
                raise TypeError(
                    f"a {kind} cannot be rebuilt from a file: restore into a template that holds one "
                    f"(got {type(like).__name__})"
                )
            like.load_state_dict(self.node(record["state"], None))
            return like
        if kind == "ndarray":
            return np.array(self.data[f"leaf_{record['i']}"])
        if kind == "np_scalar":
            return self.data[f"leaf_{record['i']}"][()]
        if kind == "value":
            return record["v"]
        if kind == "dict":
            keys = [self.node(k) for k in record["keys"]]
            if like is not None and (not isinstance(like, dict) or list(like) != keys):
                raise ValueError(f"the template's dict keys {list(like) if isinstance(like, dict) else like!r} "
                                 f"differ from the file's {keys}")
            return {k: self.node(v, None if like is None else like[k]) for k, v in zip(keys, record["items"])}
        items = record["items"]
        if like is not None and (not isinstance(like, (list, tuple)) or len(like) != len(items)):
            raise ValueError(f"the template has {type(like).__name__} where the file has a {kind} of {len(items)}")
        values = [self.node(v, None if like is None else like[i]) for i, v in enumerate(items)]
        if kind == "namedtuple":
            cls = type(like) if like is not None else _namedtuple_class(record["cls"])
            return cls(*values)
        return tuple(values) if kind == "tuple" else values


def restore_pytree(path: str, template: Any = None) -> Any:
    """Restore a tree written by :func:`save_pytree`.

    Without ``template`` each tensor and generator returns to the device it
    was saved from. With one (a tree of the same structure), tensors go to
    the devices of the template's tensors, generators, modules and
    optimizers are loaded in place into the template's own, and the
    template's NamedTuple classes are used. A tree that holds a module or an
    optimizer needs a template.
    """
    with np.load(_npz_path(path), allow_pickle=False) as data:
        structure = json.loads(data["structure"].tobytes().decode())
        return _Reader(data).node(structure, template)
