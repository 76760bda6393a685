"""Robot models of the MuJoCo-class envs.

Counterpart of ``load_model`` in the JAX package's ``envs/mujoco/mujoco_env.py``.
A robot's name loads its compiled ``.npz`` spec: the port keeps its own copy
of those files, byte for byte the JAX package's, in ``models/`` beside this
module (:data:`MODEL_DIR`), so an installed port reads nothing of the JAX
package. A name ending in ``.xml`` is an MJCF file, compiled by
:func:`~gymnasium_tpu_torch.envs.mujoco.mjcf.compile_mjcf` once a resolved
path. :func:`kernel_name` names the articulated kernel a model is built as.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import re
from pathlib import Path

import numpy as np

from gymnasium_tpu_torch.physics.articulated import ArticulatedModel, BodySpec, JointSpec

__all__ = ["MODEL_DIR", "load_model", "resolve_xml", "kernel_name"]

#: The compiled robot specs, ``<name>.npz``.
MODEL_DIR = Path(__file__).resolve().parent / "models"


def resolve_xml(name: str) -> str:
    """The absolute path of the ``.xml`` model ``name``, as upstream's
    ``expand_model_path`` finds it: an absolute or ``~`` path as given, else
    relative to the working directory, else under the ``MJCF_ASSET_DIR``
    environment variable, else under :data:`MODEL_DIR`. Raises ``OSError``
    where none exists."""
    path = os.path.expanduser(name)
    if os.path.isabs(path) and os.path.exists(path):
        return path
    if os.path.exists(path):
        return os.path.abspath(path)
    for base in (os.environ.get("MJCF_ASSET_DIR"), str(MODEL_DIR)):
        if base:
            candidate = os.path.join(base, name)
            if os.path.exists(candidate):
                return os.path.abspath(candidate)
    raise OSError(f"MJCF model file {name!r} does not exist")


def load_model(name: str) -> tuple[ArticulatedModel, dict]:
    """``(model, meta)`` of the robot ``name`` (e.g. ``"half_cheetah"``), or of
    the MJCF file ``name`` (``"*.xml"``), compiled once a resolved path."""
    if name.endswith(".xml"):
        # resolved before the cache: a relative name depends on the working directory
        return _compile_xml_model(resolve_xml(name))
    return _load_npz_model(name)


@functools.lru_cache(maxsize=32)
def _compile_xml_model(path: str) -> tuple[ArticulatedModel, dict]:
    from gymnasium_tpu_torch.envs.mujoco.mjcf import compile_mjcf

    return compile_mjcf(path)


def _model_digest(model: ArticulatedModel) -> str:
    """A digest of every field of ``model``: its arrays' dtypes, shapes and bytes."""
    digest = hashlib.sha256()

    def add(value):
        if isinstance(value, tuple) and hasattr(value, "_fields"):
            for field in value:
                add(field)
            return
        array = np.ascontiguousarray(np.asarray(value))
        digest.update(f"{array.dtype.str}{array.shape}".encode())
        digest.update(array.tobytes())

    add(model)
    return digest.hexdigest()


def kernel_name(name: str) -> str:
    """The name the articulated kernel of model ``name`` is generated, built
    and counted under: a robot's own name, or for an ``.xml`` model
    ``xml_<file stem>_<digest>``, the digest of its resolved path and its
    compiled arrays. It is a C identifier and a file name; two XML files
    never share it, and it never picks up a robot's warp layout."""
    if not name.endswith(".xml"):
        return name
    path = resolve_xml(name)
    model, _ = load_model(path)
    stem = re.sub(r"\W", "_", Path(path).stem)
    digest = hashlib.sha256(f"{path}\n{_model_digest(model)}".encode()).hexdigest()[:16]
    return f"xml_{stem}_{digest}"


@functools.lru_cache(maxsize=32)
def _load_npz_model(name: str) -> tuple[ArticulatedModel, dict]:
    data = np.load(MODEL_DIR / f"{name}.npz")
    meta = json.loads(bytes(data["meta_json"]).decode())

    def optional(key, default):
        return data[key] if key in data else default

    model = ArticulatedModel(
        bodies=BodySpec(
            parent=data["bodies_parent"],
            pos=data["bodies_pos"],
            quat=data["bodies_quat"],
            mass=data["bodies_mass"],
            com=data["bodies_com"],
            inertia=data["bodies_inertia"],
            dof_start=data["bodies_dof_start"],
            dof_count=data["bodies_dof_count"],
        ),
        joints=JointSpec(
            body=data["joints_body"],
            jtype=data["joints_jtype"],
            axis=data["joints_axis"],
            anchor=data["joints_anchor"],
            damping=data["joints_damping"],
            limited=data["joints_limited"],
            lower=data["joints_lower"],
            upper=data["joints_upper"],
            stiffness=data["joints_stiffness"],
            armature=data["joints_armature"],
            ref=data["joints_ref"],
        ),
        contact_body=data["contact_body"],
        contact_pos=data["contact_pos"],
        contact_radius=data["contact_radius"],
        contact_stiffness=optional("contact_stiffness", 100000.0),
        act_dof=data["act_dof"],
        act_gear=data["act_gear"],
        act_ctrlrange=data["act_ctrlrange"],
        gravity=float(data["gravity"]),
        timestep=float(data["timestep"]),
        fluid_density=float(optional("fluid_density", 0.0)),
        fluid_viscosity=float(optional("fluid_viscosity", 0.0)),
        ground_z=float(optional("ground_z", 0.0)),
        root_free=bool(meta.get("free_root", False)),
        site_body=optional("site_body", np.zeros((0,), np.int32)),
        site_pos=optional("site_pos", np.zeros((0, 3))),
    )
    return model, meta
