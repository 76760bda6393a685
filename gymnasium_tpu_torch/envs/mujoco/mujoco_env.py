"""Robot models of the MuJoCo-class envs.

Counterpart of ``load_model`` in the JAX package's ``envs/mujoco/mujoco_env.py``
for the compiled ``.npz`` specs. The port keeps its own copy of those files,
byte for byte the JAX package's, in ``models/`` beside this module
(:data:`MODEL_DIR`), so an installed port reads nothing of the JAX package.
Compiling an ``.xml`` MJCF file is not ported yet.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np

from gymnasium_tpu_torch.physics.articulated import ArticulatedModel, BodySpec, JointSpec

__all__ = ["MODEL_DIR", "load_model"]

#: The compiled robot specs, ``<name>.npz``.
MODEL_DIR = Path(__file__).resolve().parent / "models"


def load_model(name: str) -> tuple[ArticulatedModel, dict]:
    """``(model, meta)`` of the compiled robot ``name`` (e.g. ``"half_cheetah"``)."""
    if name.endswith(".xml"):
        raise NotImplementedError("compiling MJCF (.xml) models is not ported yet")
    return _load_npz_model(name)


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
