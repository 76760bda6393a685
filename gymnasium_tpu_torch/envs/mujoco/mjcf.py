"""MJCF (MuJoCo XML) compiler to the articulated engine's model.

Counterpart of the JAX package's ``envs/mujoco/mjcf.py``, line for line in
numpy and ``xml.etree``, building the port's own
:class:`~gymnasium_tpu_torch.physics.articulated.ArticulatedModel`. It parses
the subset of MJCF the reference robots use: nested bodies, slide, hinge,
ball and free joints, capsule, sphere, box, cylinder and ellipsoid geoms
with inertia from the geom, defaults with nested classes and
``childclass``, motors, ``settotalmass``, contact margins and ``solref``,
and the medium's ``density`` and ``viscosity``. A free joint expands to 3
slides and 3 hinges, which the engine steps as a quaternion root.
``load_model`` compiles an ``.xml`` through :func:`compile_mjcf`.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import Any

import numpy as np

from gymnasium_tpu_torch.physics.articulated import (
    HINGE,
    SLIDE,
    ArticulatedModel,
    BodySpec,
    JointSpec,
)

__all__ = ["compile_mjcf"]


def _parse_vec(s: str | None, default):
    if s is None:
        return np.asarray(default, dtype=np.float64)
    return np.array([float(v) for v in s.split()], dtype=np.float64)


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def _axisangle_to_quat(axis, angle):
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / (np.linalg.norm(axis) + 1e-12)
    return np.concatenate([[math.cos(angle / 2)], axis * math.sin(angle / 2)])


def _euler_to_quat(euler):
    q = np.array([1.0, 0.0, 0.0, 0.0])
    for axis, ang in zip(np.eye(3), euler):
        q = _quat_mul(q, _axisangle_to_quat(axis, ang))
    return q


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _frame_quat(elem, angle_scale: float):
    """Orientation of an element from quat / axisangle / euler attributes."""
    if elem.get("quat") is not None:
        q = _parse_vec(elem.get("quat"), None)
        return q / np.linalg.norm(q)
    if elem.get("axisangle") is not None:
        v = _parse_vec(elem.get("axisangle"), None)
        return _axisangle_to_quat(v[:3], v[3] * angle_scale)
    if elem.get("euler") is not None:
        return _euler_to_quat(_parse_vec(elem.get("euler"), None) * angle_scale)
    return np.array([1.0, 0.0, 0.0, 0.0])


class _Defaults:
    """Nested default-class resolution."""

    def __init__(self):
        self.table: dict[str, dict[str, dict[str, str]]] = {"": {}}

    def load(self, root: ET.Element):
        def walk(elem: ET.Element, class_name: str, inherited: dict):
            merged = {
                tag: dict(attrs) for tag, attrs in inherited.items()
            }
            for child in elem:
                if child.tag == "default":
                    continue
                merged.setdefault(child.tag, {})
                merged[child.tag].update(child.attrib)
            self.table[class_name] = merged
            for child in elem:
                if child.tag == "default":
                    walk(child, child.get("class", ""), merged)

        for default_elem in root.findall("default"):
            walk(default_elem, default_elem.get("class", ""), {})

    def get(self, tag: str, elem: ET.Element, childclass: str) -> dict[str, str]:
        cls = elem.get("class", childclass)
        attrs = dict(self.table.get(cls, {}).get(tag, {}))
        attrs.update(elem.attrib)
        return attrs


def _geom_mass_props(attrs: dict[str, str], angle_scale: float):
    """mass, com (geom frame at body coords), inertia about com (body frame)."""
    gtype = attrs.get("type", "sphere")
    density = float(attrs.get("density", 1000.0))
    size = _parse_vec(attrs.get("size"), [0.0])

    if attrs.get("fromto") is not None:
        ft = _parse_vec(attrs.get("fromto"), None)
        a, b = ft[:3], ft[3:]
        center = (a + b) / 2
        d = b - a
        length = np.linalg.norm(d)
        z = d / (length + 1e-12)
        # rotation taking local z to d
        up = np.array([0.0, 0.0, 1.0])
        v = np.cross(up, z)
        cw = float(np.dot(up, z))
        if np.linalg.norm(v) < 1e-9:
            R = np.eye(3) if cw > 0 else np.diag([1.0, -1.0, -1.0])
        else:
            vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
            R = np.eye(3) + vx + vx @ vx / (1 + cw)
    else:
        center = _parse_vec(attrs.get("pos"), [0.0, 0.0, 0.0])
        length = 2 * size[1] if len(size) > 1 else 0.0
        fake = ET.Element("geom", attrs)
        R = _quat_to_mat(_frame_quat(fake, angle_scale))

    r = size[0]
    if gtype == "sphere":
        mass = density * 4 / 3 * math.pi * r**3
        i = 2 / 5 * mass * r * r
        inertia = np.diag([i, i, i])
    elif gtype == "capsule":
        half = length / 2
        m_cyl = density * math.pi * r * r * (2 * half)
        m_cap = density * 4 / 3 * math.pi * r**3
        mass = m_cyl + m_cap
        # cylinder part
        ixx_cyl = m_cyl * (3 * r * r + (2 * half) ** 2) / 12
        izz_cyl = 0.5 * m_cyl * r * r
        # hemispheres (combined = sphere displaced to ends)
        izz_cap = 2 / 5 * m_cap * r * r
        ixx_cap = izz_cap + m_cap * (half**2 + 3 / 8 * 2 * half * r)
        inertia = np.diag([ixx_cyl + ixx_cap, ixx_cyl + ixx_cap, izz_cyl + izz_cap])
    elif gtype == "cylinder":
        half = size[1]
        mass = density * math.pi * r * r * 2 * half
        ixx = mass * (3 * r * r + (2 * half) ** 2) / 12
        inertia = np.diag([ixx, ixx, 0.5 * mass * r * r])
    elif gtype == "box":
        sx, sy, sz = size[0], size[1], size[2]
        mass = density * 8 * sx * sy * sz
        inertia = np.diag(
            [
                mass * (sy * sy + sz * sz) / 3,
                mass * (sx * sx + sz * sz) / 3,
                mass * (sx * sx + sy * sy) / 3,
            ]
        )
    elif gtype == "ellipsoid":
        a_, b_, c_ = size[0], size[1], size[2]
        mass = density * 4 / 3 * math.pi * a_ * b_ * c_
        inertia = np.diag(
            [
                mass * (b_ * b_ + c_ * c_) / 5,
                mass * (a_ * a_ + c_ * c_) / 5,
                mass * (a_ * a_ + b_ * b_) / 5,
            ]
        )
    else:  # plane etc: massless
        return 0.0, center, np.zeros((3, 3)), R, r, length, gtype

    if attrs.get("mass") is not None:
        target = float(attrs["mass"])
        scale = target / max(mass, 1e-12)
        mass = target
        inertia = inertia * scale

    inertia_body = R @ inertia @ R.T
    return mass, center, inertia_body, R, r, length, gtype


def compile_mjcf(
    path: str, contact_stiffness: float = 100000.0
) -> tuple[ArticulatedModel, dict[str, Any]]:
    """Compile an MJCF file into an ArticulatedModel + metadata dict.

    ``contact_stiffness`` is the per-model default ceiling on each contact's
    penalty spring (N/m). Geoms carrying an explicit ``solref`` attribute
    (MuJoCo's per-geom contact-softness channel, (timeconst, dampratio))
    override it per contact with ``k = m_body / timeconst²`` — the spring
    whose free oscillation matches the requested time constant. The
    reference robot XMLs set no solref, so their softness differences are
    regime differences (impact-dominated vs resting) and are calibrated
    per model when the robots' ``.npz`` specs are made (the JAX package's
    ``tools/extract_mujoco_models.py``).
    """
    tree = ET.parse(path)
    root = tree.getroot()

    compiler = root.find("compiler")
    angle_scale = 1.0
    settotalmass = None
    if compiler is not None:
        if compiler.get("angle", "degree") == "degree":
            angle_scale = math.pi / 180.0
        if compiler.get("settotalmass") is not None:
            settotalmass = float(compiler.get("settotalmass"))

    option = root.find("option")
    gravity = -9.81
    timestep = 0.002
    fluid_density = 0.0
    fluid_viscosity = 0.0
    if option is not None:
        gvec = _parse_vec(option.get("gravity"), [0, 0, -9.81])
        gravity = float(gvec[2])
        timestep = float(option.get("timestep", 0.002))
        # surrounding medium (swimmer.xml: density=4000 viscosity=0.1)
        fluid_density = float(option.get("density", 0.0))
        fluid_viscosity = float(option.get("viscosity", 0.0))

    defaults = _Defaults()
    defaults.load(root)

    bodies: list[dict] = []
    dofs: list[dict] = []
    render_geoms: list[dict] = []
    contact_spheres: list[tuple[int, np.ndarray, float]] = []
    joint_name_to_dofs: dict[str, list[int]] = {}
    body_name_to_idx: dict[str, int] = {}
    cameras: list[dict] = []  # model-fixed cameras (camera_id render targets)
    sites: list[dict] = []  # massless reference points (MjData.site_xpos)

    def add_dof(body_idx, jtype, axis, anchor, attrs, name):
        limited_attr = attrs.get("limited", "false")
        jrange = attrs.get("range")
        limited = limited_attr in ("true", "1") and jrange is not None
        lo, hi = (0.0, 0.0)
        if jrange is not None:
            lo, hi = (float(v) for v in jrange.split())
            if jtype == HINGE:
                lo *= angle_scale
                hi *= angle_scale
        dofs.append(
            dict(
                body=body_idx,
                jtype=jtype,
                axis=np.asarray(axis, dtype=np.float64),
                anchor=np.asarray(anchor, dtype=np.float64),
                damping=float(attrs.get("damping", 0.0)),
                limited=limited,
                lower=lo,
                upper=hi,
                stiffness=float(attrs.get("stiffness", 0.0)),
                armature=float(attrs.get("armature", 0.0)),
                ref=float(attrs.get("ref", 0.0)) * (angle_scale if jtype == HINGE else 1.0),
                name=name,
            )
        )
        return len(dofs) - 1

    def walk_body(elem: ET.Element, parent_idx: int, childclass: str):
        body_idx = len(bodies)
        pos = _parse_vec(elem.get("pos"), [0.0, 0.0, 0.0])
        quat = _frame_quat(elem, angle_scale)
        name = elem.get("name", f"body{body_idx}")
        body_name_to_idx[name] = body_idx
        entry = dict(
            parent=parent_idx,
            pos=pos,
            quat=quat,
            name=name,
            mass=0.0,
            com=np.zeros(3),
            inertia=np.zeros((3, 3)),
            dof_start=len(dofs),
            dof_count=0,
        )
        bodies.append(entry)
        childclass = elem.get("childclass", childclass)

        geom_props = []
        for child in elem:
            if child.tag == "joint":
                attrs = defaults.get("joint", child, childclass)
                jtype_s = attrs.get("type", "hinge")
                jname = attrs.get("name", f"joint{len(dofs)}")
                jpos = _parse_vec(attrs.get("pos"), [0, 0, 0])
                jaxis = _parse_vec(attrs.get("axis"), [0, 0, 1])
                jaxis = jaxis / (np.linalg.norm(jaxis) + 1e-12)
                idxs = []
                if jtype_s == "free":
                    free_attrs = {"damping": "0", "armature": "0", "stiffness": "0"}
                    for ax in np.eye(3):
                        idxs.append(add_dof(body_idx, SLIDE, ax, jpos, free_attrs, jname))
                    for ax in np.eye(3):
                        idxs.append(add_dof(body_idx, HINGE, ax, jpos, free_attrs, jname))
                elif jtype_s == "ball":
                    for ax in np.eye(3):
                        idxs.append(add_dof(body_idx, HINGE, ax, jpos, attrs, jname))
                elif jtype_s == "slide":
                    idxs.append(add_dof(body_idx, SLIDE, jaxis, jpos, attrs, jname))
                else:
                    idxs.append(add_dof(body_idx, HINGE, jaxis, jpos, attrs, jname))
                joint_name_to_dofs[jname] = idxs
            elif child.tag == "geom":
                attrs = defaults.get("geom", child, childclass)
                mass, com, inertia, R, r, length, gtype = _geom_mass_props(attrs, angle_scale)
                geom_props.append((mass, com, inertia))
                # record the primitive for a renderer (meta["render_geoms"]):
                # local center/orientation, type-specific size, and color
                if gtype in ("sphere", "capsule", "cylinder", "box", "ellipsoid"):
                    if gtype == "capsule":
                        gsize = [float(r), float(length / 2)]
                    elif gtype == "sphere":
                        gsize = [float(r)]
                    else:
                        gsize = [float(x) for x in _parse_vec(attrs.get("size"), [r, r, r])[:3]]
                    render_geoms.append(
                        dict(
                            body=body_idx,
                            type=gtype,
                            size=gsize,
                            pos=[float(x) for x in com],
                            mat=[float(x) for x in np.asarray(R).reshape(-1)],
                            rgba=[
                                float(x)
                                for x in _parse_vec(attrs.get("rgba"), [0.5, 0.5, 0.55, 1.0])
                            ],
                        )
                    )
                contype = attrs.get("contype", "1")
                if contype != "0" and gtype in ("capsule", "sphere", "box", "cylinder", "ellipsoid"):
                    # MuJoCo activates contact force while the surfaces are
                    # still `margin_geom + margin_floor` apart (includemargin;
                    # ant.xml margin=0.01 makes feet effectively 2 cm larger
                    # — it settles visibly taller because of it). The sphere
                    # radius is inflated by the pair margin after the floor
                    # is parsed below.
                    gmargin = float(attrs.get("margin", 0.0))
                    # per-geom contact softness: solref = (timeconst, dampratio)
                    # with timeconst > 0 requests a contact spring of that
                    # free-oscillation period (resolved to N/m after body
                    # masses are final — see the stiffness pass below)
                    solref_tc = 0.0
                    if attrs.get("solref") is not None:
                        sr = _parse_vec(attrs.get("solref"), [0.0, 1.0])
                        if sr[0] > 0:
                            solref_tc = float(sr[0])
                    if gtype == "capsule" and length > 0:
                        z = R @ np.array([0.0, 0.0, 1.0])
                        half = length / 2
                        for frac in (-1.0, 0.0, 1.0):
                            contact_spheres.append(
                                (body_idx, com + z * half * frac, r, gmargin, solref_tc)
                            )
                    elif gtype == "box":
                        sx, sy, sz = _parse_vec(attrs.get("size"), [r, r, r])[:3]
                        for cx in (-sx, sx):
                            for cy in (-sy, sy):
                                contact_spheres.append(
                                    (
                                        body_idx,
                                        com + R @ np.array([cx, cy, -sz]),
                                        min(sx, sy, sz) * 0.5,
                                        gmargin,
                                        solref_tc,
                                    )
                                )
                    else:
                        contact_spheres.append((body_idx, com.copy(), r, gmargin, solref_tc))
            elif child.tag == "camera":
                # model-fixed camera (reference XMLs: the trackcom "track"
                # camera); xyaxes gives the camera's x (right) and y (up)
                # axes in the attachment frame, looking along -z
                x_ax = _parse_vec(child.get("xyaxes"), [1, 0, 0, 0, 1, 0])
                cameras.append(
                    dict(
                        name=child.get("name", f"camera{len(cameras)}"),
                        mode=child.get("mode", "fixed"),
                        body=body_idx,
                        pos=[float(v) for v in _parse_vec(child.get("pos"), [0, 0, 0])],
                        xaxis=[float(v) for v in x_ax[:3]],
                        yaxis=[float(v) for v in x_ax[3:6]],
                    )
                )
            elif child.tag == "site":
                # massless reference point (reference reads e.g. the IDP
                # tip via data.site_xpos, test_mujoco_v5.py:486)
                attrs = defaults.get("site", child, childclass)
                sites.append(
                    dict(
                        body=body_idx,
                        pos=_parse_vec(attrs.get("pos"), [0.0, 0.0, 0.0]),
                        name=attrs.get("name", f"site{len(sites)}"),
                    )
                )
            elif child.tag == "inertial":
                imass = float(child.get("mass", 0.0))
                ipos = _parse_vec(child.get("pos"), [0, 0, 0])
                diag = _parse_vec(child.get("diaginertia"), [0, 0, 0])
                geom_props.append((imass, ipos, np.diag(diag)))
            elif child.tag == "body":
                pass  # handled after mass accumulation

        total = sum(m for m, _, _ in geom_props)
        if total > 0:
            com = sum(m * c for m, c, _ in geom_props) / total
            inertia = np.zeros((3, 3))
            for m, c, i_g in geom_props:
                d = c - com
                inertia += i_g + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
            entry["mass"] = total
            entry["com"] = com
            entry["inertia"] = inertia
        entry["dof_count"] = len(dofs) - entry["dof_start"]

        for child in elem:
            if child.tag == "body":
                walk_body(child, body_idx, childclass)

    worldbody = root.find("worldbody")
    assert worldbody is not None
    for child in worldbody:
        if child.tag == "body":
            walk_body(child, -1, "")

    # Ground plane height: the top-most collidable plane geom in the world.
    # Models without a floor (none in-tree) keep the engine's ground far away.
    ground_z = None
    floor_margin = 0.0
    for geom in worldbody.findall("geom"):
        attrs = defaults.get("geom", geom, "")
        if attrs.get("type") == "plane" and attrs.get("contype", "1") != "0":
            z = float(_parse_vec(attrs.get("pos"), [0, 0, 0])[2])
            if ground_z is None or z > ground_z:
                ground_z = z
                floor_margin = float(attrs.get("margin", 0.0))
    if ground_z is None:
        ground_z = -1e9
    # inflate contact radii by the pair margin (geom + floor), mirroring
    # MuJoCo's includemargin force-onset distance
    contact_spheres = [
        (b, pos, r + gm + floor_margin, gm, tc)
        for (b, pos, r, gm, tc) in contact_spheres
    ]

    # settotalmass: scale all masses/inertias to the target total
    if settotalmass is not None:
        total = sum(b["mass"] for b in bodies)
        scale = settotalmass / max(total, 1e-12)
        for b in bodies:
            b["mass"] *= scale
            b["inertia"] = b["inertia"] * scale

    # resolve per-contact spring stiffness now that body masses are final:
    # geom solref timeconst tc ⇒ k = m_body / tc²; otherwise the per-model
    # default ceiling (the explicit-stability bound still clamps at runtime,
    # physics/articulated.py _contact_point_forces)
    contact_k = np.array(
        [
            (bodies[b]["mass"] / (tc * tc)) if tc > 0 else contact_stiffness
            for (b, _pos, _r, _gm, tc) in contact_spheres
        ]
    )

    # actuators
    act_dof, act_gear, act_ctrlrange = [], [], []
    actuator_elem = root.find("actuator")
    if actuator_elem is not None:
        for motor in actuator_elem:
            attrs = defaults.get("motor", motor, "")
            jname = attrs.get("joint")
            gear_vec = _parse_vec(attrs.get("gear"), [1.0])
            gear = float(gear_vec[0])
            cr = attrs.get("ctrlrange")
            limited = attrs.get("ctrllimited", "false") in ("true", "1") or cr is not None
            if cr is not None:
                lo, hi = (float(v) for v in cr.split())
            else:
                lo, hi = -np.inf, np.inf
            dof_ids = joint_name_to_dofs.get(jname, [])
            if dof_ids:
                act_dof.append(dof_ids[0])
                act_gear.append(gear)
                act_ctrlrange.append([lo, hi] if limited else [-np.inf, np.inf])

    body_spec = BodySpec(
        parent=np.array([b["parent"] for b in bodies], dtype=np.int32),
        pos=np.stack([b["pos"] for b in bodies]),
        quat=np.stack([b["quat"] for b in bodies]),
        mass=np.array([b["mass"] for b in bodies]),
        com=np.stack([b["com"] for b in bodies]),
        inertia=np.stack([b["inertia"] for b in bodies]),
        dof_start=np.array([b["dof_start"] for b in bodies], dtype=np.int32),
        dof_count=np.array([b["dof_count"] for b in bodies], dtype=np.int32),
    )
    joint_spec = JointSpec(
        body=np.array([d["body"] for d in dofs], dtype=np.int32),
        jtype=np.array([d["jtype"] for d in dofs], dtype=np.int32),
        axis=np.stack([d["axis"] for d in dofs]) if dofs else np.zeros((0, 3)),
        anchor=np.stack([d["anchor"] for d in dofs]) if dofs else np.zeros((0, 3)),
        damping=np.array([d["damping"] for d in dofs]),
        limited=np.array([d["limited"] for d in dofs], dtype=bool),
        lower=np.array([d["lower"] for d in dofs]),
        upper=np.array([d["upper"] for d in dofs]),
        stiffness=np.array([d["stiffness"] for d in dofs]),
        armature=np.array([d["armature"] for d in dofs]),
        ref=np.array([d["ref"] for d in dofs]),
    )
    model = ArticulatedModel(
        bodies=body_spec,
        joints=joint_spec,
        contact_body=np.array([c[0] for c in contact_spheres], dtype=np.int32),
        contact_pos=np.stack([c[1] for c in contact_spheres]) if contact_spheres else np.zeros((0, 3)),
        contact_radius=np.array([c[2] for c in contact_spheres]),
        act_dof=np.array(act_dof, dtype=np.int32),
        act_gear=np.array(act_gear),
        act_ctrlrange=np.array(act_ctrlrange) if act_ctrlrange else np.zeros((0, 2)),
        gravity=gravity,
        timestep=timestep,
        fluid_density=fluid_density,
        fluid_viscosity=fluid_viscosity,
        contact_stiffness=contact_k,
        ground_z=ground_z,
        root_free=(
            bool(dofs) and dofs[0]["name"] == dofs[5]["name"] if len(dofs) >= 6 else False
        ),
        site_body=np.array([s["body"] for s in sites], dtype=np.int32),
        site_pos=(
            np.stack([np.asarray(s["pos"], dtype=np.float64) for s in sites])
            if sites
            else np.zeros((0, 3))
        ),
    )
    meta = {
        "body_names": [b["name"] for b in bodies],
        "dof_names": [d["name"] for d in dofs],
        "joint_dofs": joint_name_to_dofs,
        "free_root": bool(dofs) and dofs[0]["name"] == dofs[5]["name"] if len(dofs) >= 6 else False,
        "render_geoms": render_geoms,
        "has_floor": bool(ground_z is not None and np.isfinite(ground_z)),
        "cameras": cameras,
        "site_names": [s["name"] for s in sites],
    }
    return model, meta
