"""Robot models of the MuJoCo-class envs, and the host env class over them.

Counterpart of the JAX package's ``envs/mujoco/mujoco_env.py``. A robot's
name loads its compiled ``.npz`` spec: the port keeps its own copy of those
files, byte for byte the JAX package's, in ``models/`` beside this module
(:data:`MODEL_DIR`), so an installed port reads nothing of the JAX package.
A name ending in ``.xml`` is an MJCF file, compiled by
:func:`~gymnasium_tpu_torch.envs.mujoco.mjcf.compile_mjcf` once a resolved
path. :func:`kernel_name` names the articulated kernel a model is built as.

:class:`MujocoEnv` keeps the JAX class's host API: float64 numpy ``qpos`` and
``qvel`` mirrors, numpy observations, Python float rewards. Its physics runs
on the env's device (CUDA unless the caller passes ``device="cpu"``): an env
step uploads the state and the control as one ``(1, nq + nv + nu)`` row, makes
one call of the robot's fused step (one launch of its articulated kernel on
the card, the plain twin on the CPU) and reads the new state back. The
kinematics helpers the robots read (forward kinematics, contact wrenches,
limit torques, sites, centre-of-mass velocities) run on the same device,
each once a state.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import re
from pathlib import Path

import types
from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import logger, spaces
from gymnasium_tpu_torch.core import Env
from gymnasium_tpu_torch.ops.articulated_step import fused_step
from gymnasium_tpu_torch.physics.articulated import (
    ArticulatedModel,
    BodySpec,
    JointSpec,
    init_qpos,
    make_dynamics,
    model_digest,
)
from gymnasium_tpu_torch.utils.device import resolve_device, upload_row

__all__ = [
    "MODEL_DIR",
    "DEFAULT_SIZE",
    "load_model",
    "resolve_xml",
    "kernel_name",
    "expected_frame_skip",
    "MujocoEnv",
]

# default render-surface side (upstream mujoco_env.py:18)
DEFAULT_SIZE = 480

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
    digest = hashlib.sha256(f"{path}\n{model_digest(model)}".encode()).hexdigest()[:16]
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


@functools.lru_cache(maxsize=32)
def _dynamics(name: str) -> dict:
    """The batched helpers of model ``name``, shared by its env instances."""
    return make_dynamics(load_model(name)[0])


def expected_frame_skip(name: str, target_dt: float) -> int:
    """The ``frame_skip`` that gives an env step of ``target_dt`` seconds."""
    model, _ = load_model(name)
    return max(int(round(target_dt / model.timestep)), 1)


class _MjDataShim:
    """A live view of the env's state under MuJoCo's ``MjData`` names."""

    def __init__(self, env: "MujocoEnv"):
        self._env = env

    @property
    def qpos(self) -> np.ndarray:
        return self._env.qpos

    @property
    def qvel(self) -> np.ndarray:
        return self._env.qvel

    @property
    def xipos(self) -> np.ndarray:
        """(nbody, 3) world centres of mass, the world's row 0 zeroed (MuJoCo's
        layout, which upstream's ``mass_center`` helper reads)."""
        return np.vstack([np.zeros(3), self._env._body_com_positions()])

    @property
    def site_xpos(self) -> np.ndarray:
        """(nsite, 3) world site positions in document order."""
        return self._env._site_positions()

    def body(self, name: str):
        """A named body's view, its frame origin as ``xpos``."""
        _, p = self._env._helper("fk")
        return types.SimpleNamespace(xpos=p[self._env.body_index(name)])


class MujocoEnv(Env[np.ndarray, np.ndarray]):
    """Base class of the robots driven by the articulated engine.

    ``device`` is where the physics runs: ``None`` means CUDA, and without a
    card that raises (:func:`~gymnasium_tpu_torch.utils.device.resolve_device`);
    ``"cpu"`` runs the plain twin.
    """

    model_name: str = ""
    frame_skip: int = 5
    # declared on the class so that make(render_mode=...) validates before
    # building the env; __init__ adds the model's render_fps
    metadata = {"render_modes": ["human", "rgb_array", "depth_array", "rgbd_tuple"]}

    def __init__(
        self,
        model_name: str,
        frame_skip: int,
        observation_space: spaces.Space | None = None,
        render_mode: str | None = None,
        reset_noise_scale: float = 0.0,
        width: int = DEFAULT_SIZE,
        height: int = DEFAULT_SIZE,
        camera_id: int | None = None,
        camera_name: str | None = None,
        default_camera_config: dict[str, Any] | None = None,
        max_geom: int = 1000,
        visual_options: dict[int, bool] | None = None,
        device: str | torch.device | None = None,
        **kwargs: Any,
    ):
        self.device = resolve_device(device)
        if model_name.endswith(".xml"):
            # one canonical name, so the builds and helpers are shared
            model_name = resolve_xml(model_name)
        self.model_name = model_name
        self.frame_skip = frame_skip
        self.model, self.meta = load_model(model_name)
        self._reset_noise_scale = reset_noise_scale
        self.render_mode = render_mode
        self._display = None
        # camera_id/camera_name select among the model's fixed cameras; with
        # neither, the free camera tracks the root body
        assert camera_id is None or camera_name is None, "camera_id and camera_name cannot both be supplied"
        self.width = int(width)
        self.height = int(height)
        self.camera_id = camera_id
        self.camera_name = camera_name
        self._camera_config = dict(default_camera_config or {})
        self.max_geom = max_geom  # accepted as upstream does; the rasterizer has no cap
        self.visual_options = dict(visual_options or {})

        self._step = fused_step(model_name, frame_skip)
        self._dyn = _dynamics(model_name)
        # helper values of one state, keyed by its bytes
        self._state_key = None
        self._state_values: dict[str, Any] = {}

        nv, nq = self.model.nv, self.model.nq
        # the joints' reference values; a free root's pose comes first
        self.init_qpos = init_qpos(self.model)
        self.init_qvel = np.zeros(nv)
        self.qpos = np.zeros(nq)
        self.qvel = np.zeros(nv)

        bounds = np.asarray(self.model.act_ctrlrange, dtype=np.float32)
        if bounds.size and np.isfinite(bounds).all():
            self.action_space = spaces.Box(low=bounds[:, 0], high=bounds[:, 1], dtype=np.float32)
        else:
            self.action_space = spaces.Box(-1.0, 1.0, (self.model.nu,), dtype=np.float32)
        if observation_space is not None:
            self.observation_space = observation_space

        self.metadata = {
            "render_modes": ["human", "rgb_array", "depth_array", "rgbd_tuple"],
            "render_fps": int(np.round(1.0 / self.dt)),
        }

        from gymnasium_tpu_torch.envs.mujoco.rendering import MujocoRenderer

        self.mujoco_renderer = MujocoRenderer(self)

    @property
    def dt(self) -> float:
        """An env step's duration: the model's timestep times ``frame_skip``."""
        return self.model.timestep * self.frame_skip

    @property
    def data(self) -> _MjDataShim:
        """MuJoCo-style ``data`` view (``data.qpos``, ``data.qvel``, ...)."""
        return _MjDataShim(self)

    # -- state -------------------------------------------------------------

    def set_state(self, qpos: np.ndarray, qvel: np.ndarray):
        """Overwrite the whole physics state; a free root's quaternion is
        normalised (MuJoCo's ``mj_normalizeQuat``)."""
        assert qpos.shape == (self.model.nq,) and qvel.shape == (self.model.nv,)
        qpos = np.asarray(qpos, dtype=np.float64).copy()
        if self.model.root_free:
            qpos[3:7] /= np.linalg.norm(qpos[3:7]) + 1e-24
        self.qpos = qpos
        self.qvel = np.asarray(qvel, dtype=np.float64).copy()

    def get_state(self) -> tuple[np.ndarray, np.ndarray]:
        """A copy of ``(qpos, qvel)``."""
        return self.qpos.copy(), self.qvel.copy()

    def _advance(self, q: torch.Tensor, qd: torch.Tensor, ctrl: torch.Tensor):
        """``(q, qd)`` after one env step under ``ctrl``, each ``(1, ·)`` on
        the env's device: one call of the robot's fused step."""
        return self._step(q, qd, ctrl)

    def do_simulation(self, ctrl: np.ndarray, n_frames: int | None = None):
        """Advance the physics ``frame_skip`` substeps under ``ctrl``."""
        ctrl = np.asarray(ctrl)
        if ctrl.shape != (self.model.nu,):
            raise ValueError(f"Action dimension mismatch. Expected {(self.model.nu,)}, found {ctrl.shape}")
        nq, nv = self.model.nq, self.model.nv
        row = upload_row(self.device, self.qpos, self.qvel, ctrl)
        q, qd = self._advance(row[:, :nq], row[:, nq : nq + nv], row[:, nq + nv :])
        state = torch.cat([q, qd], dim=1).cpu().numpy()[0].astype(np.float64)
        # the mirrors stay float64 like MuJoCo's MjData
        self.qpos, self.qvel = state[:nq].copy(), state[nq:].copy()
        self._state_key = self._key()
        self._state_values = {"state": (q, qd)}

    def _key(self):
        return (self.qpos.dtype.str, self.qpos.tobytes(), self.qvel.dtype.str, self.qvel.tobytes())

    def _device_state(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The current state as ``(1, nq)``, ``(1, nv)`` float32 tensors on
        the env's device, uploaded once a state."""
        if self._state_key != self._key():
            row = upload_row(self.device, self.qpos, self.qvel)
            self._state_key = self._key()
            self._state_values = {"state": (row[:, : self.model.nq], row[:, self.model.nq :])}
        return self._state_values["state"]

    def _helper(self, name: str):
        """The value of a kinematics helper at the current state, as float32
        numpy arrays of one env (the JAX helpers' dtype): ``fk`` (R, p),
        ``contact_points``, ``contact_wrenches``, ``limit_torques``,
        ``com_world`` or ``site_xpos``. Computed on the env's device once a
        state; every caller gets its own copy."""
        q, qd = self._device_state()
        values = self._state_values
        if name not in values:
            values[name] = _to_numpy(self._compute(name, q, qd))
        value = values[name]
        return tuple(v.copy() for v in value) if isinstance(value, tuple) else value.copy()

    def _compute(self, name: str, q: torch.Tensor, qd: torch.Tensor):
        """Helper ``name`` of :meth:`_helper` on a batch of one."""
        if name in ("fk", "contact_points"):
            return self._dyn[name](q)
        if name == "com_world":
            return self._dyn[name](q)[0]
        if name == "site_xpos":
            R, p = self._dyn["fk"](q)
            sb = torch.as_tensor(np.asarray(self.model.site_body, np.int64), device=q.device)
            sp = torch.as_tensor(np.asarray(self.model.site_pos, np.float32), device=q.device)
            return p[:, sb] + torch.sum(R[:, sb] * sp[:, None, :], dim=-1)
        return self._dyn[name](q, qd)

    @property
    def cfrc_ext(self) -> np.ndarray:
        """(nbody, 6) each body's external contact wrench ``[torque, force]``,
        the engine's counterpart of MuJoCo's ``data.cfrc_ext`` (no world row)."""
        return self._helper("contact_wrenches")

    def _site_positions(self) -> np.ndarray:
        """(nsite, 3) world site positions (MuJoCo's ``data.site_xpos``)."""
        if not len(self.model.site_body):
            return np.zeros((0, 3))
        return self._helper("site_xpos")

    # -- kinematics --------------------------------------------------------

    def body_index(self, name: str) -> int:
        """Index of a named body."""
        return self.meta["body_names"].index(name)

    def body_xpos(self, name: str) -> np.ndarray:
        """World position of a named body's frame origin."""
        _, p = self._helper("fk")
        return p[self.body_index(name)]

    def get_body_com(self, name: str) -> np.ndarray:
        """A body's FRAME position, as upstream's ``get_body_com`` returns
        ``data.body(name).xpos`` despite its name. A free root's frame is
        ``qpos[:3]`` exactly."""
        index = self.body_index(name)
        if self.model.root_free and index == 0:
            return self.qpos[:3].copy()
        return self.body_xpos(name)

    def _body_com_positions(self) -> np.ndarray:
        """(nbody without the world, 3) world centre of mass of every body."""
        R, p = self._helper("fk")
        R, p = R.astype(np.float64), p.astype(np.float64)
        com = np.asarray(self.model.bodies.com, np.float64)
        return p + np.einsum("bij,bj->bi", R, com)

    def mass_center_xy(self) -> np.ndarray:
        """The robot's centre of mass in xy, by the expression of upstream's
        ``mass_center`` helper (humanoid_v5.py:17-21) over :attr:`data`."""
        masses = self.model.body_mass
        xipos = self.data.xipos
        return (np.einsum("b,bj->j", masses, xipos) / masses.sum())[0:2].copy()

    def state_vector(self) -> np.ndarray:
        """``qpos`` and ``qvel`` concatenated."""
        return np.concatenate([self.qpos, self.qvel])

    # -- reset -------------------------------------------------------------

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        super().reset(seed=seed)
        obs = self.reset_model()
        info = self._get_reset_info()
        if self.render_mode == "human":
            self.render()
        return obs, info

    def reset_model(self) -> np.ndarray:
        """Set the state after a reset and return the observation: the hook a
        third-party subclass overrides; the robots override
        :meth:`_sample_initial_state`."""
        self.qpos, self.qvel = self._sample_initial_state()
        return self._get_obs()

    def _get_reset_info(self) -> dict[str, Any]:
        """The reset's info, upstream's hook name."""
        return self._reset_info()

    def _sample_initial_state(self) -> tuple[np.ndarray, np.ndarray]:
        # uniform noise on qpos and qvel, on every qpos entry (a free root's
        # raw quaternion too, normalised after), drawn from self.np_random
        noise = self._reset_noise_scale
        qpos = self.init_qpos + self.np_random.uniform(low=-noise, high=noise, size=self.model.nq)
        if self.model.root_free:
            qpos[3:7] /= np.linalg.norm(qpos[3:7]) + 1e-24
        qvel = self.init_qvel + self.np_random.uniform(low=-noise, high=noise, size=self.model.nv)
        return qpos, qvel

    def _reset_info(self) -> dict[str, Any]:
        return {}

    def _get_obs(self) -> np.ndarray:
        raise NotImplementedError

    # -- rendering ---------------------------------------------------------

    def render(self):
        if self.render_mode is None:
            logger.warn("You are calling render method without specifying any render mode.")
            return None
        return self.mujoco_renderer.render(self.render_mode)

    def _render_frame(self, depth: bool = False) -> np.ndarray:
        """A frame of the current state from the software 3D rasterizer
        (``render3d.py``), or for a model compiled without render geoms the
        schematic side view. ``depth=True`` gives the (H, W) float32 z-buffer
        in metres along the camera axis."""
        if self.meta.get("render_geoms"):
            from gymnasium_tpu_torch.envs.mujoco.render3d import render_robot

            return render_robot(self, self.width, self.height, camera_config=self._camera_config, depth=depth)
        if depth:
            # the schematic view has no scene: a flat far plane
            return np.full((self.height, self.width), 10.0, np.float32)
        return self._render_side_view(self.width, self.height)

    def _render_side_view(self, width: int = DEFAULT_SIZE, height: int = DEFAULT_SIZE) -> np.ndarray:
        """Schematic x-z side view of the contact spheres and body frames."""
        from gymnasium_tpu_torch.utils.raster import Canvas

        canvas = Canvas(width, height, (240, 240, 245))
        _, p = self._helper("fk")
        scale = 100.0
        cx = width / 2 - p[0, 0] * scale
        ground_y = height * 0.8
        canvas.hline(ground_y, (60, 120, 60), 3)
        # links: a line from each body to its parent
        for b in range(1, len(self.model.bodies.parent)):
            parent = int(self.model.bodies.parent[b])
            if parent < 0:
                continue
            canvas.line(
                (cx + p[parent, 0] * scale, ground_y - p[parent, 2] * scale),
                (cx + p[b, 0] * scale, ground_y - p[b, 2] * scale),
                (90, 90, 140),
                4,
            )
        pts = self._helper("contact_points")
        for k in range(len(pts)):
            canvas.circle(
                (cx + pts[k, 0] * scale, ground_y - pts[k, 2] * scale),
                max(self.model.contact_radius[k] * scale, 2),
                (200, 120, 90),
            )
        return canvas.rgb_array()

    def close(self):
        if getattr(self, "mujoco_renderer", None) is not None:
            self.mujoco_renderer.close()
        if self._display is not None:
            self._display.close()
            self._display = None


def _to_numpy(value):
    """A helper's tensors of a batch of one, as numpy arrays of the one env."""
    if isinstance(value, tuple):
        return tuple(_to_numpy(v) for v in value)
    return value[0].cpu().numpy()
