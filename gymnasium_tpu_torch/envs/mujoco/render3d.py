"""Software 3D renderer for the MuJoCo-family robots (host-side numpy).

Fills the role of the reference's OpenGL ``OffScreenViewer`` (reference
mujoco/mujoco_rendering.py:173,334) for ``render_mode="rgb_array"``: a
z-buffered triangle rasterizer over the engine's FK output, drawing the
primitive geoms recorded at MJCF compile time (mjcf.py ``render_geoms``) —
capsules, spheres, boxes, cylinders, ellipsoids — over a checkerboard ground
plane, with a single directional light and a MuJoCo-style tracking camera.

Pure numpy, host-only, never on the device's hot path. ~3k triangles at 480×480
renders in tens of milliseconds — ample for RecordVideo / human display.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Any

import numpy as np

__all__ = ["Scene", "render_robot"]


# ---------------------------------------------------------------------------
# Primitive meshes (unit-size, instanced per geom)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _unit_sphere(n_lat: int = 8, n_lon: int = 12) -> tuple[np.ndarray, np.ndarray]:
    """UV-sphere of radius 1: (verts (V,3), faces (F,3) int)."""
    verts = [(0.0, 0.0, 1.0)]
    for i in range(1, n_lat):
        th = math.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * math.pi * j / n_lon
            verts.append(
                (math.sin(th) * math.cos(ph), math.sin(th) * math.sin(ph), math.cos(th))
            )
    verts.append((0.0, 0.0, -1.0))
    faces = []
    for j in range(n_lon):
        faces.append((0, 1 + j, 1 + (j + 1) % n_lon))
    for i in range(n_lat - 2):
        a = 1 + i * n_lon
        b = 1 + (i + 1) * n_lon
        for j in range(n_lon):
            j2 = (j + 1) % n_lon
            faces.append((a + j, b + j, b + j2))
            faces.append((a + j, b + j2, a + j2))
    last = len(verts) - 1
    a = 1 + (n_lat - 2) * n_lon
    for j in range(n_lon):
        faces.append((last, a + (j + 1) % n_lon, a + j))
    return np.asarray(verts), np.asarray(faces, np.int32)


@lru_cache(maxsize=None)
def _unit_capsule(n_seg: int = 12, n_cap: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """Capsule with radius 1, half-length 1 along z (scale r and hz at use)."""
    verts: list[tuple[float, float, float]] = []
    rings: list[int] = []  # first vertex index of each ring
    # top cap rings (z from +1+r... flattened later by scaling: we keep the
    # hemisphere at z-offset +1), bottom mirrored
    for i in range(n_cap + 1):
        th = (math.pi / 2) * i / n_cap  # 0 = pole
        z = math.cos(th)
        rad = math.sin(th)
        if i == 0:
            rings.append(len(verts))
            verts.append((0.0, 0.0, 1.0 + 1.0))
            continue
        rings.append(len(verts))
        for j in range(n_seg):
            ph = 2 * math.pi * j / n_seg
            verts.append((rad * math.cos(ph), rad * math.sin(ph), 1.0 + z))
    # cylinder bottom ring
    rings.append(len(verts))
    for j in range(n_seg):
        ph = 2 * math.pi * j / n_seg
        verts.append((math.cos(ph), math.sin(ph), -1.0))
    # bottom hemisphere
    for i in range(1, n_cap + 1):
        th = (math.pi / 2) * i / n_cap
        z = math.cos(th)
        rad = math.sin(th)
        if i == n_cap:
            rings.append(len(verts))
            verts.append((0.0, 0.0, -1.0 - 1.0))
            break
        rings.append(len(verts))
        for j in range(n_seg):
            ph = 2 * math.pi * j / n_seg
            verts.append((rad * math.cos(ph), rad * math.sin(ph), -1.0 - z))

    faces = []

    def ring_band(r1: int, r2: int):
        for j in range(n_seg):
            j2 = (j + 1) % n_seg
            faces.append((r1 + j, r2 + j, r2 + j2))
            faces.append((r1 + j, r2 + j2, r1 + j2))

    # top pole fan
    for j in range(n_seg):
        faces.append((rings[0], rings[1] + j, rings[1] + (j + 1) % n_seg))
    # top hemisphere bands + cylinder + bottom hemisphere bands
    band_rings = rings[1 : 1 + n_cap] + [rings[n_cap + 1]] + rings[n_cap + 2 : -1]
    for a, b in zip(band_rings[:-1], band_rings[1:]):
        ring_band(a, b)
    # bottom pole fan
    for j in range(n_seg):
        faces.append((rings[-1], band_rings[-1] + (j + 1) % n_seg, band_rings[-1] + j))
    return np.asarray(verts), np.asarray(faces, np.int32)


@lru_cache(maxsize=None)
def _unit_box() -> tuple[np.ndarray, np.ndarray]:
    v = np.array(
        [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], float
    )
    f = np.array(
        [
            (0, 1, 3), (0, 3, 2),  # -x
            (4, 6, 7), (4, 7, 5),  # +x
            (0, 4, 5), (0, 5, 1),  # -y
            (2, 3, 7), (2, 7, 6),  # +y
            (0, 2, 6), (0, 6, 4),  # -z
            (1, 5, 7), (1, 7, 3),  # +z
        ],
        np.int32,
    )
    return v, f


@lru_cache(maxsize=None)
def _unit_cylinder(n_seg: int = 12) -> tuple[np.ndarray, np.ndarray]:
    verts = []
    for z in (1.0, -1.0):
        for j in range(n_seg):
            ph = 2 * math.pi * j / n_seg
            verts.append((math.cos(ph), math.sin(ph), z))
    verts.append((0.0, 0.0, 1.0))
    verts.append((0.0, 0.0, -1.0))
    faces = []
    for j in range(n_seg):
        j2 = (j + 1) % n_seg
        faces.append((j, n_seg + j, n_seg + j2))
        faces.append((j, n_seg + j2, j2))
        faces.append((2 * n_seg, j, j2))  # top fan
        faces.append((2 * n_seg + 1, n_seg + j2, n_seg + j))  # bottom fan
    return np.asarray(verts), np.asarray(faces, np.int32)


def _geom_mesh(geom: dict[str, Any]) -> tuple[np.ndarray, np.ndarray]:
    """Local-frame mesh of one geom (scaled)."""
    gtype, size = geom["type"], geom["size"]
    if gtype == "sphere":
        v, f = _unit_sphere()
        return v * size[0], f
    if gtype == "capsule":
        v, f = _unit_capsule()
        r, hz = size[0], size[1] if len(size) > 1 else 0.0
        out = v.copy()
        # unit capsule: cylinder spans z in [-1,1], caps extend 1 further.
        # scale radius by r; map cylinder half-length 1 -> hz.
        out[:, :2] *= r
        cyl = np.clip(out[:, 2], -1.0, 1.0)
        cap = out[:, 2] - cyl
        out[:, 2] = cyl * hz + cap * r
        return out, f
    if gtype == "cylinder":
        v, f = _unit_cylinder()
        out = v.copy()
        out[:, :2] *= size[0]
        out[:, 2] *= size[1] if len(size) > 1 else size[0]
        return out, f
    if gtype in ("box", "ellipsoid"):
        if gtype == "box":
            v, f = _unit_box()
        else:
            v, f = _unit_sphere()
        s = np.asarray(size[:3] if len(size) >= 3 else [size[0]] * 3)
        return v * s, f
    raise ValueError(f"unsupported render geom type {gtype!r}")


# ---------------------------------------------------------------------------
# Scene assembly + rasterization
# ---------------------------------------------------------------------------


class Scene:
    """Precompiled geometry for one robot model (meshes in geom frames)."""

    def __init__(self, meta: dict[str, Any], width: int = 480, height: int = 480):
        self.width, self.height = width, height
        self.geoms = []
        for g in meta.get("render_geoms", []):
            verts, faces = _geom_mesh(g)
            R = np.asarray(g["mat"]).reshape(3, 3)
            pos = np.asarray(g["pos"])
            self.geoms.append(
                dict(
                    body=int(g["body"]),
                    verts=verts @ R.T + pos,  # geom frame -> body frame
                    faces=faces,
                    color=np.asarray(g["rgba"][:3]),
                )
            )
        self.has_floor = bool(meta.get("has_floor", False))

    def render(
        self,
        R_bodies: np.ndarray,  # (nbody, 3, 3) world rotations from fk
        p_bodies: np.ndarray,  # (nbody, 3) world positions from fk
        ground_z: float = 0.0,
        lookat: np.ndarray | None = None,
        distance: float | None = None,
        azimuth: float = 35.0,
        elevation: float = -25.0,
        return_depth: bool = False,
        eye: np.ndarray | None = None,
        cam_rows: np.ndarray | None = None,
    ) -> np.ndarray:
        """Rasterize one frame (H, W, 3) uint8; with ``return_depth`` also
        the (H, W) float32 camera-z buffer (sky clamped to the far plane)."""
        # world-space triangle soup
        tri_v, tri_c = [], []
        for g in self.geoms:
            R, p = R_bodies[g["body"]], p_bodies[g["body"]]
            world = g["verts"] @ R.T + p
            tris = world[g["faces"]]  # (F, 3, 3)
            tri_v.append(tris)
            tri_c.append(np.tile(g["color"], (len(tris), 1)))
        if not tri_v:
            return np.zeros((self.height, self.width, 3), np.uint8)
        tris = np.concatenate(tri_v)
        colors = np.concatenate(tri_c)

        if eye is not None and cam_rows is not None:
            # explicit camera frame (model-fixed cameras): rows are the
            # world->camera basis with z = view direction, y = image-down
            cam = np.asarray(cam_rows, float)
            eye = np.asarray(eye, float)
        else:
            # MuJoCo-style free camera tracking the root body
            center = tris.reshape(-1, 3)
            if lookat is None:
                lookat = np.array(
                    [p_bodies[0, 0], p_bodies[0, 1], max(p_bodies[0, 2] * 0.6, 0.3)]
                )
            if distance is None:
                extent = max(float(np.ptp(center, axis=0).max()), 0.5)
                distance = 2.2 * extent
            az, el = math.radians(azimuth), math.radians(elevation)
            forward = np.array(
                [math.cos(el) * math.cos(az), math.cos(el) * math.sin(az), math.sin(el)]
            )
            eye = lookat - distance * forward
            up = np.array([0.0, 0.0, 1.0])
            zc = forward / np.linalg.norm(forward)  # camera looks along +z
            xc = np.cross(zc, up)
            xc /= np.linalg.norm(xc) + 1e-12
            yc = np.cross(zc, xc)
            cam = np.stack([xc, yc, zc])  # world -> camera rows

        def project(points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
            """(N,3) world -> (N,2) pixel + (N,) depth."""
            rel = (points - eye) @ cam.T
            z = np.maximum(rel[:, 2], 1e-3)
            f = 1.2 * self.height  # ~45° vertical FoV
            x = self.width / 2 + f * rel[:, 0] / z
            y = self.height / 2 + f * rel[:, 1] / z
            return np.stack([x, y], axis=-1), z

        img = self._sky_and_floor(project, ground_z, eye, cam)
        zbuf = np.full((self.height, self.width), np.inf, np.float32)
        # rebuild floor depth so robot triangles sort against it
        self._floor_depth(zbuf, ground_z, eye, cam)

        # lighting: headlight + fixed sun
        light = np.array([0.4, 0.2, 0.9])
        light = light / np.linalg.norm(light)

        pix, depth = project(tris.reshape(-1, 3))
        pix = pix.reshape(-1, 3, 2)
        depth = depth.reshape(-1, 3)
        n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
        shade = 0.35 + 0.65 * np.clip(n @ light, 0, None)
        order = np.argsort(-depth.mean(axis=1))  # far-to-near for cache luck
        H, W = self.height, self.width
        for idx in order:
            p2 = pix[idx]
            zmean = depth[idx]
            x0 = max(int(p2[:, 0].min()), 0)
            x1 = min(int(p2[:, 0].max()) + 1, W)
            y0 = max(int(p2[:, 1].min()), 0)
            y1 = min(int(p2[:, 1].max()) + 1, H)
            if x0 >= x1 or y0 >= y1:
                continue
            xs = np.arange(x0, x1)
            ys = np.arange(y0, y1)
            gx, gy = np.meshgrid(xs, ys)
            # barycentric coordinates
            v0 = p2[1] - p2[0]
            v1 = p2[2] - p2[0]
            den = v0[0] * v1[1] - v1[0] * v0[1]
            if abs(den) < 1e-9:
                continue
            dx = gx - p2[0, 0]
            dy = gy - p2[0, 1]
            b1 = (dx * v1[1] - v1[0] * dy) / den
            b2 = (v0[0] * dy - dx * v0[1]) / den
            b0 = 1.0 - b1 - b2
            inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
            if not inside.any():
                continue
            zpix = b0 * zmean[0] + b1 * zmean[1] + b2 * zmean[2]
            tile = zbuf[y0:y1, x0:x1]
            write = inside & (zpix < tile)
            tile[write] = zpix[write]
            col = np.clip(colors[idx] * shade[idx] * 255, 0, 255).astype(np.uint8)
            region = img[y0:y1, x0:x1]
            region[write] = col
        if return_depth:
            sky = ~np.isfinite(zbuf)
            far = float(zbuf[~sky].max()) * 1.05 if (~sky).any() else 10.0
            depth = np.where(sky, far, zbuf).astype(np.float32)
            return img, depth
        return img

    # -- background --------------------------------------------------------

    def _sky_and_floor(self, project, ground_z, eye, cam) -> np.ndarray:
        H, W = self.height, self.width
        img = np.zeros((H, W, 3), np.uint8)
        # vertical sky gradient
        sky_t = np.linspace(0, 1, H)[:, None]
        img[..., 0] = (120 + 60 * sky_t).astype(np.uint8)
        img[..., 1] = (150 + 50 * sky_t).astype(np.uint8)
        img[..., 2] = (200 + 40 * sky_t).astype(np.uint8)
        if not self.has_floor:
            return img
        # per-pixel ray-plane intersection for the checkerboard
        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        f = 1.2 * H
        dirs = np.stack(
            [(xs - W / 2) / f, (ys - H / 2) / f, np.ones_like(xs, float)], axis=-1
        )
        dirs_w = dirs @ cam  # camera -> world (rows are world axes)
        dz = dirs_w[..., 2]
        t = (ground_z - eye[2]) / np.where(np.abs(dz) < 1e-9, 1e-9, dz)
        hit = (t > 0) & (dz < 0) if eye[2] > ground_z else (t > 0)
        px = eye[0] + t * dirs_w[..., 0]
        py = eye[1] + t * dirs_w[..., 1]
        checker = ((np.floor(px) + np.floor(py)) % 2).astype(bool)
        fade = np.clip(1.0 - t / (t[hit].max() + 1e-9) * 0.6, 0.3, 1.0) if hit.any() else 1.0
        base = np.where(checker, 110, 150).astype(float) * fade
        for c, w in zip(range(3), (1.0, 1.05, 0.95)):
            img[..., c] = np.where(hit, np.clip(base * w, 0, 255), img[..., c]).astype(
                np.uint8
            )
        return img

    def _floor_depth(self, zbuf, ground_z, eye, cam) -> None:
        if not self.has_floor:
            return
        H, W = self.height, self.width
        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        f = 1.2 * H
        dirs = np.stack(
            [(xs - W / 2) / f, (ys - H / 2) / f, np.ones_like(xs, float)], axis=-1
        )
        dirs_w = dirs @ cam
        dz = dirs_w[..., 2]
        t = (ground_z - eye[2]) / np.where(np.abs(dz) < 1e-9, 1e-9, dz)
        hit = t > 0
        zbuf[hit] = t[hit]


def _fixed_camera_spec(env) -> dict | None:
    """The model camera selected by ``camera_id``/``camera_name`` (reference
    mujoco_env.py:46-113 semantics: id -1 / no selection = the free tracking
    camera; id >= 0 / a name = the model's fixed cameras)."""
    cams = env.meta.get("cameras") or []
    if env.camera_name is not None:
        for cam in cams:
            if cam["name"] == env.camera_name:
                return cam
        return None
    cid = env.camera_id
    if cid is None or int(cid) < 0 or int(cid) >= len(cams):
        return None
    return cams[int(cid)]


def _fixed_camera_frame(env, spec: dict, R: np.ndarray, p: np.ndarray):
    """(eye, world->camera rows) for a model-fixed camera at the current
    pose. ``trackcom`` keeps the model orientation and parks the camera at
    subtree-COM + offset (MuJoCo semantics); ``fixed`` rides its body."""
    x = np.asarray(spec["xaxis"], float)
    y = np.asarray(spec["yaxis"], float)
    body = int(spec["body"])
    pos = np.asarray(spec["pos"], float)
    if spec.get("mode") == "trackcom":
        masses = np.asarray(env.model.bodies.mass, float)
        com_body = np.asarray(env.model.bodies.com, float)
        com_w = p + np.einsum("bij,bj->bi", R, com_body)
        anchor = (masses[:, None] * com_w).sum(0) / masses.sum()
        eye = anchor + pos
    else:
        Rb = R[body] if body >= 0 else np.eye(3)
        origin = p[body] if body >= 0 else np.zeros(3)
        eye = origin + Rb @ pos
        x, y = Rb @ x, Rb @ y
    x = x / (np.linalg.norm(x) + 1e-12)
    y = y / (np.linalg.norm(y) + 1e-12)
    z = np.cross(x, y)  # MuJoCo cameras look along -z, image-up is +y
    cam_rows = np.stack([x, -y, -z])  # projector: z = view dir, y = image-down
    return eye, cam_rows


def render_robot(
    env,
    width: int = 480,
    height: int = 480,
    camera_config: dict | None = None,
    depth: bool = False,
) -> np.ndarray:
    """Render a MujocoEnv's current state with its compiled Scene.

    ``camera_config`` mirrors the reference's ``default_camera_config``
    (mujoco_env.py:46-113): recognised keys are ``lookat``, ``distance``,
    ``azimuth`` and ``elevation`` (``trackbodyid`` is implicit — the free
    camera always tracks the root body when no lookat is given).
    """
    scene = getattr(env, "_render3d_scene", None)
    if scene is None or scene.width != width or scene.height != height:
        scene = Scene(env.meta, width, height)
        env._render3d_scene = scene
    # the env's forward kinematics of its current state, a batch of one on
    # its device, read back as numpy
    R, p = env._helper("fk")
    cfg = camera_config or {}
    kwargs = dict(
        ground_z=float(env.model.ground_z),
        lookat=np.asarray(cfg["lookat"], float) if "lookat" in cfg else None,
        distance=float(cfg["distance"]) if "distance" in cfg else None,
    )
    if "azimuth" in cfg:
        kwargs["azimuth"] = float(cfg["azimuth"])
    if "elevation" in cfg:
        kwargs["elevation"] = float(cfg["elevation"])
    spec = _fixed_camera_spec(env)
    if spec is not None:
        kwargs["eye"], kwargs["cam_rows"] = _fixed_camera_frame(env, spec, R, p)
    out = scene.render(R, p, return_depth=depth, **kwargs)
    if depth:
        return out[1]
    return out
