"""Plain PyTorch reference of the MuJoCo-class robots the benchmark runs.

An independent, vectorised statement of the engine the port's articulated
kernel implements: forward kinematics with a free root's quaternion, the
bodies' Jacobians, the Newton-Euler bias with gravity and joint springs,
joint-limit and soft-contact penalties with a friction cone, the dense
mass matrix with armature and implicit damping, a Cholesky solve and
semi-implicit Euler. It reads the robots' raw model files (copies beside
this file) and nothing of the program, and runs in any float dtype:
float64 to judge the program's float32, a lower dtype for the control.

Tensors are batch-first: ``q (N, nq)``, ``qd (N, nv)``, ``ctrl (N, nu)``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

MODEL_DIR = Path(__file__).resolve().parent / "models"
SLIDE, HINGE = 0, 1

# Engine constants the model files do not carry (the engine's defaults).
CONTACT_DAMP_RATIO = 1.4
CONTACT_ALPHA = 1.0
FRICTION = 1.0
LIMIT_STIFFNESS = 500.0


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def cholesky_solve(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``M x = b`` for a batch of small symmetric positive definite ``M``,
    by a Cholesky factorisation written column by column (a lower dtype
    is factorised in float32)."""
    dtype = M.dtype
    M, b = M.to(torch.promote_types(dtype, torch.float32)), b.to(torch.promote_types(dtype, torch.float32))
    n = M.shape[-1]
    L = torch.zeros_like(M)
    for j in range(n):
        d = torch.sqrt(M[:, j, j] - torch.sum(L[:, j, :j] * L[:, j, :j], -1))
        L[:, j, j] = d
        if j + 1 < n:
            L[:, j + 1:, j] = (M[:, j + 1:, j] - torch.sum(L[:, j + 1:, :j] * L[:, j, None, :j], -1)) / d[:, None]
    y = torch.zeros_like(b)
    for i in range(n):
        y[:, i] = (b[:, i] - torch.sum(L[:, i, :i] * y[:, :i], -1)) / L[:, i, i]
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        x[:, i] = (y[:, i] - torch.sum(L[:, i + 1:, i] * x[:, i + 1:], -1)) / L[:, i, i]
    return x.to(dtype)


class Robot:
    """One robot's tables, as float64 numpy, and its substep over torch."""

    def __init__(self, name: str, frame_skip: int):
        data = np.load(MODEL_DIR / f"{name}.npz")
        meta = json.loads(bytes(data["meta_json"]).decode())
        self.name, self.frame_skip = name, frame_skip
        self.free = bool(meta.get("free_root", False))
        f64 = lambda key: np.asarray(data[key], np.float64)  # noqa: E731
        self.parent = data["bodies_parent"].astype(int)
        self.body_pos, self.body_quat = f64("bodies_pos"), f64("bodies_quat")
        self.mass, self.com, self.inertia = f64("bodies_mass"), f64("bodies_com"), f64("bodies_inertia")
        self.dof_start, self.dof_count = data["bodies_dof_start"].astype(int), data["bodies_dof_count"].astype(int)
        self.jbody, self.jtype = data["joints_body"].astype(int), data["joints_jtype"].astype(int)
        self.axis, self.anchor = f64("joints_axis"), f64("joints_anchor")
        self.damping, self.armature = f64("joints_damping"), f64("joints_armature")
        self.limited = data["joints_limited"].astype(bool)
        self.lower, self.upper = f64("joints_lower"), f64("joints_upper")
        self.stiffness, self.ref = f64("joints_stiffness"), f64("joints_ref")
        self.contact_body = data["contact_body"].astype(int)
        self.contact_pos, self.contact_radius = f64("contact_pos"), f64("contact_radius")
        self.act_dof, self.gear = data["act_dof"].astype(int), f64("act_gear")
        self.ctrlrange = f64("act_ctrlrange")
        self.gravity, self.timestep = float(data["gravity"]), float(data["timestep"])
        self.ground_z = float(data["ground_z"]) if "ground_z" in data.files else 0.0
        contact_stiffness = f64("contact_stiffness") if "contact_stiffness" in data.files else 1e5
        self.nbody, self.nv, self.nu = len(self.parent), len(self.jbody), len(self.act_dof)
        self.nq = self.nv + 1 if self.free else self.nv
        self.dt = self.timestep * frame_skip

        # dof k moves body b: k belongs to b or to one of its ancestors
        self.amask = np.zeros((self.nbody, self.nv), bool)
        for b in range(self.nbody):
            node = b
            while node >= 0:
                self.amask[b, self.dof_start[node]: self.dof_start[node] + self.dof_count[node]] = True
                node = self.parent[node]
        # dof j acts before dof k on k's chain
        self.strict = np.zeros((self.nv, self.nv), bool)
        for k in range(self.nv):
            b = self.jbody[k]
            if self.parent[b] >= 0:
                self.strict[k] = self.amask[self.parent[b]]
            self.strict[k, self.dof_start[b]:k] = True
        self.strict_rot = self.strict.copy()
        if self.free:
            self.strict_rot[3:6, 3:6] = True
        self.q_index = np.array([k + 1 if self.free and k >= 6 else k for k in range(self.nv)])

        # soft contacts: a spring capped for explicit stability at the body's mass
        m_eff = np.maximum(self.mass[self.contact_body], 1e-3)
        self.contact_k = np.minimum(contact_stiffness, m_eff * (CONTACT_ALPHA / self.timestep) ** 2)
        self.contact_c = CONTACT_DAMP_RATIO * np.sqrt(self.contact_k * m_eff)
        # joint limits: a spring scaled to the dof's peak actuator torque
        tau_max = np.zeros(self.nv)
        for d, g in zip(self.act_dof, np.abs(self.gear)):
            tau_max[d] = max(tau_max[d], g)
        m_dof = self.armature + 0.02
        self.limit_k = np.clip(np.maximum(LIMIT_STIFFNESS, tau_max / 0.05), None, 0.25 * m_dof / self.timestep**2)
        self.limit_c = 1.4 * np.sqrt(self.limit_k * m_dof)

        # the rest pose
        if self.free:
            root = self.jbody[0]
            self.init_qpos = np.concatenate([self.body_pos[root], self.body_quat[root], self.ref[6:]])
        else:
            self.init_qpos = self.ref.copy()
        self._on: dict = {}

    def tables(self, device, dtype) -> dict:
        """The tables as tensors on ``device`` in ``dtype``, made once."""
        key = (str(device), dtype)
        if key not in self._on:
            t = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=device).to(dtype)  # noqa: E731
            b = lambda x: torch.as_tensor(np.asarray(x, bool), device=device)  # noqa: E731
            self._on[key] = {
                "fixed_R": t(np.stack([_quat_to_mat(q) for q in self.body_quat])),
                "body_pos": t(self.body_pos), "com": t(self.com), "inertia": t(self.inertia), "mass": t(self.mass),
                "axis": t(self.axis), "anchor": t(self.anchor), "ref": t(self.ref),
                "damping": t(self.damping), "armature": t(self.armature), "stiffness": t(self.stiffness),
                "lower": t(self.lower), "upper": t(self.upper), "limited": b(self.limited),
                "limit_k": t(self.limit_k), "limit_c": t(self.limit_c),
                "amask": t(self.amask), "strict": t(self.strict), "strict_rot": t(self.strict_rot),
                "hinge": b(self.jtype == HINGE), "slide": b(self.jtype == SLIDE),
                "cmask": t(self.amask[self.contact_body]), "contact_pos": t(self.contact_pos),
                "contact_radius": t(self.contact_radius), "contact_k": t(self.contact_k), "contact_c": t(self.contact_c),
                "csel": t(np.eye(self.nbody)[self.contact_body]),
                "gear": t(self.gear), "lo": t(self.ctrlrange[:, 0]), "hi": t(self.ctrlrange[:, 1]),
                "act": t(np.eye(self.nv)[self.act_dof]),
                "init_qpos": t(self.init_qpos),
            }
        return self._on[key]

    # -- kinematics ----------------------------------------------------------

    def kinematics(self, q, c):
        """Bodies' rotations ``R (N, nb, 3, 3)`` and origins ``p (N, nb, 3)``,
        each dof's world axis and pivot ``(N, nv, 3)``."""
        n = q.shape[0]
        eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(n, 3, 3)
        zero = torch.zeros((n, 3), dtype=q.dtype, device=q.device)
        Rs, ps = [None] * self.nbody, [None] * self.nbody
        axes, pivots = [None] * self.nv, [None] * self.nv
        for b in range(self.nbody):
            parent = self.parent[b]
            R_p, p_p = (eye, zero) if parent < 0 else (Rs[parent], ps[parent])
            start, count = self.dof_start[b], self.dof_count[b]
            if self.free and start == 0 and count == 6:
                quat = q[:, 3:7]
                w, x, y, z = quat.unbind(-1)
                s = 2.0 / torch.clamp(torch.sum(quat * quat, -1), min=1e-12)
                R = torch.stack([
                    torch.stack([1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)], -1),
                    torch.stack([s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)], -1),
                    torch.stack([s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)], -1),
                ], -2)
                p = q[:, 0:3]
                for k in range(3):
                    axes[k], pivots[k] = eye[:, :, k], zero
                    axes[3 + k], pivots[3 + k] = R[:, :, k], p
                Rs[b], ps[b] = R, p
                continue
            R = R_p @ c["fixed_R"][b]
            p = p_p + (R_p @ c["body_pos"][b][:, None])[..., 0]
            for k in range(start, start + count):
                qk = q[:, self.q_index[k]] - c["ref"][k]
                axis, anchor = c["axis"][k], c["anchor"][k]
                axes[k] = (R @ axis[:, None])[..., 0]
                if self.jtype[k] == SLIDE:
                    pivots[k] = zero
                    p = p + axes[k] * qk[:, None]
                else:
                    pivots[k] = p + (R @ anchor[:, None])[..., 0]
                    cos, sin = torch.cos(qk)[:, None, None], torch.sin(qk)[:, None, None]
                    K = torch.zeros((3, 3), dtype=q.dtype, device=q.device)
                    K[0, 1], K[0, 2], K[1, 2] = -axis[2], axis[1], -axis[0]
                    K[1, 0], K[2, 0], K[2, 1] = axis[2], -axis[1], axis[0]
                    Rj = cos * torch.eye(3, dtype=q.dtype, device=q.device) + sin * K + (1 - cos) * torch.outer(axis, axis)
                    p = p + (R @ (anchor[:, None] - Rj @ anchor[:, None]))[..., 0]
                    R = R @ Rj
            Rs[b], ps[b] = R, p
        return torch.stack(Rs, 1), torch.stack(ps, 1), torch.stack(axes, 1), torch.stack(pivots, 1)

    def contact_forces(self, q, qd, c, R, p, axes, pivots):
        """The contact spheres' centres ``(N, nc, 3)``, their Jacobians
        ``(N, nc, nv, 3)`` and forces ``(N, nc, 3)``."""
        cb = self.contact_body
        pts = p[:, cb] + (R[:, cb] @ c["contact_pos"][None, :, :, None])[..., 0]
        lever = pts[:, :, None, :] - pivots[:, None, :, :]
        ax = axes[:, None].expand_as(lever)
        J = torch.where(c["slide"][None, None, :, None], ax, torch.linalg.cross(ax, lever, dim=-1))
        J = J * c["cmask"][None, :, :, None]
        vel = torch.sum(J * qd[:, None, :, None], dim=2)
        depth = c["contact_radius"] - (pts[..., 2] - self.ground_z)
        fn = torch.clamp(torch.where(depth > 0, c["contact_k"] * depth - c["contact_c"] * vel[..., 2], 0.0), min=0.0)
        ft = -c["contact_c"][:, None] * vel[..., 0:2]
        ft_norm = torch.sqrt(torch.sum(ft * ft, -1) + 1e-12)
        scale = torch.clamp(FRICTION * fn / ft_norm, max=1.0)
        return pts, J, torch.cat([ft * scale[..., None], fn[..., None]], -1)

    def contact_wrenches(self, q, qd):
        """Each body's external contact wrench ``[torque, force]`` about its
        centre of mass, ``(N, nbody, 6)`` (MuJoCo's ``cfrc_ext``)."""
        c = self.tables(q.device, q.dtype)
        R, p, axes, pivots = self.kinematics(q, c)
        pc = p + (R @ c["com"][None, :, :, None])[..., 0]
        pts, _, f = self.contact_forces(q, qd, c, R, p, axes, pivots)
        torque = torch.linalg.cross(pts - pc[:, self.contact_body], f, dim=-1)
        sel = c["csel"]  # (nc, nbody)
        return torch.cat([torch.einsum("ncx,cb->nbx", torque, sel), torch.einsum("ncx,cb->nbx", f, sel)], -1)

    # -- the substep ---------------------------------------------------------

    def substep(self, q, qd, tau_act, c):
        nv = self.nv
        R, p, axes, pivots = self.kinematics(q, c)
        pc = p + (R @ c["com"][None, :, :, None])[..., 0]
        Iw = R @ c["inertia"] @ R.transpose(-1, -2)
        hinge, slide, amask = c["hinge"], c["slide"], c["amask"]
        # com Jacobians (N, nb, nv, 3); angular ones of the hinges
        ax_b = axes[:, None].expand(-1, self.nbody, -1, -1)
        lever = pc[:, :, None, :] - pivots[:, None, :, :]
        Jv = torch.where(slide[None, None, :, None], ax_b, torch.linalg.cross(ax_b, lever, dim=-1)) * amask[None, :, :, None]
        Jw = ax_b * (amask * hinge)[None, :, :, None]

        # convective terms
        u = axes * (qd * hinge)[..., None]  # hinge dofs' angular velocities
        s = axes * (qd * slide)[..., None]  # slide dofs' linear velocities
        w_pre = torch.einsum("kj,njx->nkx", c["strict_rot"], u)
        daw = torch.linalg.cross(w_pre, axes, dim=-1)
        uk = u[:, None].expand(-1, nv, -1, -1)
        rel = torch.linalg.cross(uk, pivots[:, :, None, :] - pivots[:, None, :, :], dim=-1)  # [n, k, j]
        dow = torch.einsum("kj,nkjx->nkx", c["strict"], torch.where(slide[None, None, :, None], s[:, None].expand_as(rel), rel))
        dpc = torch.einsum("nbkx,nk->nbx", Jv, qd)
        daw_b = daw[:, None].expand(-1, self.nbody, -1, -1)
        dJ_hinge = torch.linalg.cross(daw_b, lever, dim=-1) + torch.linalg.cross(
            ax_b, dpc[:, :, None, :] - dow[:, None, :, :], dim=-1)
        dJ = torch.where(slide[None, None, :, None], daw_b, dJ_hinge) * amask[None, :, :, None]
        a0 = torch.einsum("nbkx,nk->nbx", dJ, qd)
        al0 = torch.einsum("bk,nkx->nbx", amask * hinge, daw * qd[..., None])
        wb = torch.einsum("bk,nkx->nbx", amask, u)

        # bias: Newton-Euler velocity terms, gravity and joint springs
        f_lin = a0 * c["mass"][:, None]
        Iww = (Iw @ wb[..., None])[..., 0]
        t_ang = (Iw @ al0[..., None])[..., 0] + torch.linalg.cross(wb, Iww, dim=-1)
        bias = torch.einsum("nbkx,nbx->nk", Jv, f_lin) + torch.einsum("nbkx,nbx->nk", Jw, t_ang)
        bias = bias - self.gravity * torch.einsum("b,nbk->nk", c["mass"], Jv[..., 2])
        bias = bias + c["stiffness"] * (q[:, self.q_index] - c["ref"])

        # torques: actuation, joint limits, contacts
        qj = q[:, self.q_index]
        below = torch.clamp(qj - c["lower"], max=0.0)
        above = torch.clamp(qj - c["upper"], min=0.0)
        violating = (below < 0) | (above > 0)
        t_lim = -c["limit_k"] * (below + above) - torch.where(violating, c["limit_c"] * qd, 0.0)
        tau = tau_act + torch.where(c["limited"], t_lim, 0.0)
        if len(self.contact_body):
            _, Jc, f = self.contact_forces(q, qd, c, R, p, axes, pivots)
            tau = tau + torch.einsum("ncKx,ncx->nK", Jc, f)

        # mass matrix with armature and implicit damping, and the solve
        M = torch.einsum("b,nbix,nbjx->nij", c["mass"], Jv, Jv)
        M = M + torch.einsum("nbix,nbxy,nbjy->nij", Jw, Iw, Jw)
        M = M + torch.diag_embed(c["armature"] + self.timestep * c["damping"] + 1e-9).expand_as(M)
        rhs = tau - bias - c["damping"] * qd
        qacc = cholesky_solve(M, rhs)

        # semi-implicit Euler; a free root's quaternion turns by exp(dt w / 2)
        dt = self.timestep
        qd_new = qd + dt * qacc
        if not self.free:
            return q + dt * qd_new, qd_new
        v = dt * qd_new[:, 3:6]
        th2 = torch.sum(v * v, -1)
        big = th2 > 1e-10
        th = torch.sqrt(torch.where(big, th2, 1.0))
        sinc = torch.where(big, torch.sin(0.5 * th) / th, 0.5 - th2 / 48.0)
        cosh = torch.where(big, torch.cos(0.5 * th), 1.0 - th2 / 8.0 + th2 * th2 / 384.0)
        a, b_, c_, d = q[:, 3:7].unbind(-1)
        e, fx, fy, fz = cosh, sinc * v[:, 0], sinc * v[:, 1], sinc * v[:, 2]
        quat = torch.stack([
            a * e - b_ * fx - c_ * fy - d * fz,
            a * fx + b_ * e + c_ * fz - d * fy,
            a * fy - b_ * fz + c_ * e + d * fx,
            a * fz + b_ * fy - c_ * fx + d * e,
        ], -1)
        quat = quat / torch.sqrt(torch.sum(quat * quat, -1, keepdim=True) + 1e-24)
        return torch.cat([q[:, 0:3] + dt * qd_new[:, 0:3], quat, q[:, 7:] + dt * qd_new[:, 6:]], 1), qd_new

    def step(self, q, qd, ctrl):
        """``frame_skip`` substeps under the controls ``ctrl``, clipped once."""
        c = self.tables(q.device, q.dtype)
        ctrl = torch.minimum(torch.maximum(ctrl, c["lo"]), c["hi"])
        tau_act = (ctrl * c["gear"]) @ c["act"]
        for _ in range(self.frame_skip):
            q, qd = self.substep(q, qd, tau_act, c)
        return q, qd

    def reset(self, u, z, noise: float):
        """The reset state of draws ``u ~ U[0, 1)`` (N, nq) and ``z ~ N(0, 1)``
        (N, nv): the rest pose plus ``U[-noise, noise)``, a free root's
        quaternion renormalised, and velocities ``noise * z``."""
        c = self.tables(u.device, u.dtype)
        lo = float(np.float32(-noise))
        qpos = c["init_qpos"] + torch.clamp(u * float(np.float32(noise) - np.float32(-noise)) + lo, min=lo)
        if self.free:
            w, x, y, zq = qpos[:, 3:7].unbind(-1)
            norm = torch.sqrt(w * w + x * x + y * y + zq * zq + 1e-24)
            qpos = torch.cat([qpos[:, :3], qpos[:, 3:7] / norm[:, None], qpos[:, 7:]], 1)
        return qpos, noise * z


class Locomotion:
    """A Gymnasium v5 locomotion task over a :class:`Robot`, from a cell's
    configuration (its ``task`` group): observation, reward and
    termination as the task's published spec states them, the reset, and
    the draws the program's default random actions and resets make."""

    def __init__(self, config: dict):
        spec = config["task"]
        self.spec = spec
        self.robot = Robot(spec["model"], spec["frame_skip"])
        self.exclude = int(spec["exclude_positions"])
        self.cfrc = bool(spec.get("include_cfrc_ext", False))
        self.healthy_z = spec.get("healthy_z_range")
        self.noise = float(spec["reset_noise_scale"])

    # -- draws ---------------------------------------------------------------

    def random_actions(self, gen: torch.Generator, n: int, device) -> torch.Tensor:
        """A batch of default random actions from ``gen``, drawn as a bounded
        Box samples: a uniform, a normal and two exponential draws of the
        action shape, the actions ``low + u (high - low)`` in float32."""
        f32 = dict(dtype=torch.float32, device=device)
        shape = (n, self.robot.nu)
        uniform = torch.rand(shape, generator=gen, **f32)
        torch.randn(shape, generator=gen, **f32)
        torch.empty(shape, **f32).exponential_(generator=gen)
        torch.empty(shape, **f32).exponential_(generator=gen)
        low = torch.as_tensor(self.robot.ctrlrange[:, 0], **f32)
        high = torch.as_tensor(self.robot.ctrlrange[:, 1], **f32)
        return low + uniform * (high - low)

    def reset_draws(self, gen: torch.Generator, n: int, device) -> tuple:
        """One step's reset draws, made for the whole batch:
        ``U[0, 1) (n, nq)``, then ``N(0, 1) (n, nv)``."""
        return (torch.rand((n, self.robot.nq), generator=gen, device=device),
                torch.randn((n, self.robot.nv), generator=gen, device=device))

    def reset(self, draws: tuple, dtype=torch.float32) -> tuple:
        """``(q, qd)`` of a reset from its draws, in ``dtype``."""
        return tuple(x.to(dtype) for x in self.robot.reset(*draws, self.noise))

    def step(self, q, qd, action) -> tuple:
        return self.robot.step(q, qd, action)

    @staticmethod
    def state_from_carry(state: dict) -> tuple:
        """``(q, qd)`` of the state an env step carries."""
        return state["qpos"], state["qvel"]

    # -- the task ------------------------------------------------------------

    def observation(self, q, qd):
        parts = [q[:, self.exclude:], qd]
        if self.cfrc:
            parts.append(self.robot.contact_wrenches(q, qd).reshape(q.shape[0], -1))
        return torch.cat(parts, 1)

    def healthy(self, q, qd):
        z = q[:, 2]
        finite = torch.isfinite(q).all(1) & torch.isfinite(qd).all(1)
        return finite & (z >= self.healthy_z[0]) & (z <= self.healthy_z[1])

    def terminated(self, q, qd):
        if self.healthy_z is None:
            return torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
        return ~self.healthy(q, qd)

    def reward(self, q_before, q, qd, action, judged_q=None):
        """The step's reward from the state before ``q_before`` to ``(q,
        qd)``; ``judged_q``, where given, is the state whose torso height
        the healthy bonus reads (the judged one, so that a height on the
        bound does not flip it)."""
        s = self.spec
        r = s["forward_reward_weight"] * (q[:, 0] - q_before[:, 0]) / self.robot.dt
        r = r - s["ctrl_cost_weight"] * torch.sum(action * action, -1)
        if self.healthy_z is not None:
            z = (q if judged_q is None else judged_q)[:, 2]
            r = r + s["healthy_reward"] * (z >= self.healthy_z[0]) * (z <= self.healthy_z[1])
        if self.cfrc:
            cf = torch.clamp(self.robot.contact_wrenches(q, qd), *s["contact_force_range"])
            r = r - s["contact_cost_weight"] * torch.sum(cf * cf, (1, 2))
        return r

    def state_from_obs(self, obs):
        """``(q, qd)`` of an observation, the excluded positions at 0: the
        tasks are invariant to them."""
        n, nq, nv = obs.shape[0], self.robot.nq, self.robot.nv
        q = torch.cat([torch.zeros((n, self.exclude), dtype=obs.dtype, device=obs.device),
                       obs[:, : nq - self.exclude]], 1)
        return q, obs[:, nq - self.exclude: nq - self.exclude + nv]
