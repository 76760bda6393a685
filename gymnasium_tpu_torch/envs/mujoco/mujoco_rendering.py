"""Import-compatibility module: the reference exposes its renderer classes
as ``gymnasium.envs.mujoco.mujoco_rendering`` (mujoco_rendering.py:685);
this package's implementations live in :mod:`gymnasium_tpu_torch.envs.mujoco.
rendering` and are re-exported here under the reference's module path."""

from gymnasium_tpu_torch.envs.mujoco.rendering import (
    GRID_BOTTOMLEFT,
    GRID_BOTTOMRIGHT,
    GRID_TOPLEFT,
    GRID_TOPRIGHT,
    MujocoRenderer,
    _Viewer as BaseRender,
)

__all__ = [
    "MujocoRenderer",
    "BaseRender",
    "OffScreenViewer",
    "GRID_TOPLEFT",
    "GRID_TOPRIGHT",
    "GRID_BOTTOMLEFT",
    "GRID_BOTTOMRIGHT",
]


class OffScreenViewer:
    """Offscreen-frame role of the reference's OffScreenViewer
    (mujoco_rendering.py:237). The reference class rasterizes a MuJoCo
    ``MjModel``/``MjData`` pair through OpenGL; this engine renders its own
    compiled models through the software rasterizer, so the offscreen role
    is served per-env by ``env.mujoco_renderer.render("rgb_array")`` and
    this class only supports that construction."""

    def __init__(self, env, width: int | None = None, height: int | None = None, **_: object):
        from gymnasium_tpu_torch.envs.mujoco.mujoco_env import MujocoEnv

        if not isinstance(env, MujocoEnv):
            raise TypeError(
                "this engine renders its own compiled models; construct "
                "OffScreenViewer with a gymnasium_tpu_torch MujocoEnv (MuJoCo "
                "MjModel/MjData structures belong to the MuJoCo C library)"
            )
        self._env = env
        if width is not None:
            env.width = int(width)
        if height is not None:
            env.height = int(height)
        self.viewport = (env.width, env.height)

    def render(self, render_mode: str = "rgb_array", camera_id: int | None = None):
        if camera_id is not None:
            self._env.camera_id = None if camera_id < 0 else camera_id
        return self._env.mujoco_renderer.render(render_mode)

    def close(self) -> None:
        self._env.mujoco_renderer.close()
