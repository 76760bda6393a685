"""BipedalWalker's terrain: the hand-written CUDA kernel's wrapper and its twin.

The JAX package computes the heightfield with a ``lax.scan`` inside
``envs/box2d/bipedal_walker.py::generate_terrain`` and adds the hardcore
obstacles in ``_overlay_obstacles``; no TPU kernel replaces it. The port
draws a reset for the whole batch on every env step, and the recurrence is
200 sequential points, so on a CUDA tensor :func:`walker_terrain` launches
``csrc/walker_terrain.cu`` (a block of 8 envs, a thread a column to load,
divide and store, a thread an env to walk; see the source for its design and
bound). On a CPU tensor it runs
:func:`walker_terrain_reference`, the same float32 loop over ``(N,)``
columns. A failed build or launch raises; it never gives way to the twin.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gymnasium_tpu_torch.ops import build

__all__ = ["walker_terrain", "walker_terrain_reference", "launches", "LENGTH"]

#: Number of kernel launches made by :func:`walker_terrain`: Python calls of
#: the launch (under a CUDA graph, its capture only), not kernels on the card,
#: which the profiler counts.
launches = 0

LENGTH = 200  # TERRAIN_LENGTH
START_PAD = 20  # TERRAIN_STARTPAD
HEIGHT = 400 / 30.0 / 4  # TERRAIN_HEIGHT = VIEWPORT_H / SCALE / 4
SCALE = 30.0
STEP = 14 / SCALE  # TERRAIN_STEP
WINDOWS = range(START_PAD + 10, LENGTH - 10, 15)  # the hardcore obstacle windows


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("walker_terrain").walker_terrain_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(u, draws):
    if not isinstance(u, torch.Tensor) or u.dim() != 2 or u.shape[1] != LENGTH or u.shape[0] < 1:
        raise ValueError(f"u must be an (N, {LENGTH}) tensor with N >= 1, got {getattr(u, 'shape', type(u))}")
    if draws is not None:
        if not isinstance(draws, torch.Tensor) or tuple(draws.shape) != tuple(u.shape):
            raise ValueError(f"draws must be a {tuple(u.shape)} tensor, got {getattr(draws, 'shape', type(draws))}")
        if draws.device != u.device:
            raise ValueError(f"draws are on {draws.device}, u on {u.device}")


def walker_terrain_reference(u: torch.Tensor, draws: torch.Tensor | None = None) -> torch.Tensor:
    """The plain twin: heights (N, 200) float32 of U[-1, 1) steps ``u`` (N,
    200), with the hardcore obstacles of U[0, 1) ``draws`` when given.

    Every division is by a tensor on ``u``'s device: torch divides a CUDA
    tensor by a python float as a multiply by its reciprocal."""
    _check(u, draws)
    u = u.to(torch.float32)
    n, dev = u.shape[0], u.device
    steps = torch.div(u, torch.tensor(SCALE, dtype=torch.float32, device=dev))
    y = torch.full((n,), HEIGHT, dtype=torch.float32, device=dev)
    v = torch.zeros((n,), dtype=torch.float32, device=dev)
    heights = []
    for i in range(LENGTH):
        v = 0.8 * v + 0.01 * torch.sign(HEIGHT - y)
        if i > START_PAD:
            v = v + steps[:, i]
        y = y + v
        heights.append(y)
    out = torch.stack(heights, dim=1)
    if draws is None:
        return out
    draws = draws.to(torch.float32)
    k = torch.arange(6, device=dev)
    stair = torch.clamp(k // 2, 0, 2).to(torch.float32) * STEP
    pair = k < 2
    for s in WINDOWS:
        d_type, d_size = draws[:, s : s + 1], draws[:, s + 1 : s + 2]
        stump = (1.0 + 2.0 * d_size) * STEP
        pit = -(2.0 + 2.0 * d_size) * STEP
        delta = torch.where(
            d_type < 0.33,
            torch.where(pair, stump, 0.0),
            torch.where(d_type < 0.66, stair, torch.where(pair, pit, 0.0)),
        )
        out[:, s : s + 6] = out[:, s : s + 6] + delta
    return out


def walker_terrain(u: torch.Tensor, draws: torch.Tensor | None = None) -> torch.Tensor:
    """Heights (N, 200) float32: the kernel on a CUDA tensor (on the current
    stream, without synchronising), the twin on a CPU tensor."""
    global launches
    if u.device.type == "cpu":
        return walker_terrain_reference(u, draws)
    _check(u, draws)
    if u.device.type != "cuda":
        raise ValueError(f"walker_terrain runs on cuda or cpu tensors, got {u.device}")
    u = u.to(torch.float32).contiguous()
    d = None if draws is None else draws.to(torch.float32).contiguous()
    out = torch.empty_like(u)
    launch = _launcher()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = launch(u.data_ptr(), None if d is None else d.data_ptr(), out.data_ptr(), u.shape[0],
                    int(d is not None), stream)
    if rc != 0:
        raise RuntimeError(f"walker_terrain kernel launch failed with cudaError {rc}")
    launches += 1
    return out
