"""Throughput measurement and device profiling hooks (counterpart of the JAX
package's ``utils/performance.py``).

Parity surface: reference gymnasium/utils/performance.py:10-101
(``benchmark_step/init/render`` steps-per-second), plus what the reference
lacks: ``benchmark_compiled_rollout`` separates the first call from the
steady-state throughput of a :class:`~gymnasium_tpu_torch.vector.TorchVectorEnv`'s
rollout, and ``trace`` wraps ``torch.profiler`` for a timeline of the host
and the card.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import torch

import gymnasium_tpu_torch as gym

__all__ = [
    "benchmark_step",
    "benchmark_init",
    "benchmark_render",
    "benchmark_compiled_rollout",
    "trace",
]


def benchmark_step(env: gym.Env, target_duration: float = 5.0, seed: int | None = None) -> float:
    """Average steps/s of ``env.step`` over roughly ``target_duration`` seconds."""
    steps = 0
    end = 0.0
    env.reset(seed=seed)
    start = time.monotonic()
    while True:
        steps += 1
        action = env.action_space.sample()
        _, _, terminal, truncated, _ = env.step(action)
        if terminal or truncated:
            env.reset()
        end = time.monotonic()
        if end - start > target_duration:
            break
    length = end - start
    return steps / length


def benchmark_init(env_lambda: Callable[[], gym.Env], target_duration: float = 1.0, seed: int | None = None) -> float:
    """Average env constructions+resets per second."""
    inits = 0
    end = 0.0
    start = time.monotonic()
    while True:
        inits += 1
        env = env_lambda()
        env.reset(seed=seed)
        end = time.monotonic()
        if end - start > target_duration:
            break
    length = end - start
    return inits / length


def benchmark_render(env: gym.Env, target_duration: float = 5.0) -> float:
    """Average renders per second."""
    renders = 0
    end = 0.0
    start = time.monotonic()
    while True:
        renders += 1
        env.render()
        end = time.monotonic()
        if end - start > target_duration:
            break
    length = end - start
    return renders / length


def _synchronize(vector_env: Any) -> None:
    """Wait for the card's queued work when ``vector_env`` lives on CUDA."""
    device = torch.device(getattr(vector_env, "device", "cpu"))
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark_compiled_rollout(
    vector_env: Any,
    num_steps: int = 1024,
    repeats: int = 4,
) -> dict[str, float]:
    """Steady-state env-steps/s of a ``TorchVectorEnv``'s ``rollout``.

    Returns the first call's time and the per-repeat throughput separately
    (what the host-side ``benchmark_step`` conflates). Each timed window
    ends when the card has finished its work. The rollout is an eager loop
    that compiles nothing, so ``first_call_seconds`` holds what a first call
    costs instead: the build of any kernel at its first use (``nvcc``, or
    loading the built library) and the first launches.
    """
    vector_env.reset()
    t0 = time.perf_counter()
    vector_env.rollout(num_steps)
    _synchronize(vector_env)
    first_call = time.perf_counter() - t0

    t1 = time.perf_counter()
    for _ in range(repeats):
        vector_env.rollout(num_steps)
    _synchronize(vector_env)
    elapsed = time.perf_counter() - t1

    steps = vector_env.num_envs * num_steps * repeats
    return {
        "steps_per_second": steps / elapsed,
        "first_call_seconds": first_call,
        "steady_state_seconds_per_rollout": elapsed / repeats,
    }


@contextlib.contextmanager
def trace(log_dir: str, host_tracer_level: int = 2, device_tracer_level: int = 1):
    """Profile the enclosed block with ``torch.profiler`` and write a Chrome
    trace (``<host>_<pid>.<ns>.pt.trace.json``, which TensorBoard's profiler
    plugin and ``chrome://tracing`` read) under ``log_dir``.

    The host's operators and ``record_function`` ranges are always recorded;
    a ``device_tracer_level`` above 0 adds the card's kernels and copies when
    a CUDA device is present. ``host_tracer_level`` is kept for the JAX
    signature and changes nothing.

    The port's own ranges (:func:`~gymnasium_tpu_torch.utils.tracing.span`),
    recorded only while a profiler is active, as here: ``vector.rollout``,
    ``vector.step``, ``vector.actions``; ``func.transition``, ``func.reset``,
    ``func.observation``, ``func.reward``; ``mujoco.contact_wrenches``;
    ``ppo.rollout``, ``ppo.policy``, ``ppo.env_step``, ``ppo.advantages``,
    ``ppo.update``, ``ppo.backward``.
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device_tracer_level > 0 and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
