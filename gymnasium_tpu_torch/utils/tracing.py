"""Named host ranges at the port's layer boundaries.

``with span("func.reward"): ...`` records a ``torch.profiler`` range only
while a profiler is active, so the range lands in the same trace as the
card's kernels, on its clock, and :func:`~gymnasium_tpu_torch.utils.performance.trace`
or any other ``torch.profiler.profile`` sees it. With no profiler active a
span is one check and a shared null context: an entered
``record_function`` costs ~11 µs of host time even then, a span ~0.5 µs
(the host of an NVIDIA H100 machine).

The spans (name: where, what it holds):

- ``vector.rollout``: ``TorchVectorEnv.rollout``, a block with its
  trajectory stack;
- ``vector.step``: each env step of ``rollout`` and ``TorchVectorEnv.step``;
  the action draw, the autoreset step, the flags;
- ``vector.actions``: ``rollout``'s ``action_fn`` call (by default
  ``Box.sample_torch``);
- ``func.transition``, ``func.reset``, ``func.observation``,
  ``func.reward``: the hooks of ``functional.make_autoreset_step`` (the
  reset is drawn for the whole batch and selected lane by lane);
- ``mujoco.contact_wrenches``: ``physics/articulated.py``'s contact
  wrenches, one launch of the model's generated kernel on the card (Ant
  calls them in its observation and its reward);
- ``mujoco.com_velocity``: ``envs/mujoco/humanoid.py::com_velocity``, the
  bodies' centre-of-mass velocities, one launch of the model's generated
  kernel on the card (``ops/com_kinematics.py``), once in each Humanoid or
  HumanoidStandup observation;
- ``mujoco.mass_center``: ``HumanoidFunctional._com_x``, the whole
  robot's centre of mass along x, one launch of the same build's other
  kernel, twice in each Humanoid reward;
- ``ppo.rollout``, ``ppo.policy``, ``ppo.env_step``, ``ppo.advantages``,
  ``ppo.update``, ``ppo.backward``: the trainer (``train/ppo.py``).
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["span"]

_NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager: ``torch.profiler.record_function(name)`` while a
    profiler is active, otherwise one shared null context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL
