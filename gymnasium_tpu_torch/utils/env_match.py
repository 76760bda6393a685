"""Rollout-equivalence checker between two environments (copy of the JAX
package's ``utils/env_match.py``).

Parity with reference gymnasium/utils/env_match.py:7 — the framework's own
tool for "bit-exact vs reference" testing. Values compare as host arrays,
a tensor read back through
:func:`~gymnasium_tpu_torch.utils.device.to_host`, so an env on the card
can be matched against one on the CPU.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from gymnasium_tpu_torch.utils.data_equivalence import data_equivalence
from gymnasium_tpu_torch.utils.device import to_host

__all__ = ["check_environments_match"]


def check_environments_match(
    env_a,
    env_b,
    num_steps: int,
    seed: int = 0,
    skip_obs: bool = False,
    skip_rew: bool = False,
    skip_terminal: bool = False,
    skip_truncated: bool = False,
    skip_info: bool = False,
    info_comparator=None,
    atol: float = 0.0,
    info_comparison: str | None = None,
    skip_render: bool = True,
):
    """Step both envs with identical action streams and assert equal outputs.

    ``atol=0`` demands bit-exact equality; a positive tolerance relaxes
    float comparisons (used for cross-dtype device-vs-host checks).

    ``info_comparison`` accepts the reference's string modes
    (env_match.py:32-37): "equivalence", "superset" (``info_b`` must contain
    every item of ``info_a``), "keys-equivalence", "keys-superset", "skip".
    ``skip_render=False`` additionally asserts identical rendered frames
    (auto-skipped for None/"human" render modes, as in the reference).
    """
    if info_comparison is not None:
        assert info_comparison in (
            "equivalence",
            "superset",
            "skip",
            "keys-equivalence",
            "keys-superset",
        )
        if info_comparison == "skip":
            skip_info = True
        elif info_comparison == "superset":
            info_comparator = lambda a, b: all(  # noqa: E731
                k in b and data_equivalence(a[k], b[k]) for k in a
            )
        elif info_comparison == "keys-equivalence":
            info_comparator = lambda a, b: a.keys() == b.keys()  # noqa: E731
        elif info_comparison == "keys-superset":
            info_comparator = lambda a, b: b.keys() >= a.keys()  # noqa: E731
    if info_comparator is None:
        info_comparator = data_equivalence
    skip_render = (
        skip_render
        or env_a.unwrapped.render_mode in (None, "human")
        or env_b.unwrapped.render_mode in (None, "human")
    )

    assert env_a.action_space == env_b.action_space, (
        f"Action spaces differ: {env_a.action_space} vs {env_b.action_space}"
    )

    obs_a, info_a = env_a.reset(seed=seed)
    obs_b, info_b = env_b.reset(seed=seed)

    if not skip_obs:
        assert _values_match(obs_a, obs_b, atol), f"Reset obs differ: {obs_a} vs {obs_b}"
    if not skip_info:
        assert info_comparator(info_a, info_b), f"Reset infos differ: {info_a} vs {info_b}"
    if not skip_render:
        assert np.array_equal(np.asarray(env_a.render()), np.asarray(env_b.render())), (
            "Reset renders differ"
        )

    env_a.action_space.seed(seed)
    for step in range(num_steps):
        action = env_a.action_space.sample()
        obs_a, rew_a, term_a, trunc_a, info_a = env_a.step(action)
        obs_b, rew_b, term_b, trunc_b, info_b = env_b.step(action)

        if not skip_obs:
            assert _values_match(obs_a, obs_b, atol), (
                f"Step {step} obs differ: {obs_a} vs {obs_b}"
            )
        if not skip_rew:
            assert _values_match(rew_a, rew_b, atol), (
                f"Step {step} rewards differ: {rew_a} vs {rew_b}"
            )
        if not skip_terminal:
            assert bool(term_a) == bool(term_b), (
                f"Step {step} terminations differ: {term_a} vs {term_b}"
            )
        if not skip_truncated:
            assert bool(trunc_a) == bool(trunc_b), (
                f"Step {step} truncations differ: {trunc_a} vs {trunc_b}"
            )
        if not skip_info:
            assert info_comparator(info_a, info_b), (
                f"Step {step} infos differ: {info_a} vs {info_b}"
            )
        if not skip_render:
            assert np.array_equal(
                np.asarray(env_a.render()), np.asarray(env_b.render())
            ), f"Step {step} renders differ"

        if term_a or trunc_a:
            obs_a, info_a = env_a.reset()
            obs_b, info_b = env_b.reset()
            if not skip_obs:
                assert _values_match(obs_a, obs_b, atol), (
                    f"Post-done reset obs differ: {obs_a} vs {obs_b}"
                )


def _values_match(a: Any, b: Any, atol: float) -> bool:
    if isinstance(a, dict):
        return (
            isinstance(b, dict)
            and a.keys() == b.keys()
            and all(_values_match(a[k], b[k], atol) for k in a)
        )
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_values_match(x, y, atol) for x, y in zip(a, b))
    a = to_host(a)
    b = to_host(b)
    if atol == 0.0:
        return a.shape == b.shape and np.array_equal(a, b)
    return a.shape == b.shape and np.allclose(a, b, atol=atol, rtol=0)
