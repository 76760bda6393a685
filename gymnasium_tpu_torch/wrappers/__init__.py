"""Wrappers of the torch port (the functional, device-side ones so far)."""

from gymnasium_tpu_torch.wrappers.func import (
    EpisodeStatistics,
    FuncWrapper,
    NormalizeObservation,
    NormalizeReward,
    WrappedEnvCarry,
    episode_stats_to_infos,
    wrap_autoreset_step,
    wrap_initial,
)

__all__ = [
    "EpisodeStatistics",
    "FuncWrapper",
    "NormalizeObservation",
    "NormalizeReward",
    "WrappedEnvCarry",
    "episode_stats_to_infos",
    "wrap_autoreset_step",
    "wrap_initial",
]
