"""Wrappers of the torch port: the functional, device-side ones
(:mod:`~gymnasium_tpu_torch.wrappers.func`) and the single-env ones ``make``
applies (:mod:`~gymnasium_tpu_torch.wrappers.common`)."""

from gymnasium_tpu_torch.wrappers.common import (
    Autoreset,
    OrderEnforcing,
    PassiveEnvChecker,
    RecordEpisodeStatistics,
    TimeLimit,
)
from gymnasium_tpu_torch.wrappers.func import (
    ClipAction,
    ClipReward,
    DelayObservation,
    EpisodeStatistics,
    FrameStackObservation,
    FuncWrapper,
    NormalizeObservation,
    NormalizeReward,
    RescaleAction,
    RescaleObservation,
    StickyAction,
    TimeAwareObservation,
    TransformAction,
    TransformObservation,
    TransformReward,
    WrappedEnvCarry,
    episode_stats_to_infos,
    wrap_autoreset_step,
    wrap_initial,
)

__all__ = [
    "Autoreset",
    "OrderEnforcing",
    "PassiveEnvChecker",
    "RecordEpisodeStatistics",
    "TimeLimit",
    "ClipAction",
    "ClipReward",
    "DelayObservation",
    "EpisodeStatistics",
    "FrameStackObservation",
    "FuncWrapper",
    "NormalizeObservation",
    "NormalizeReward",
    "RescaleAction",
    "RescaleObservation",
    "StickyAction",
    "TimeAwareObservation",
    "TransformAction",
    "TransformObservation",
    "TransformReward",
    "WrappedEnvCarry",
    "episode_stats_to_infos",
    "wrap_autoreset_step",
    "wrap_initial",
]
