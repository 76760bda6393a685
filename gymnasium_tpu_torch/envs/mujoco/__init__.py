"""MuJoCo-class robots as functional envs over the articulated engine."""

from gymnasium_tpu_torch.envs.mujoco.ant import AntFunctional
from gymnasium_tpu_torch.envs.mujoco.half_cheetah import HalfCheetahFunctional
from gymnasium_tpu_torch.envs.mujoco.hopper import HopperFunctional
from gymnasium_tpu_torch.envs.mujoco.humanoid import HumanoidFunctional
from gymnasium_tpu_torch.envs.mujoco.humanoid_standup import HumanoidStandupFunctional
from gymnasium_tpu_torch.envs.mujoco.inverted_double_pendulum import InvertedDoublePendulumFunctional
from gymnasium_tpu_torch.envs.mujoco.inverted_pendulum import InvertedPendulumFunctional
from gymnasium_tpu_torch.envs.mujoco.pusher import PusherFunctional
from gymnasium_tpu_torch.envs.mujoco.reacher import ReacherFunctional
from gymnasium_tpu_torch.envs.mujoco.swimmer import SwimmerFunctional
from gymnasium_tpu_torch.envs.mujoco.walker2d import Walker2dFunctional

__all__ = [
    "AntFunctional",
    "HalfCheetahFunctional",
    "HopperFunctional",
    "HumanoidFunctional",
    "HumanoidStandupFunctional",
    "InvertedDoublePendulumFunctional",
    "InvertedPendulumFunctional",
    "PusherFunctional",
    "ReacherFunctional",
    "SwimmerFunctional",
    "Walker2dFunctional",
]
