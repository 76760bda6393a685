"""MuJoCo-class robots over the articulated engine: the host env classes
that ``make`` builds and the functional envs that ``make_vec`` batches."""

from gymnasium_tpu_torch.envs.mujoco.ant import AntEnv, AntFunctional
from gymnasium_tpu_torch.envs.mujoco.half_cheetah import HalfCheetahEnv, HalfCheetahFunctional
from gymnasium_tpu_torch.envs.mujoco.hopper import HopperEnv, HopperFunctional
from gymnasium_tpu_torch.envs.mujoco.humanoid import HumanoidEnv, HumanoidFunctional
from gymnasium_tpu_torch.envs.mujoco.humanoid_standup import HumanoidStandupEnv, HumanoidStandupFunctional
from gymnasium_tpu_torch.envs.mujoco.inverted_double_pendulum import (
    InvertedDoublePendulumEnv,
    InvertedDoublePendulumFunctional,
)
from gymnasium_tpu_torch.envs.mujoco.inverted_pendulum import InvertedPendulumEnv, InvertedPendulumFunctional
from gymnasium_tpu_torch.envs.mujoco.mujoco_env import MujocoEnv, load_model
from gymnasium_tpu_torch.envs.mujoco.pusher import PusherEnv, PusherFunctional
from gymnasium_tpu_torch.envs.mujoco.reacher import ReacherEnv, ReacherFunctional
from gymnasium_tpu_torch.envs.mujoco.swimmer import SwimmerEnv, SwimmerFunctional
from gymnasium_tpu_torch.envs.mujoco.walker2d import Walker2dEnv, Walker2dFunctional

__all__ = [
    "MujocoEnv",
    "load_model",
    "AntEnv",
    "AntFunctional",
    "HalfCheetahEnv",
    "HalfCheetahFunctional",
    "HopperEnv",
    "HopperFunctional",
    "HumanoidEnv",
    "HumanoidFunctional",
    "HumanoidStandupEnv",
    "HumanoidStandupFunctional",
    "InvertedDoublePendulumEnv",
    "InvertedDoublePendulumFunctional",
    "InvertedPendulumEnv",
    "InvertedPendulumFunctional",
    "PusherEnv",
    "PusherFunctional",
    "ReacherEnv",
    "ReacherFunctional",
    "SwimmerEnv",
    "SwimmerFunctional",
    "Walker2dEnv",
    "Walker2dFunctional",
]
