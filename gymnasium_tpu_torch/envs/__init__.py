"""Environment registrations: the JAX package's ``envs/__init__.py`` with
the port's entry points.

Every id of the JAX package is registered with the same step limit, reward
threshold and kwargs. ``torch_entry_point`` names the port's functional env,
which ``make_vec(id)`` runs as a
:class:`~gymnasium_tpu_torch.vector.TorchVectorEnv`; the ``phys2d/*`` and
``tabular/*`` entry points are the single-env adapters of
:mod:`gymnasium_tpu_torch.envs.functional_torch_env`. The other entry points
name host env classes: the MuJoCo ``*Env``, the ``box2d``, ``classic_control``,
``toy_text`` and CPD classes, and ``CartPoleVectorEnv`` and the native
tabular stepper behind ``vector_entry_point``. ``make_vec(id, n, "sync" |
"async")`` steps ``make(id)``'s envs in :class:`~gymnasium_tpu_torch.vector.SyncVectorEnv`
or :class:`~gymnasium_tpu_torch.vector.AsyncVectorEnv`.
"""

from gymnasium_tpu_torch.envs.registration import (
    EnvSpec,
    WrapperSpec,
    make,
    make_vec,
    namespace,
    pprint_registry,
    register,
    registry,
    spec,
)

# --- Classic control ------------------------------------------------------

register(
    id="CartPole-v0",
    entry_point="gymnasium_tpu_torch.envs.classic_control.cartpole:CartPoleEnv",
    vector_entry_point="gymnasium_tpu_torch.envs.classic_control.cartpole:CartPoleVectorEnv",
    torch_entry_point="gymnasium_tpu_torch.envs.phys2d.cartpole:CartPoleFunctional",
    max_episode_steps=200,
    reward_threshold=195.0,
)

register(
    id="CartPole-v1",
    entry_point="gymnasium_tpu_torch.envs.classic_control.cartpole:CartPoleEnv",
    vector_entry_point="gymnasium_tpu_torch.envs.classic_control.cartpole:CartPoleVectorEnv",
    torch_entry_point="gymnasium_tpu_torch.envs.phys2d.cartpole:CartPoleFunctional",
    max_episode_steps=500,
    reward_threshold=475.0,
)

register(
    id="MountainCar-v0",
    entry_point="gymnasium_tpu_torch.envs.classic_control.mountain_car:MountainCarEnv",
    torch_entry_point="gymnasium_tpu_torch.envs.phys2d.mountain_car:MountainCarFunctional",
    max_episode_steps=200,
    reward_threshold=-110.0,
)

register(
    id="MountainCarContinuous-v0",
    entry_point="gymnasium_tpu_torch.envs.classic_control.continuous_mountain_car:Continuous_MountainCarEnv",
    torch_entry_point="gymnasium_tpu_torch.envs.phys2d.mountain_car:ContinuousMountainCarFunctional",
    max_episode_steps=999,
    reward_threshold=90.0,
)

register(
    id="Pendulum-v1",
    entry_point="gymnasium_tpu_torch.envs.classic_control.pendulum:PendulumEnv",
    torch_entry_point="gymnasium_tpu_torch.envs.phys2d.pendulum:PendulumFunctional",
    max_episode_steps=200,
)

register(
    id="Acrobot-v1",
    entry_point="gymnasium_tpu_torch.envs.classic_control.acrobot:AcrobotEnv",
    torch_entry_point="gymnasium_tpu_torch.envs.phys2d.acrobot:AcrobotFunctional",
    max_episode_steps=500,
    reward_threshold=-100.0,
)

# --- phys2d (functional classic control) ----------------------------------

register(
    id="phys2d/CartPole-v0",
    entry_point="gymnasium_tpu_torch.envs.functional_torch_env:make_cartpole_torch_env",
    vector_entry_point="gymnasium_tpu_torch.envs.functional_torch_env:make_cartpole_torch_vector_env",
    torch_entry_point="gymnasium_tpu_torch.envs.phys2d.cartpole:CartPoleFunctional",
    max_episode_steps=200,
)

register(
    id="phys2d/CartPole-v1",
    entry_point="gymnasium_tpu_torch.envs.functional_torch_env:make_cartpole_torch_env",
    vector_entry_point="gymnasium_tpu_torch.envs.functional_torch_env:make_cartpole_torch_vector_env",
    torch_entry_point="gymnasium_tpu_torch.envs.phys2d.cartpole:CartPoleFunctional",
    max_episode_steps=500,
)

register(
    id="phys2d/Pendulum-v0",
    entry_point="gymnasium_tpu_torch.envs.functional_torch_env:make_pendulum_torch_env",
    vector_entry_point="gymnasium_tpu_torch.envs.functional_torch_env:make_pendulum_torch_vector_env",
    torch_entry_point="gymnasium_tpu_torch.envs.phys2d.pendulum:PendulumFunctional",
    max_episode_steps=200,
)

# --- Toy text -------------------------------------------------------------

register(
    id="Blackjack-v1",
    entry_point="gymnasium_tpu_torch.envs.toy_text.blackjack:BlackjackEnv",
    kwargs={"sab": True, "natural": False},
)

register(
    id="FrozenLake-v1",
    entry_point="gymnasium_tpu_torch.envs.toy_text.frozen_lake:FrozenLakeEnv",
    vector_entry_point="gymnasium_tpu_torch.vector.native_tabular:make_frozen_lake_vector",
    torch_entry_point="gymnasium_tpu_torch.envs.tabular.frozen_lake:FrozenLakeFunctional",
    kwargs={"map_name": "4x4"},
    max_episode_steps=100,
    reward_threshold=0.70,
)

register(
    id="FrozenLake8x8-v1",
    entry_point="gymnasium_tpu_torch.envs.toy_text.frozen_lake:FrozenLakeEnv",
    vector_entry_point="gymnasium_tpu_torch.vector.native_tabular:make_frozen_lake_vector",
    torch_entry_point="gymnasium_tpu_torch.envs.tabular.frozen_lake:FrozenLake8x8Functional",
    kwargs={"map_name": "8x8"},
    max_episode_steps=200,
    reward_threshold=0.85,
)

register(
    id="CliffWalking-v1",
    entry_point="gymnasium_tpu_torch.envs.toy_text.cliffwalking:CliffWalkingEnv",
    vector_entry_point="gymnasium_tpu_torch.vector.native_tabular:make_cliffwalking_vector",
    torch_entry_point="gymnasium_tpu_torch.envs.tabular.cliffwalking:CliffWalkingFunctional",
    kwargs={"is_slippery": False},
)

register(
    id="CliffWalkingSlippery-v1",
    entry_point="gymnasium_tpu_torch.envs.toy_text.cliffwalking:CliffWalkingEnv",
    torch_entry_point="gymnasium_tpu_torch.envs.tabular.cliffwalking:CliffWalkingFunctional",
    kwargs={"is_slippery": True},
)

register(
    id="Taxi-v3",
    entry_point="gymnasium_tpu_torch.envs.toy_text.taxi:TaxiEnv",
    vector_entry_point="gymnasium_tpu_torch.vector.native_tabular:make_taxi_vector",
    torch_entry_point="gymnasium_tpu_torch.envs.tabular.taxi:TaxiFunctional",
    max_episode_steps=200,
    reward_threshold=8,
)

# --- tabular (functional toy text) ----------------------------------------

register(
    id="tabular/Blackjack-v0",
    entry_point="gymnasium_tpu_torch.envs.functional_torch_env:make_blackjack_torch_env",
    torch_entry_point="gymnasium_tpu_torch.envs.tabular.blackjack:BlackjackFunctional",
    disable_env_checker=True,
)

register(
    id="tabular/CliffWalking-v0",
    entry_point="gymnasium_tpu_torch.envs.functional_torch_env:make_cliffwalking_torch_env",
    torch_entry_point="gymnasium_tpu_torch.envs.tabular.cliffwalking:CliffWalkingFunctional",
    disable_env_checker=True,
)

# --- Box2D-class physics --------------------------------------------------

register(
    id="LunarLander-v3",
    entry_point="gymnasium_tpu_torch.envs.box2d.lunar_lander:LunarLander",
    torch_entry_point="gymnasium_tpu_torch.envs.box2d.lunar_lander:LunarLanderFunctional",
    max_episode_steps=1000,
    reward_threshold=200,
)

register(
    id="LunarLanderContinuous-v3",
    entry_point="gymnasium_tpu_torch.envs.box2d.lunar_lander:LunarLander",
    torch_entry_point="gymnasium_tpu_torch.envs.box2d.lunar_lander:LunarLanderContinuousFunctional",
    kwargs={"continuous": True},
    max_episode_steps=1000,
    reward_threshold=200,
)

register(
    id="BipedalWalker-v3",
    entry_point="gymnasium_tpu_torch.envs.box2d.bipedal_walker:BipedalWalker",
    torch_entry_point="gymnasium_tpu_torch.envs.box2d.bipedal_walker:BipedalWalkerFunctional",
    max_episode_steps=1600,
    reward_threshold=300,
)

register(
    id="BipedalWalkerHardcore-v3",
    entry_point="gymnasium_tpu_torch.envs.box2d.bipedal_walker:BipedalWalker",
    torch_entry_point="gymnasium_tpu_torch.envs.box2d.bipedal_walker:BipedalWalkerFunctional",
    kwargs={"hardcore": True},
    max_episode_steps=2000,
    reward_threshold=300,
)

register(
    id="CarRacing-v3",
    entry_point="gymnasium_tpu_torch.envs.box2d.car_racing:CarRacing",
    torch_entry_point="gymnasium_tpu_torch.envs.box2d.car_racing_functional:CarRacingFunctional",
    max_episode_steps=1000,
    reward_threshold=900,
)

# --- Blockchain CPD (fork capability parity) ------------------------------

register(
    id="BlockchainCPD-v0",
    entry_point="gymnasium_tpu_torch.envs.blockchain.cpd_env:BlockchainCPDEnv",
    torch_entry_point="gymnasium_tpu_torch.envs.blockchain.cpd_functional:BlockchainCPDFunctional",
    max_episode_steps=200,
)

register(
    id="BlockchainCPD-v0-TFT",
    entry_point="gymnasium_tpu_torch.envs.blockchain.cpd_env:BlockchainCPDEnv",
    torch_entry_point="gymnasium_tpu_torch.envs.blockchain.cpd_functional:BlockchainCPDFunctional",
    kwargs={"opponent_policy": "tit_for_tat"},
    max_episode_steps=200,
)

register(
    id="BlockchainCPD-v0-Random",
    entry_point="gymnasium_tpu_torch.envs.blockchain.cpd_env:BlockchainCPDEnv",
    torch_entry_point="gymnasium_tpu_torch.envs.blockchain.cpd_functional:BlockchainCPDFunctional",
    kwargs={"opponent_policy": "random"},
    max_episode_steps=200,
)


# --- MuJoCo (autodiff articulated engine) ---------------------------------


def _raise_mujoco_py_error(*args, **kwargs):
    raise ImportError(
        "The mujoco v2 and v3 based environments have been moved to the gymnasium-robotics project (https://github.com/Farama-Foundation/gymnasium-robotics)."
    )


def _register_mujoco(name: str, reward_threshold: float | None = None, **kwargs):
    # v2/v3 ids raise the same redirection error as the reference
    register(id=f"{name}-v2", entry_point=_raise_mujoco_py_error)
    if name not in (
        "Reacher",
        "Pusher",
        "InvertedPendulum",
        "InvertedDoublePendulum",
        "HumanoidStandup",
    ):
        register(id=f"{name}-v3", entry_point=_raise_mujoco_py_error)
    for version in ("v4", "v5"):
        register(
            id=f"{name}-{version}",
            entry_point=f"gymnasium_tpu_torch.envs.mujoco.{_camel_to_snake(name)}:{name}Env",
            torch_entry_point=f"gymnasium_tpu_torch.envs.mujoco.{_camel_to_snake(name)}:{name}Functional",
            max_episode_steps=1000,
            reward_threshold=reward_threshold,
            kwargs=kwargs,
        )


def _camel_to_snake(name: str) -> str:
    import re

    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


_register_mujoco("Reacher", reward_threshold=-3.75)
_register_mujoco("Pusher", reward_threshold=0.0)
_register_mujoco("InvertedPendulum", reward_threshold=950.0)
_register_mujoco("InvertedDoublePendulum", reward_threshold=9100.0)
_register_mujoco("HalfCheetah", reward_threshold=4800.0)
_register_mujoco("Hopper", reward_threshold=3800.0)
_register_mujoco("Swimmer", reward_threshold=360.0)
_register_mujoco("Walker2d")
_register_mujoco("Ant", reward_threshold=6000.0)
_register_mujoco("Humanoid")
_register_mujoco("HumanoidStandup")


# --- Shimmy compatibility stubs (reference envs/__init__.py:415-423) ------


def _raise_shimmy_error(*args, **kwargs):
    raise ImportError(
        'To use the gym compatibility environments, run `pip install "shimmy[gym-v21]"` or `pip install "shimmy[gym-v26]"`'
    )


# When installed, shimmy re-registers these with real entry points.
register(id="GymV21Environment-v0", entry_point=_raise_shimmy_error)
register(id="GymV26Environment-v0", entry_point=_raise_shimmy_error)
