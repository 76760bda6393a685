"""The port's MuJoCo host env classes against the JAX package's, through
``make``: ``gymnasium_tpu_torch.make(id, device="cpu")`` against
``gymnasium_tpu.make(id)`` for the v4 and v5 ids: the locomotion robots
here, the arms and pendulums in ``tests/test_torch_mujoco_env_arms.py``,
Humanoid and HumanoidStandup in files of their own (``*_humanoid.py``,
``*_humanoid_standup.py``). JAX compiles each model's step at its first
env, so each file holds what takes under 30 s.

- the same wrappers (``PassiveEnvChecker``, ``OrderEnforcing``,
  ``TimeLimit(1000)``) and spaces (shape, dtype, bounds);
- ``reset(seed)`` equal in every bit: ``qpos``, ``qvel``, the observation
  and the info. Both sides draw the reset from ``np_random`` (the same PCG64
  stream) in float64; an observation read from float32 kinematics (Reacher's
  and Pusher's forward kinematics, Ant's contact wrenches, the
  InvertedDoublePendulum's limit torque) comes from the same formulas on the
  same float32 state. Humanoid's centre-of-mass velocities and contact
  wrenches are not bit for bit JAX's (their file says by how much);
- four steps on the same numpy actions: each block of the observation
  within ``1e-5 * max |JAX| + 1e-6``, the tolerance of the articulated
  tests, with ``max |JAX|`` over that block alone (``OBS_BLOCKS``: the
  positions and velocities, then Ant's and the Humanoids' cinert, cvel,
  qfrc_actuator and cfrc_ext each on its own, so that a block of large
  contact wrenches sets no bound for the positions); the reward and each
  info value within the same tolerance of its own value; the flags equal.
  Ant, Humanoid and HumanoidStandup are teacher-forced: the port's env
  takes JAX's state (``get_state`` into ``set_state``) before each step,
  since a free root amplifies float32 differences.

Largest deviation seen over the four steps, by block (the same for v4
and v5): HalfCheetah 3.3e-6, Hopper 1.1e-6, Swimmer 3.6e-6, Walker2d 8.5e-5
(velocities up to about 10), Reacher 9.5e-7, Pusher 4.8e-7,
InvertedPendulum 3.6e-7, InvertedDoublePendulum 9.5e-7; Ant 1.2e-6 and 0
(cfrc_ext); Humanoid 1.8e-5, 0, 1.8e-6, 0, 0 and HumanoidStandup 9.5e-6,
0, 8.9e-7, 0, 4.0e-4 (positions and velocities, cinert, cvel,
qfrc_actuator, cfrc_ext). The reward and info values: at most 2.5e-6.
"""

import numpy as np
import pytest
import torch

import gymnasium_tpu as jgym
import gymnasium_tpu_torch as gym
from tests.torch_compare import assert_same_space

ROBOTS = ("HalfCheetah", "Hopper", "Swimmer", "Walker2d", "Ant")
TEACHER_FORCED = ("Ant", "Humanoid", "HumanoidStandup")
STEPS = 4
SEED = 3
#: Where each block of the observation after the first (the positions and
#: velocities) starts, by robot; a robot not listed has one block.
OBS_BLOCKS = {
    "Ant": (27,),  # cfrc_ext[1:]
    "Humanoid": (45, 175, 253, 270),  # cinert, cvel, qfrc_actuator[6:], cfrc_ext
    "HumanoidStandup": (45, 175, 253, 270),
}


def tolerance(values) -> float:
    return 1e-5 * float(np.max(np.abs(values))) + 1e-6


def obs_blocks(env_id: str, size: int) -> list[slice]:
    starts = [0] + [b for b in OBS_BLOCKS.get(env_id.split("-")[0], ()) if b < size] + [size]
    return [slice(a, b) for a, b in zip(starts, starts[1:])]


def wrapper_names(env) -> list[str]:
    names = []
    while hasattr(env, "env"):
        names.append(type(env).__name__)
        env = env.env
    return names + [type(env).__name__]


def compare_with_jax(env_id: str, kinematic_obs=slice(0, 0)) -> dict:
    """Make ``env_id`` in both packages and hold the port's to JAX's. Entries
    ``kinematic_obs`` of the reset observation are held within the tolerance
    of their block, every other value of the reset bit for bit. Returns the largest
    deviations seen."""
    jenv, penv = jgym.make(env_id), gym.make(env_id, device="cpu")
    assert wrapper_names(penv) == wrapper_names(jenv)
    assert penv.unwrapped.device == torch.device("cpu")
    assert penv.spec.max_episode_steps == jenv.spec.max_episode_steps == 1000
    assert_same_space(penv.observation_space, jenv.observation_space)
    assert_same_space(penv.action_space, jenv.action_space)
    ju, pu = jenv.unwrapped, penv.unwrapped

    jobs, jinfo = jenv.reset(seed=SEED)
    pobs, pinfo = penv.reset(seed=SEED)
    for got, want in ((pu.qpos, ju.qpos), (pu.qvel, ju.qvel)):
        assert got.dtype == want.dtype == np.float64 and np.array_equal(got, want)
    assert pobs.dtype == jobs.dtype and pobs.shape == jobs.shape
    exact = np.ones(jobs.shape, bool)
    exact[kinematic_obs] = False
    assert np.array_equal(pobs[exact], jobs[exact])
    blocks = obs_blocks(env_id, jobs.shape[0])
    for block in blocks:
        dev = float(np.max(np.abs(pobs[block] - jobs[block])))
        assert dev <= tolerance(jobs[block]), f"reset obs[{block.start}:{block.stop}] off by {dev}"
    reset_dev = float(np.max(np.abs(pobs - jobs)))
    assert list(pinfo) == list(jinfo)
    for key in jinfo:
        assert type(pinfo[key]) is type(jinfo[key]) and np.array_equal(pinfo[key], jinfo[key]), key

    rng = np.random.default_rng(SEED)
    low, high = jenv.action_space.low, jenv.action_space.high
    worst = {"reset_obs": reset_dev, "obs": [0.0] * len(blocks), "scalars": 0.0}
    for _ in range(STEPS):
        action = rng.uniform(low, high).astype(np.float32)
        if env_id.split("-")[0] in TEACHER_FORCED:
            pu.set_state(*ju.get_state())
        jobs, jrew, jterm, jtrunc, jinfo = jenv.step(action)
        pobs, prew, pterm, ptrunc, pinfo = penv.step(action)
        assert pobs.dtype == np.float64 and isinstance(prew, float)
        for i, block in enumerate(blocks):
            dev = float(np.max(np.abs(pobs[block] - jobs[block])))
            assert dev <= tolerance(jobs[block]), f"obs[{block.start}:{block.stop}] off by {dev}"
            worst["obs"][i] = max(worst["obs"][i], dev)
        assert (pterm, ptrunc) == (jterm, jtrunc)
        assert list(pinfo) == list(jinfo)
        want = np.array([jrew] + [float(jinfo[k]) for k in jinfo])
        got = np.array([prew] + [float(pinfo[k]) for k in jinfo])
        for name, g, w in zip(["reward", *jinfo], got, want):
            assert abs(g - w) <= tolerance(w), f"{name} off by {abs(g - w)}: {g} vs {w}"
        worst["scalars"] = max(worst["scalars"], float(np.max(np.abs(got - want))))
    penv.close()
    jenv.close()
    return worst


@pytest.mark.parametrize("env_id", [f"{name}-{v}" for name in ROBOTS for v in ("v4", "v5")])
def test_make_of_a_mujoco_id_matches_jax(env_id):
    compare_with_jax(env_id)


def test_make_without_a_card_raises_and_names_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gym.make("Ant-v5")


def test_state_helpers_and_reset_determinism():
    from gymnasium_tpu_torch.envs.mujoco import utils

    env = gym.make("Hopper-v5", device="cpu")
    utils.check_mujoco_reset_state(env)
    env.reset(seed=0)
    snapshot = utils.get_state(env)
    env.step(env.action_space.sample())
    utils.set_state(env, snapshot)
    assert np.array_equal(utils.get_state(env), snapshot)
    with pytest.raises(ValueError, match="Action dimension mismatch"):
        env.unwrapped.do_simulation(np.zeros(2))


def test_pickle_rebuilds_the_env_on_its_device():
    import pickle

    env = gym.make("HalfCheetah-v5", device="cpu", ctrl_cost_weight=0.2).unwrapped
    clone = pickle.loads(pickle.dumps(env))
    assert clone.device == torch.device("cpu") and clone.ctrl_cost_weight == 0.2
    for e in (env, clone):
        e.reset(seed=1)
    action = np.full(6, 0.5, np.float32)
    assert np.array_equal(env.step(action)[0], clone.step(action)[0])
