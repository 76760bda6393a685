#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``gymnasium_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds every kernel of the port with ``nvcc``, all at once: the
hand-written ``gymnasium_tpu_torch/csrc/*.cu``, the articulated substep
generated for each of the ten MuJoCo-class robots at its own ``frame_skip``
(HalfCheetah, Ant, Hopper, Walker2d, InvertedPendulum,
InvertedDoublePendulum, Reacher, Pusher, Humanoid, HumanoidStandup), for
Swimmer at ``frame_skip=1`` and for the chain of :data:`MJCF_CHAIN_XML`,
which it writes to a temporary file and compiles through ``load_model``,
the planar solver step generated for LunarLander (two substeps) and the one
generated for BipedalWalker's world (four substeps: per-env motors, the
heightfield read by index, the bounded sub-pull), and BipedalWalker's
terrain kernel (``csrc/walker_terrain.cu``). Then it drives each path of the
port once, with every kernel launch count set to 0 just before the path and
read just after:

- the CartPole-v1 headline of ``bench.py``: chained ``cartpole_rollout_fused``
  blocks of 4096 envs x 2048 steps with bf16 and f32 observations, after one
  untimed block that warms the card;
- ``TorchVectorEnv`` over CartPole at 4096 envs, and ``entry()`` at 256 envs;
- ``TorchVectorEnv(HalfCheetahFunctional(), 4096, max_episode_steps=1000)``
  and the same over ``AntFunctional()``: reset, four steps, a masked reset
  of every other lane, ``rollout(100)``. Each env step is one launch of the
  robot's generated articulated kernel. After the kernel timings, five Ant
  env steps run under ``torch.profiler`` (kernels a step, the device's busy
  share);
- ``TorchVectorEnv`` over each other robot at 4096 envs: reset, then
  ``rollout(20)``, one articulated launch an env step;
- ``TorchVectorEnv(LunarLanderFunctional(), 4096, max_episode_steps=1000)``:
  reset, four steps, a masked reset of every other lane, ``rollout(200)``.
  Each env step launches the generated planar kernel twice: the transition
  and the settle tick of the reset drawn for every lane;
- ``TorchVectorEnv(BipedalWalkerFunctional(), 4096, max_episode_steps=1600)``
  and the hardcore variant (2000): reset, four steps, a masked reset of
  every other lane, ``rollout(200)``. Each env step launches the walker's
  planar kernel twice (the transition and the settle tick of the reset
  drawn for every lane) and the terrain kernel once. After the kernel
  timings, five env steps of each under ``torch.profiler``, 8 steps at 4096
  envs on the card and on the CPU from the CPU's carry with the same draws
  (``compare_bipedal_with_cpu``), and the new functional wrappers on the
  card against the CPU (``compare_wrappers_with_cpu``: the walker through
  ClipAction, TimeAwareObservation and FrameStackObservation(4), MountainCar
  through StickyAction, DelayObservation, TransformObservation,
  TransformReward and ClipReward, Pendulum through RescaleAction,
  TransformAction, RescaleObservation and TimeAwareObservation);
- ``TorchVectorEnv`` over each cheap functional at 4096 envs, with the step
  limit its id registers (``CLASSIC_ENVS``): FrozenLake8x8, Taxi, Pendulum
  and MountainCarContinuous (``bench.py``'s rows, ``rollout(512)``), then
  Acrobot, MountainCar, CliffWalking, Blackjack and the CPD game with random
  opponents (``rollout(100)``): reset, four steps, a masked reset of every
  other lane, the rollout; outputs finite and inside the observation space,
  episodes ending where each env says. No kernel of the port runs there.
  After the kernel timings, five env steps of each bench row run under
  ``torch.profiler`` (kernels a step, the device's busy share, host syncs),
  and every one of the nine takes 8 steps at 4096 envs on the card and on
  the CPU with the same draws and actions (``compare_classic_with_cpu``);
- ``TorchVectorEnv(CarRacingFunctional(), 1024, max_episode_steps=1000)``
  (``bench.py``'s row): reset, four steps, a masked reset of every other
  lane, ``rollout(100)``; every frame uint8 and in the palette, episodes
  ending where the env says; then the discrete mode's ``rollout(20)``. No
  kernel of the port runs there. After the kernel timings, five env steps
  under ``torch.profiler`` (with the observation's device time, a
  ``record_function`` range) and 8 steps at 64 envs on the card and on the
  CPU with the same draws and actions (``compare_car_racing_with_cpu``);
- ``TorchVectorEnv(SwimmerFunctional(), 4096)``: reset, ``rollout(100)``,
  four launches of Swimmer's ``frame_skip=1`` kernel an env step with the
  fluid drag between them; then five profiled env steps and 8 steps against
  the CPU (``compare_swimmer_with_cpu``);
- a ``MujocoFuncEnv`` over the compiled XML chain at 4096 envs:
  ``rollout(20)``, one launch of its generated kernel an env step;
- the registry's paths: ``gymnasium_tpu_torch.make_vec(id, num_envs=4096)``
  with no mode for CartPole-v1, HalfCheetah-v5, LunarLander-v3 and
  BipedalWalkerHardcore-v3 (the ``torch`` mode on the card, the spec's step
  limit, reset, four steps, ``rollout(100)``, ``make_vec(envs.spec)``
  rebuilding the env; the first four steps then equal a ``TorchVectorEnv``
  built by hand in every bit); ``gymnasium_tpu_torch.make("phys2d/CartPole-v1")``
  on the card for one episode through ``PassiveEnvChecker``,
  ``OrderEnforcing`` and ``TimeLimit`` with every warning an error, and
  ``contains`` of CUDA tensors; ``FunctionalTorchEnv`` (one env, a batch of
  one) over HalfCheetah, Ant and LunarLander for 20 steps, one kernel launch
  a step, then the same steps on the CPU from the card's first state with
  the card's actions and draws; ``Tuple``, ``Dict`` and ``MultiBinary``
  samples drawn on the card at 4096. The registry paths' kernels (the
  articulated builds of HalfCheetah and Ant, the lander's and the walker's
  planar builds) are held against their twins at N=1 and N=33 too;
- the host env classes: ``gymnasium_tpu_torch.make(id)`` with no device
  (the card) for the eleven MuJoCo-class v5 ids (:data:`HOST_IDS`):
  ``reset(seed=0)`` (no launch) and 20 steps of numpy actions, one launch
  of the robot's build an env step (Swimmer: four of its ``frame_skip=1``
  build), host-clock ms a step. After the kernel timings, the first five
  steps again on the same env made with ``device="cpu"`` from the card's
  state before each step, five profiled steps of HalfCheetah and Ant, and
  one ``rgb_array`` frame of each; every robot's build is held against its
  twin at N=1, with its CUDA-event time a call there;
- the classic-control, toy-text and CPD host classes: ``make(id)`` of the
  15 ids of :data:`HOST_CLASS_IDS`, ``reset(seed=0)``, 200 sampled steps
  and one ``rgb_array`` frame or ``ansi`` text each, and 600 steps of the
  numpy ``CartPoleVectorEnv`` at 8 envs, timed and then again under
  ``torch.profiler``, which must see no kernel and no copy on the card;
- the utilities over the articulated kernel: ``benchmark_step`` of
  ``make("CartPole-v1")`` (host) and ``make("HalfCheetah-v5")`` (one launch
  a step, none at a reset), ``benchmark_compiled_rollout`` of
  ``make_vec("HalfCheetah-v5", 4096)`` (500 launches) beside the registry
  phase's rate, ``trace`` around 5 HalfCheetah steps at 4096 envs (the
  Chrome trace it writes names the kernel), the HalfCheetah PPO state saved
  after a train step and restored into a fresh ``init_ppo(seed=1)``, whose
  next step equals the uninterrupted one in every bit (after two steps from
  the restored state are shown to agree), and ``torch_generator(0,
  "cuda")`` against ``manual_seed(0)``;
- the host vector envs over the host classes: ``make_vec("HalfCheetah-v5",
  8, vectorization_mode="sync")`` for 200 steps and ``make_vec("LunarLander-v3",
  8, vectorization_mode="sync")`` for 100, each sub-env on the card and one
  launch of its build a step (the lander's reset one too), numpy batches,
  then the same steps with ``device="cpu"`` from each sub-env's card state
  and five steps under ``torch.profiler``; HalfCheetah with
  ``vectorization_mode="async"`` in 8 spawned workers over shared memory,
  equal to the sync env in every bit, each worker reporting ``cuda`` and its
  own 200 launches through ``call``; the same env with the default context
  (fork), which must raise in the parent within 60 s; the native tabular
  stepper (``make_vec("FrozenLake-v1" | "Taxi-v3", 4096,
  vectorization_mode="vector_entry_point")``, built with ``g++``, 512 steps
  equal to its numpy path's, nothing on the card); and RescaleAction,
  ClipAction, NormalizeObservation and FrameStackObservation(4) over
  ``make("HalfCheetah-v5")`` on the card against the CPU for 100 steps;
- the vector wrappers a PPO user runs over the articulated kernel:
  RecordEpisodeStatistics, ClipAction, NormalizeObservation, NormalizeReward
  and DictInfoToList over ``make_vec("HalfCheetah-v5", 4096)`` with a step
  limit of 50, a reset and 60 steps of actions in [-2, 2] (one launch a
  step; every action reaching the env in [-1, 1]; numpy float32
  observations; one 50-step episode for each env), the chain's first 8
  steps on the card against the CPU from the same reset draws and actions,
  20 timed steps under each prefix of the chain; then RecordEpisodeStatistics and
  DictInfoToList over ``make_vec("CartPole-v1", 4096)`` for 100 steps, the
  episode entries exactly the envs that ended;
- the rendering: ``make("phys2d/CartPole-v1", render_mode="rgb_array")`` on
  the card (the render hook's frames against the CPU hook's), make's
  RenderCollection fallback for ``make("HalfCheetah-v5",
  render_mode="rgb_array_list")`` over 10 steps, ObstructView over
  AddWhiteNoise, and RecordVideo of one 20-step HalfCheetah episode (an
  ``.mp4`` where moviepy or OpenCV imports, else an ``.npz`` frame dump);
- the checkers and conversions (``run_checkers_and_conversion``):
  ``check_env(make(id).unwrapped, skip_render_check=True)`` on the card for
  HalfCheetah (articulated), LunarLander (planar) and the functional
  ``phys2d/CartPole-v1`` (through ``ArrayConversion(env, "torch",
  "numpy")``); ``check_environments_match`` of HalfCheetah and LunarLander
  on the card against ``device="cpu"`` over 50 steps; ``NumpyToTorch`` and
  its vector form onto CUDA; ``ArrayConversion(make_vec("HalfCheetah-v5",
  4096), "torch", "numpy")`` timed against the bare env; the step-API round
  trip over ``make_vec("HalfCheetah-v5", 64)``; ``play`` of 30 LunarLander
  frames under ``SDL_VIDEODRIVER=dummy`` (or its ``DependencyNotInstalled``
  without pygame); the four ``examples/torch_*.py``, each a process of its
  own at a small size;
- the sharded paths (``gymnasium_tpu_torch/parallel/``) in a spawned process
  that is one NCCL rank on the card (``run_parallel``): HalfCheetah at 4096
  x 100 (limit 50) and LunarLander at 4096 x 20 through
  ``TorchVectorEnv(sharding=NamedSharding(make_mesh(), ("dp",)))``, each
  equal in every bit to the unsharded env, with ``gather_trajectory``; a
  HalfCheetah PPO step at 4096 x 64 over ``shard_ppo_state`` against the
  unsharded step; ``scaling_report``; ``dryrun_multichip(1)``; then
  ``examples/torch_sharded_rollout.py --device cuda``. With two or more
  cards, one rank a card (up to 4) runs the two trajectories again;
- the PPO trainer at ``tools/bench_ppo.py``'s widths: CartPole-v1 (4096 envs,
  64 steps a rollout, hidden (128, 128)) and HalfCheetah-v5 (4096 x 64,
  hidden (256, 256), with NormalizeObservation, NormalizeReward and
  EpisodeStatistics), bf16 hidden layers: one untimed train step, three
  timed ones and one under ``torch.profiler`` for the phase split (rollout,
  value pass with GAE, update). Each HalfCheetah env step of a rollout is
  one launch of the articulated kernel, 64 a train step. A float32
  HalfCheetah train step at 256 envs x 16 steps with injected draws is then
  held against the same step on the CPU.

It holds each kernel against its plain PyTorch version on the card and times
both; the articulated and planar kernels must equal their twins in every
value (each robot's articulated kernel at N=4096 at its own
``frame_skip``, Swimmer's at 1 and the XML chain's; the walker's planar
build and the terrain kernel also at a ragged N, with lanes on both sides of
the sub-pull clamp). Each ``articulated_step[...]`` entry also gives the
kernel's warp layout (``parts`` warps a group of 32 envs, ``env_groups``
groups a block, ``phases``, values ``exchanged`` and their loads,
``recomputed_ops``, ``shared_bytes_per_block``). A kernel's ``ms`` is its
own time on the card, ``torch.profiler``'s kernel durations; ``events_ms``
is CUDA events around back-to-back calls, which read the host's launch
pace where a call's host work outlasts its kernel. It counts each library's SASS instructions with ``cuobjdump``. It
prints the card's name and power limit, one ``{"bipedal": {...},
"wrappers": {...}}`` line, one ``{"carracing": {...}, "swimmer":
{...}, "mjcf": {...}}`` line, one ``{"classic": {...}}`` line,
one ``{"ppo": {...}}`` line, one ``{"host_envs": {...}}`` line, one
``{"host_classes": {...}, "utils": {...}}`` line, one
``{"host_vector": {...}}`` line, one ``{"vector_wrappers": {...},
"rendering": {...}}`` line, one ``{"checkers_and_conversion": {...}}``
line, one ``{"parallel": {...}}`` line, one ``{"registry": {...}}`` line, one
``{"kernels": [...]}`` line, and last the line ``{"ok": true, "device":
{...}}``. Any failed check
raises, so the exit code is 0 only when every phase passed. Without a CUDA
device it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import concurrent.futures
import copy
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

NUM_ENVS = 4096
STEPS_PER_BLOCK = 2048
HEADLINE_BLOCKS = 4
TIME_LIMIT = 500
OBS_ATOL = 2e-5  # the TPU kernel's own test tolerance (tests/ops/test_pallas_rollout.py)
THRESHOLD_BAND = 1e-5  # flags may differ from the twin's only this close to a threshold
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# The kernels build with -fmad=false, so every float add and multiply issues
# on its own: one float32 operation a lane a clock, 132 SMs x 128 FP32 lanes
# x 1.98 GHz boost = 3.35e13 a second. (The data sheet's 67 TFLOP/s counts
# a fused multiply-add as two.) Integer operations issue on the 64 INT32
# lanes of each SM (Hopper white paper), at half that rate.
FP32_OPS_PER_S = 132 * 128 * 1.98e9
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# CartPole, per env-step: 32 float operations of the ODE and thresholds and
# 2 of the reset select (sinf and cosf count one each), and 80 integer
# operations of Philox4x32-10 (10 rounds of two 32x32 products, each giving
# its high and low word, and four xors). The key schedule depends on the seed
# alone, so it is not counted.
CARTPOLE_FLOAT_OPS = 32 + 2
CARTPOLE_INT_OPS = 80

# Each articulated robot's functional env (gymnasium_tpu_torch.envs.mujoco),
# by the name of its model; its kernel is built at the env's frame_skip.
ART_ENVS = {
    "half_cheetah": "HalfCheetahFunctional",
    "ant": "AntFunctional",
    "hopper": "HopperFunctional",
    "walker2d_v5": "Walker2dFunctional",
    "inverted_pendulum": "InvertedPendulumFunctional",
    "inverted_double_pendulum": "InvertedDoublePendulumFunctional",
    "reacher": "ReacherFunctional",
    "pusher_v5": "PusherFunctional",
    "humanoid": "HumanoidFunctional",
    "humanoidstandup": "HumanoidStandupFunctional",
}
# HalfCheetah and Ant (bench.py's FAMILY_CASES rows) take the full path:
# reset, ART_WARM_STEPS steps, a masked reset, rollout(ART_ROLLOUT). The
# other robots reset and take rollout(ROBOT_ROLLOUT).
ART_FULL_PATHS = ("half_cheetah", "ant")
ART_TIME_LIMIT = 1000
ART_WARM_STEPS = 4
ART_ROLLOUT = 100
ROBOT_ROLLOUT = 20
PROFILED_ENV_STEPS = 5
# Kernel and twin run the same generated program and round alike
# (-fmad=false, precise math), in either layout of the kernel, so they are
# held to equal values (max |error| 0): inside the same-program atol of
# tests/test_torch_articulated.py (1e-5 in q, 1e-4 in qd) and the JAX kernel
# test's tolerances (tests/ops/test_pallas_articulated.py:110-117: q rtol
# 2e-4 / atol 2e-3, qd rtol 2e-3 / atol 0.15), which stay for comparisons
# with make_dynamics.

PLANAR_GRAVITY = -10.0
PLANAR_TIME_LIMIT = 1000
PLANAR_WARM_STEPS = 4
PLANAR_ROLLOUT = 200
# Kernel and twin run the same generated program and round alike (precise
# sinf/cosf and sincosf, IEEE divides, -fmad=false), so they are held to equal
# values (max |error| 0), flags included: inside the same-program atol of
# tests/test_torch_planar.py (1e-5, the twin against the JAX row program) and
# the JAX kernel test's tolerances (tests/ops/test_pallas_planar.py:107-110:
# bodies 2e-4, impulses 1e-4).
# The lander's env call reads 68 floats (18 body, 9 external, 11 terrain, 10
# joint and 20 contact impulses) and writes 48 floats and 10 one-byte flags
# (planar_bytes_per_env).

# BipedalWalker-v3 and BipedalWalkerHardcore-v3 (step limits 1600 and 2000):
# reset, BIPEDAL_WARM_STEPS steps, a masked reset of every other lane,
# rollout(BIPEDAL_ROLLOUT); two launches of the walker's planar build (the
# transition and the reset's settle tick) and one of the terrain kernel an
# env step. The walker's build and the terrain kernel are held to their twins
# in every bit at N=4096 and at a ragged N. The card against the CPU: 8 steps
# at 4096 envs, step limit 3, each taken on both from the CPU's carry with the
# same draws and actions; values within a relative BIPEDAL_CHECK_TOL but on
# lanes (at most a hundredth) where the two took a different side of a
# contact or lidar threshold: the card's sincosf and the CPU's sin and cos
# differ in the last bit, and so do torch's divisions by a python float
# (a reciprocal product on the card).
BIPEDAL_WARM_STEPS = 4
BIPEDAL_ROLLOUT = 200
BIPEDAL_RAGGED = 333
BIPEDAL_CHECK_STEPS, BIPEDAL_CHECK_LIMIT = 8, 3
BIPEDAL_CHECK_TOL = 1e-4
BIPEDAL_BRANCH_SHARE = 0.01
# the new functional wrappers, card against CPU in the same way, at 256 envs
WRAPPER_CHECK_ENVS, WRAPPER_CHECK_STEPS = 256, 12
# The terrain kernel, per env: 1,558 float operations of the walk (6 a point,
# 8 past the start pad: the division and its add), and in hardcore mode 19
# more a window (the stump and pit heights, six selects and adds) for 11
# windows; it reads 200 floats (22 more obstacle draws in hardcore mode) and
# writes 200.
TERRAIN_WALK_OPS = 21 * 6 + 179 * 8
TERRAIN_OVERLAY_OPS = 11 * 19

PPO_ROLLOUT = 64  # tools/bench_ppo.py:70-84
PPO_TIMED_STEPS = 3
PPO_PHASES = ("ppo.rollout", "ppo.advantages", "ppo.update")
PPO_CHECK_ENVS, PPO_CHECK_STEPS = 256, 16
# The device step against the CPU step: the tolerance of the CPU parity test
# with JAX at HalfCheetah (tests/test_torch_ppo_halfcheetah.py), whose
# transition is likewise the kernel on one side and the twin on the other.
PPO_CHECK_TOL = 1e-5

# The cheap functionals: bench.py's four FAMILY_CASES rows by their names
# there, then the others. Each entry: (the id the port's registry holds it
# under, rollout steps). The functional env, its options and its step limit
# come from the id's spec (:func:`registered_func`, :func:`step_limit`):
# CliffWalking-v1 and tabular/Blackjack-v0 register no limit; Blackjack and
# CPD end by themselves. CPD plays random opponents, the policy whose step
# draws.
CLASSIC_ENVS = {
    "frozenlake8x8": ("FrozenLake8x8-v1", 512),
    "taxi_v3": ("Taxi-v3", 512),
    "pendulum_v1": ("Pendulum-v1", 512),
    "mountaincar_continuous_v0": ("MountainCarContinuous-v0", 512),
    "acrobot_v1": ("Acrobot-v1", 100),
    "mountaincar_v0": ("MountainCar-v0", 100),
    "cliffwalking_v1": ("CliffWalking-v1", 100),
    "blackjack_v1": ("tabular/Blackjack-v0", 100),
    "cpd_random": ("BlockchainCPD-v0-Random", 100),
}
CLASSIC_BENCH_ROWS = ("frozenlake8x8", "taxi_v3", "pendulum_v1", "mountaincar_continuous_v0")
CLASSIC_WARM_STEPS = 4
# A blackjack hand lasts at most 20 steps: 19 hits from two aces to 21, then a stick or a bust.
BLACKJACK_MAX_STEPS = 20
# The card against the CPU: 8 steps at 4096 envs with the same draws and
# actions, a step limit of 3 so that lanes autoreset. Tabular envs and
# Blackjack compute in integers and gathers: equal. The others within a
# relative tolerance (|card - cpu| <= tol * (1 + |cpu|)): sin, cos, pow and
# the float32 RK4 differ in the last bits between the card's and the CPU's
# libraries, and Acrobot's RK4 grows them most.
CLASSIC_CHECK_STEPS, CLASSIC_CHECK_LIMIT = 8, 3
CLASSIC_CHECK_TOL = {"pendulum_v1": 1e-5, "mountaincar_continuous_v0": 1e-5, "mountaincar_v0": 1e-5,
                     "cpd_random": 1e-5, "acrobot_v1": 1e-4}
ACROBOT_BAND = 1e-5  # Acrobot's flag may differ from the height test of its obs only this close to 1

# CarRacing-v3 (bench.py:74: 1024 envs x 100 steps): the continuous mode takes
# reset, CAR_WARM_STEPS steps, a masked reset and rollout(CAR_ROLLOUT), the
# discrete mode rollout(CAR_DISCRETE_ROLLOUT). The card against the CPU: 8
# steps at 64 envs, step limit 3. The hull, wheels and rewards pass through
# sin, cos, sqrt and divides whose last bits differ between the card's and
# the CPU's libraries: a relative 1e-4.
CAR_ENVS = 1024
CAR_TIME_LIMIT = 1000
CAR_WARM_STEPS = 4
CAR_ROLLOUT = 100
CAR_DISCRETE_ROLLOUT = 20
CAR_CHECK_ENVS, CAR_CHECK_STEPS, CAR_CHECK_LIMIT = 64, 8, 3
CAR_CHECK_TOL = 1e-4
# Swimmer-v5 at 4096 envs, four articulated launches (frame_skip 1) an env
# step. The card against the CPU: the kernel against the twin, with the
# fluid drag, mass matrix and solve in eager torch on both: a relative 1e-4.
SWIMMER_ROLLOUT = 100
SWIMMER_CHECK_STEPS, SWIMMER_CHECK_LIMIT = 8, 3
SWIMMER_CHECK_TOL = 1e-4
MJCF_FRAME_SKIP = 2
MJCF_ROLLOUT = 20
# The registry phase: gymnasium_tpu_torch.make_vec(id, num_envs=4096) with no
# mode for each id, reset, REGISTRY_WARM_STEPS steps and
# rollout(REGISTRY_ROLLOUT). REGISTRY_LIMITS are the step limits the JAX
# package registers, held against the port's specs. Then FunctionalTorchEnv
# (a batch of one) over SINGLE_IDS for SINGLE_STEPS steps against the CPU,
# within the tolerance of the card-against-CPU phases of its kernel
# (SWIMMER_CHECK_TOL articulated, BIPEDAL_CHECK_TOL planar), and every kernel
# of these paths against its twin at N=1 and N=RAGGED_ENVS.
REGISTRY_LIMITS = {"CartPole-v1": 500, "HalfCheetah-v5": 1000, "LunarLander-v3": 1000, "BipedalWalkerHardcore-v3": 2000}
REGISTRY_IDS = tuple(REGISTRY_LIMITS)
REGISTRY_WARM_STEPS = 4
REGISTRY_ROLLOUT = 100
SINGLE_IDS = ("HalfCheetah-v5", "Ant-v5", "LunarLander-v3")
SINGLE_STEPS = 20
RAGGED_ENVS = 33
# The host env phase: gymnasium_tpu_torch.make(id) with no device (the card)
# for each MuJoCo-class v5 id, by the key of its articulated build and its
# launches an env step (Swimmer: four of its frame_skip=1 build, the drag
# between them). reset(seed=0), then HOST_STEPS steps of numpy actions; the
# first HOST_CHECK_STEPS against the same env made with device="cpu", set to
# the card's state before each step, within HOST_CHECK_TOL * (1 + |cpu|), the
# tolerance of the single-env phase. HOST_PROFILED take PROFILED_ENV_STEPS
# more steps under torch.profiler and render one rgb_array frame each.
HOST_IDS = {
    "HalfCheetah-v5": ("half_cheetah", 1),
    "Ant-v5": ("ant", 1),
    "Hopper-v5": ("hopper", 1),
    "Walker2d-v5": ("walker2d_v5", 1),
    "InvertedPendulum-v5": ("inverted_pendulum", 1),
    "InvertedDoublePendulum-v5": ("inverted_double_pendulum", 1),
    "Reacher-v5": ("reacher", 1),
    "Pusher-v5": ("pusher_v5", 1),
    "Humanoid-v5": ("humanoid", 1),
    "HumanoidStandup-v5": ("humanoidstandup", 1),
    "Swimmer-v5": ("swimmer_fs1", 4),
}
HOST_STEPS = 20
HOST_CHECK_STEPS = 5
HOST_CHECK_TOL = 1e-4
HOST_PROFILED = ("HalfCheetah-v5", "Ant-v5")
TRACE_OPENING_S = 0.05  # untimed host-env steps that open each profiled trace

# The Box2D host env phase: gymnasium_tpu_torch.make(id, **kwargs) with no
# device (the card) for the planar host classes, by path label. reset(seed=0)
# launches the path's planar build once (the walker: the terrain kernel
# once, then its build once), and each of BOX2D_STEPS steps one launch of the
# build. The first BOX2D_CHECK_STEPS steps run again on the CPU from the
# card's state and generator, each output within (atol, rtol) of the CPU
# tests (tests/test_torch_{lunar_lander,bipedal_walker}_env.py), per element.
# HEURISTIC_SEEDS: demo_heuristic_lander on make("LunarLander-v3") lands above
# HEURISTIC_LANDING (tests/envs/test_box2d_parity.py's gate).
BOX2D_PATHS = {
    "LunarLander-v3": ("LunarLander-v3", {}),
    "LunarLanderContinuous-v3": ("LunarLanderContinuous-v3", {}),
    "LunarLander-v3 wind": ("LunarLander-v3", {"enable_wind": True}),
    "BipedalWalker-v3": ("BipedalWalker-v3", {}),
    "BipedalWalkerHardcore-v3": ("BipedalWalkerHardcore-v3", {}),
}
BOX2D_STEPS = 20
BOX2D_CHECK_STEPS = 5
BOX2D_TOL = {"lander": {"obs": (1e-6, 1e-6), "reward": (1e-4, 1e-5)},
             "walker": {"obs": (1e-5, 1e-5), "reward": (1e-4, 1e-5)}}
BOX2D_PROFILED = ("LunarLander-v3", "BipedalWalker-v3")
BOX2D_FRAMES = {"LunarLander-v3": (400, 600, 3), "BipedalWalker-v3": (400, 600, 3), "CarRacing-v3": (400, 600, 3)}
HEURISTIC_SEEDS = (1, 2, 3)
HEURISTIC_LANDING = 100.0
CAR_HOST_STEPS = 20

# The host-class phase: make(id) of the classic-control, toy-text and CPD ids,
# whose classes run on the host in numpy: reset(seed=0), HOST_CLASS_STEPS
# steps of the action space's seeded samples, one render each (the CPD game
# renders text). The same work then runs again under torch.profiler, which
# must see no kernel, no copy and no launch or copy call on the card. The
# CartPoleVectorEnv runs CARTPOLE_VECTOR_STEPS steps at CARTPOLE_VECTOR_ENVS,
# past the 500-step truncation of its lanes that survive.
HOST_CLASS_IDS = ("CartPole-v0", "CartPole-v1", "MountainCar-v0", "MountainCarContinuous-v0", "Pendulum-v1",
                  "Acrobot-v1", "Blackjack-v1", "FrozenLake-v1", "FrozenLake8x8-v1", "CliffWalking-v1",
                  "CliffWalkingSlippery-v1", "Taxi-v3", "BlockchainCPD-v0", "BlockchainCPD-v0-Random",
                  "BlockchainCPD-v0-TFT")
HOST_CLASS_STEPS = 200
CARTPOLE_VECTOR_ENVS = 8
CARTPOLE_VECTOR_STEPS = 600
CUDA_RUNTIME_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset")  # name prefixes

# The host vector env phases. make_vec(id, VEC_ENVS, vectorization_mode="sync")
# on the card with fixed numpy actions: HalfCheetah for VEC_STEPS steps (each
# sub-env step one launch of the robot's build, a reset none), LunarLander for
# VEC_LANDER_STEPS (a step or an autoreset one launch of the lander's build);
# then the first VEC_CHECK_STEPS steps and those around each sub-episode's end
# on the CPU, each sub-env set to its card state before each step, within
# HOST_CHECK_TOL and BOX2D_TOL; VEC_PROFILED_STEPS more steps
# under torch.profiler. Then HalfCheetah with vectorization_mode="async" in
# VEC_ENVS spawned workers over shared memory, equal in every bit to the sync
# env, each worker reporting its device and launches through call(); and the
# same env with the default context (fork), which must raise in the parent
# within VEC_FORK_LIMIT_S. The native tabular stepper: make_vec(id,
# TABULAR_ENVS, vectorization_mode="vector_entry_point") for TABULAR_IDS,
# TABULAR_STEPS steps equal to its numpy path's. The host wrappers: RescaleAction,
# ClipAction, NormalizeObservation and FrameStackObservation(4) over
# make("HalfCheetah-v5") on the card against the CPU for WRAPPER_HOST_STEPS.
VEC_ENVS = 8
VEC_STEPS = 200
VEC_LANDER_STEPS = 100
VEC_PROFILED_STEPS = 5
VEC_CHECK_STEPS = 8
VEC_ROUND_TRIPS = 50
VEC_WAIT_S = 120.0
VEC_FORK_LIMIT_S = 60
TABULAR_ENVS = 4096
TABULAR_STEPS = 512
TABULAR_IDS = ("FrozenLake-v1", "Taxi-v3")
WRAPPER_HOST_STEPS = 100

# The vector wrappers' phase: the chain a PPO user runs (vector_wrapper_chain)
# over make_vec("HalfCheetah-v5", NUM_ENVS) on the card, with a step limit of
# VW_LIMIT, VW_STEPS steps of actions in [-VW_ACTION_BOUND, VW_ACTION_BOUND]
# (so every env ends one episode), the first VW_CHECK_STEPS against the CPU;
# then make_vec("CartPole-v1", NUM_ENVS) under RecordEpisodeStatistics and
# DictInfoToList for VW_CARTPOLE_STEPS, and VW_LAYER_STEPS timed steps under
# each prefix of the chain. The rendering phase: make's
# RenderCollection fallback over make("HalfCheetah-v5") for RENDER_STEPS
# steps, AddWhiteNoise and ObstructView, and one RecordVideo episode of
# RECORD_STEPS steps.
VW_LAYERS = ("RecordEpisodeStatistics", "ClipAction", "NormalizeObservation", "NormalizeReward", "DictInfoToList")
VW_LIMIT = 50
VW_STEPS = 60
VW_ACTION_BOUND = 2.0
VW_CHECK_STEPS = 8
VW_LAYER_STEPS = 20
VW_CARTPOLE_STEPS = 100
RENDER_STEPS = 10
RECORD_STEPS = 20
NOISE_SHARE = 0.1
OBSTRUCTED_SHARE = 0.05
OBSTRUCTION_WIDTH = 8

# The checkers and conversions phase: check_env (skip_render_check) over
# make(id).unwrapped for the articulated, planar and functional-torch paths;
# check_environments_match of make(id) on the card against device="cpu" over
# CHECKER_MATCH_STEPS steps within CHECKER_MATCH_ATOL; NumpyToTorch onto the
# card; ArrayConversion(make_vec("HalfCheetah-v5", NUM_ENVS), "torch",
# "numpy") against the bare env over CONVERSION_STEPS steps each; the
# step-API round trip over STEP_API_STEPS steps of STEP_API_ENVS envs that
# truncate every STEP_API_LIMIT steps; PLAY_FRAMES frames of play; the four
# examples, each a process of its own at EXAMPLE_ARGS.
CHECKER_IDS = {"HalfCheetah-v5": "articulated", "LunarLander-v3": "planar", "phys2d/CartPole-v1": "functional torch"}
CHECKER_MATCH_IDS = ("HalfCheetah-v5", "LunarLander-v3")
CHECKER_MATCH_STEPS = 50
# a free run from one reset: each step's float32 rounding difference is
# carried and grown by the later steps; 1e-3 is 5e-5 of HalfCheetah's largest
# observation over the run (about 19)
CHECKER_MATCH_ATOL = 1e-3
NUMPY_TO_TORCH_STEPS = 20
CONVERSION_STEPS = 20
STEP_API_ENVS = 64
STEP_API_STEPS = 8
STEP_API_LIMIT = 4
PLAY_FRAMES = 30
PLAY_KEYS = {"w": 2, "a": 1, "d": 3}
EXAMPLE_ARGS = {
    "torch_random_rollout.py": ["--steps", "8"],
    "torch_device_rollout.py": ["--num-envs", "256", "--steps", "8"],
    "torch_ppo_cartpole.py": ["--num-envs", "256", "--steps", "8", "--updates", "2"],
    "torch_ppo_halfcheetah_normalized.py": ["--num-envs", "256", "--steps", "8", "--updates", "2"],
}
EXAMPLE_TIMEOUT_S = 300

# The sharded paths (gymnasium_tpu_torch/parallel/): one NCCL rank on one
# card, in a spawned process under a deadline; one rank a card, up to 4,
# where the machine has more.
PARALLEL_CHEETAH_STEPS = 100
PARALLEL_CHEETAH_LIMIT = 50  # every lane truncates and resets once
PARALLEL_LANDER_STEPS = 20
PARALLEL_PPO_TOL = 1e-6  # of the parameters' largest magnitude
PARALLEL_SCALING_STEPS = 8
PARALLEL_MAX_RANKS = 4
PARALLEL_TIMEOUT_S = 420

# The utilities phase (utils/performance.py, utils/checkpoint.py,
# utils/seeding.py) over the articulated kernel: benchmark_step for
# BENCHMARK_SECONDS of make("CartPole-v1") (host) and of make("HalfCheetah-v5")
# (one launch at N=1 a step, none at reset);
# benchmark_compiled_rollout(make_vec("HalfCheetah-v5", NUM_ENVS)) of
# COMPILED_ROLLOUT_STEPS x (1 + COMPILED_ROLLOUT_REPEATS) launches, then one
# more rollout timed as the registry phase times its own; trace around
# TRACE_ENV_STEPS HalfCheetah steps at NUM_ENVS; the HalfCheetah PPO checkpoint
# (ppo_case) resumed bit for bit; torch_generator(0, "cuda").
BENCHMARK_SECONDS = 1.0
COMPILED_ROLLOUT_STEPS = 100
COMPILED_ROLLOUT_REPEATS = 4
TRACE_ENV_STEPS = 5
GENERATOR_DRAWS = 1 << 16

# The MJCF phase's model, written to a temporary file and compiled through
# load_model: a planar chain with a slide root, two limited hinges, two
# motors and a floor contact sphere (contact sphere only on the foot).
MJCF_CHAIN_XML = """
<mujoco model="chain">
  <compiler angle="degree"/>
  <option timestep="0.01"/>
  <worldbody>
    <geom name="floor" type="plane" pos="0 0 0" size="10 10 1"/>
    <body name="cart" pos="0 0 0.34">
      <joint name="slide" type="slide" axis="1 0 0" damping="0.1"/>
      <geom name="cart" type="box" size="0.15 0.1 0.05" density="500" contype="0"/>
      <body name="upper" pos="0 0 0">
        <joint name="hip" type="hinge" axis="0 1 0" limited="true" range="-60 60" damping="0.05"/>
        <geom type="capsule" fromto="0 0 0 0 0 -0.2" size="0.03" contype="0"/>
        <body name="lower" pos="0 0 -0.2">
          <joint name="knee" type="hinge" axis="0 1 0" limited="true" range="-90 90" damping="0.05"/>
          <geom type="capsule" fromto="0 0 0 0 0 -0.15" size="0.025" contype="0"/>
          <geom name="foot" type="sphere" pos="0 0 -0.15" size="0.04"/>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor joint="hip" gear="2" ctrllimited="true" ctrlrange="-1 1"/>
    <motor joint="knee" gear="2" ctrllimited="true" ctrlrange="-1 1"/>
  </actuator>
</mujoco>
"""


def check(cond, message: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def query_gpu(fields: str) -> str:
    """``nvidia-smi --query-gpu=<fields>`` of the first card, one CSV line."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    return query_gpu("name,power.limit")


def cuda_ms(fn, iters: int, warmup: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, iters: int) -> float:
    """Mean device time a call of ``fn`` of the kernels whose name holds
    ``kernel``, from ``torch.profiler`` (CUPTI's kernel durations). CUDA
    events around back-to-back calls (:func:`cuda_ms`) read the host's pace
    instead when a call's host work outlasts its kernel.

    A trace taken after other profiled work in the process has missed one
    launch in every try; the first launch of a trace also starts late. So
    each trace opens with one untimed call, the ``iters`` timed calls run
    inside a ``device_ms`` range, and a kernel counts where it starts inside
    that range's span on the device's timeline. A trace that did not see
    every timed launch is taken again, up to five times; each miss prints
    where the trace's launches are spaced widest."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.autograd.DeviceType.CUDA
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            with record_function("device_ms"):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        spans = [e.time_range for e in events if e.name == "device_ms" and e.device_type == cuda and e.is_user_annotation]
        launched = sorted((e.time_range for e in events
                           if e.device_type == cuda and not e.is_user_annotation and kernel in e.name),
                          key=lambda r: r.start)
        lo, hi = (min(r.start for r in spans), max(r.end for r in spans)) if spans else (0, -1)
        times = [r.elapsed_us() for r in launched if lo <= r.start < hi]
        check(len(times) <= iters, f"the profiler saw {len(times)} launches of {kernel}, more than {iters}")
        if len(times) == iters:
            return sum(times) / iters / 1e3
        gaps = [b.start - a.start for a, b in zip(launched, launched[1:])]
        widest = sorted(range(len(gaps)), key=lambda i: -gaps[i])[:3]
        print(f"device_ms: a trace of {kernel} saw {len(times)} of {iters} timed launches ({len(launched)} in all, "
              f"{len(spans)} device spans); widest spacings after launch {widest}: "
              f"{[gaps[i] for i in widest]} us, median {sorted(gaps)[len(gaps) // 2] if gaps else None} us",
              flush=True)
    raise RuntimeError(f"chip_smoke check failed: the profiler saw {len(times)} of {iters} launches of {kernel}")


def rollout_bytes(n: int, s: int, obs_dtype: torch.dtype) -> int:
    """Bytes the fused rollout must move: each input read once, each output written once."""
    obs_elem = torch.finfo(obs_dtype).bits // 8
    per_step = n * (4 * obs_elem + 4 + 1 + 1)
    inputs = n * (16 + 4 + 1)
    finals = n * (16 + 4 + 1)
    return s * per_step + inputs + finals


def bound(bytes_moved: float, ops_seconds: float) -> tuple[float, str]:
    """The larger of the bytes time and the operations time, in ms, and which."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_seconds * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def rollout_bound_ms(n: int, s: int, obs_dtype: torch.dtype) -> tuple[float, str]:
    ops_seconds = n * s * (CARTPOLE_FLOAT_OPS / FP32_OPS_PER_S + CARTPOLE_INT_OPS / INT32_OPS_PER_S)
    return bound(rollout_bytes(n, s, obs_dtype), ops_seconds)


def articulated_bound_ms(step, n: int) -> tuple[float, str]:
    """Each env reads q, qd, ctrl and writes q', qd' once, in float32, and runs
    the operations the generator emitted (cos, sin, sqrt and divide count one
    each) at the float32 rate."""
    m = step.model
    bytes_moved = n * 4 * (2 * m.nq + 2 * m.nv + m.nu)
    return bound(bytes_moved, n * step.source.ops_per_env / FP32_OPS_PER_S)


def ptxas_summary(log: str) -> dict:
    """Registers, spills and stack frame in an ``-Xptxas -v`` log: the most
    that any kernel of the library uses."""
    regs = re.findall(r"Used (\d+) registers", log)
    frame = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", log)
    summary = {"registers": max(map(int, regs)) if regs else None}
    if frame:
        summary.update(zip(("stack_frame", "spill_stores", "spill_loads"),
                           (max(int(f[i]) for f in frame) for i in range(3))))
    return summary


SASS_BYTES = 16  # a Hopper SASS instruction is 128 bits


def sass_text(lib) -> str:
    """``cuobjdump -sass`` of a built library."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout


def sass_instructions(lib) -> int:
    """SASS instructions in a built library, every kernel and function of it, by ``cuobjdump``."""
    return len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+\S", sass_text(lib)))


def compare_rollout_with_twin(state, steps, prev_done, seed, out, time_limit=TIME_LIMIT):
    """Hold a float32-obs kernel rollout against the plain step function, step by step.

    Every step s of the twin starts from the kernel's own state before it
    (``obs[s-1]``, or the input state) and its done flags, with the shared
    draws, so one ULP of ``sinf`` cannot grow over a chaotic trajectory.
    Returns ``(max_abs_err, near_threshold_lanes, flag_mismatches)``; raises
    if obs differ by more than ``OBS_ATOL``, rewards differ at all, or flags
    differ away from a threshold.
    """
    from gymnasium_tpu_torch.envs.dynamics.cartpole import CartPoleParams
    from gymnasium_tpu_torch.ops.cartpole_rollout import cartpole_draws, cartpole_step_reference

    p = CartPoleParams()
    fstate, fsteps, fdone, obs, reward, term, trunc = out
    s_len, n = reward.shape
    check(obs.dtype == torch.float32, "step comparison needs float32 obs")
    done = term | trunc
    prev_state = torch.cat([state[None], obs[:-1]])  # (S, 4, N)
    prev_dn = torch.cat([prev_done.reshape(1, n), done[:-1]])  # (S, N)
    # step counters follow from the done flags alone
    prev_sp = torch.empty((s_len, n), dtype=torch.int32, device=obs.device)
    sp = steps.reshape(n)
    for s in range(s_len):
        prev_sp[s] = sp
        sp = torch.where(prev_dn[s], 0, sp + 1).to(torch.int32)

    bits, u = cartpole_draws(seed, s_len, n, obs.device)
    flat = lambda x: x.reshape(s_len * n)  # noqa: E731
    t_state, t_steps, t_done, t_reward, t_term, t_trunc = cartpole_step_reference(
        prev_state.permute(1, 0, 2).reshape(4, s_len * n),
        flat(prev_sp),
        flat(prev_dn),
        flat(bits),
        u.permute(1, 0, 2).reshape(4, s_len * n),
        time_limit,
        p,
    )
    t_obs = t_state.reshape(4, s_len, n).permute(1, 0, 2)
    max_err = float((t_obs - obs).abs().max())
    check(max_err <= OBS_ATOL, f"obs differ from the twin by {max_err} > {OBS_ATOL}")
    check(torch.equal(t_reward.reshape(s_len, n), reward), "reward differs from the twin")

    x, th = obs[:, 0, :], obs[:, 2, :]
    near = ((x.abs() - np.float32(p.x_threshold)).abs() < THRESHOLD_BAND) | (
        (th.abs() - np.float32(p.theta_threshold)).abs() < THRESHOLD_BAND
    )
    mismatch = (t_term.reshape(s_len, n) != term) | (t_trunc.reshape(s_len, n) != trunc)
    check(not (mismatch & ~near).any(), "flags differ from the twin away from a threshold")
    # the kernel's flags follow from its own obs exactly, near a threshold too
    crossed = (x.abs() > np.float32(p.x_threshold)) | (th.abs() > np.float32(p.theta_threshold))
    check(torch.equal(term, crossed & ~prev_dn), "terminated is not the threshold test of obs")
    want_trunc = ~term & (t_steps.reshape(s_len, n) >= time_limit) & ~prev_dn
    check(torch.equal(trunc, want_trunc), "truncated is not steps >= time_limit")
    check(torch.equal(fstate, obs[-1]), "final state is not the last obs")
    check(torch.equal(fsteps, sp), "final steps disagree with the step counters")
    check(torch.equal(fdone, done[-1]), "final done is not the last step's done")
    return max_err, int(near.sum()), int(mismatch.sum())


def warm_headline(dev) -> float:
    """One untimed headline block (bf16 obs), so the timed blocks find the
    kernel loaded and the card's clocks up. Returns its host-clock ms."""
    from gymnasium_tpu_torch.ops import cartpole_rollout_fused

    carry = (
        torch.zeros((4, NUM_ENVS), device=dev),
        torch.zeros(NUM_ENVS, dtype=torch.int32, device=dev),
        torch.zeros(NUM_ENVS, dtype=torch.bool, device=dev),
    )
    torch.cuda.synchronize()
    start = time.perf_counter()
    cartpole_rollout_fused(*carry, HEADLINE_BLOCKS, STEPS_PER_BLOCK, obs_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3


def run_headline(dev) -> tuple[dict, dict]:
    """bench.py's headline: chained fused-rollout blocks, bf16 then f32 obs.

    Returns env-steps/s over all blocks and each block's milliseconds, both
    on the host clock, by obs type. Each block ends in a synchronise, so a
    first-use cost shows in the block that pays it.
    """
    from gymnasium_tpu_torch.ops import cartpole_rollout_fused

    rates, block_ms = {}, {}
    for obs_dtype in (torch.bfloat16, torch.float32):
        carry = (
            torch.zeros((4, NUM_ENVS), device=dev),
            torch.zeros(NUM_ENVS, dtype=torch.int32, device=dev),
            torch.zeros(NUM_ENVS, dtype=torch.bool, device=dev),
        )
        torch.cuda.synchronize()
        times = []
        for block in range(HEADLINE_BLOCKS):
            start = time.perf_counter()
            out = cartpole_rollout_fused(*carry, block, STEPS_PER_BLOCK, obs_dtype=obs_dtype)
            carry = out[:3]
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
        obs, reward, term, trunc = out[3:]
        check(obs.shape == (STEPS_PER_BLOCK, 4, NUM_ENVS) and obs.dtype == obs_dtype, "obs shape")
        check(bool(torch.isfinite(obs.float()).all()), "headline obs not finite")
        check(bool(((reward == 0) | (reward == 1)).all()), "headline reward not in {0, 1}")
        check(bool((term | trunc).any()), "no episode ended in a headline block")
        rates[str(obs_dtype)] = NUM_ENVS * STEPS_PER_BLOCK * HEADLINE_BLOCKS / (sum(times) / 1e3)
        block_ms[str(obs_dtype)] = times
    return rates, block_ms


def run_vector_env(dev) -> float:
    from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional
    from gymnasium_tpu_torch.vector import TorchVectorEnv

    env = TorchVectorEnv(CartPoleFunctional(), NUM_ENVS, max_episode_steps=TIME_LIMIT, device=dev)
    obs, _ = env.reset(seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(4):
        actions = env.single_action_space.sample_torch(gen, (NUM_ENVS,))
        obs, reward, term, trunc, _ = env.step(actions)
    check(bool(torch.isfinite(obs).all()), "vector env obs not finite")

    mask = np.zeros(NUM_ENVS, np.bool_)
    mask[::2] = True
    keep = torch.from_numpy(~mask).to(dev)
    state_before = env.carry.state.clone()
    mobs, _ = env.reset(options={"reset_mask": mask})
    check(torch.equal(env.carry.state[keep], state_before[keep]), "partial reset moved kept lanes")
    check(torch.equal(mobs[keep], obs[keep]), "partial reset changed kept lanes' obs")
    check(not bool(env.carry.steps[~keep].any()), "partial reset left step counters")

    torch.cuda.synchronize()
    start = time.perf_counter()
    carry, traj = env.rollout(256)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    done = traj.terminated | traj.truncated
    check(bool(torch.isfinite(traj.obs).all()), "rollout obs not finite")
    check(torch.equal(traj.reward[1:] == 0, done[:-1]), "reward is not 0 exactly after a done")
    check(int(carry.steps.max()) <= TIME_LIMIT, "a step counter passed the time limit")
    return NUM_ENVS * 256 / seconds


def articulated_env(name: str):
    """The functional env of the robot whose model is ``name``."""
    from gymnasium_tpu_torch.envs import mujoco

    return getattr(mujoco, ART_ENVS[name])()


def run_articulated(dev, name: str, n: int = NUM_ENVS) -> dict:
    """A MuJoCo-class robot under ``TorchVectorEnv``. A robot of
    ``ART_FULL_PATHS``: reset, a few sampled steps, a masked reset of every
    other lane, then ``rollout(ART_ROLLOUT)``; any other: reset, then
    ``rollout(ROBOT_ROLLOUT)``. Returns the rollout's host-clock env-steps/s
    and the terminations seen."""
    from gymnasium_tpu_torch.functional import tree_map
    from gymnasium_tpu_torch.vector import TorchVectorEnv

    env = TorchVectorEnv(articulated_env(name), n, max_episode_steps=ART_TIME_LIMIT, device=dev)
    obs, _ = env.reset(seed=0)
    x0 = env.carry.state["qpos"][:, 0].clone()
    full = name in ART_FULL_PATHS
    terminations = 0
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    if full:
        gen = torch.Generator(device=dev).manual_seed(1)
        for _ in range(ART_WARM_STEPS):
            actions = env.single_action_space.sample_torch(gen, (n,))
            obs, reward, term, trunc, _ = env.step(actions)
            terminations += int(term.sum())
        check(bool(torch.isfinite(obs).all() and torch.isfinite(reward).all()), f"{name} step not finite")

        mask = np.zeros(n, np.bool_)
        mask[::2] = True
        keep = torch.from_numpy(~mask).to(dev)
        before = tree_map(torch.clone, env.carry.state)
        mobs, _ = env.reset(options={"reset_mask": mask})
        for key in ("qpos", "qvel", "prev_x"):
            check(torch.equal(env.carry.state[key][keep], before[key][keep]), f"{name}: masked reset moved kept {key}")
        check(torch.equal(mobs[keep], obs[keep]), f"{name}: masked reset changed kept lanes' obs")

    steps = ART_ROLLOUT if full else ROBOT_ROLLOUT
    torch.cuda.synchronize()
    start = time.perf_counter()
    carry, traj = env.rollout(steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    dim = env.single_observation_space.shape[0]
    check(traj.obs.shape == (steps, n, dim), f"{name} obs shape {tuple(traj.obs.shape)}, want {(steps, n, dim)}")
    check(bool(torch.isfinite(traj.obs).all()), f"{name} rollout obs not finite")
    check(bool(torch.isfinite(traj.reward).all()), f"{name} rollout reward not finite")
    terminations += int(traj.terminated.sum())
    if full:
        moved = float((carry.state["qpos"][keep, 0] - x0[keep]).abs().mean())
        check(moved > 1e-3, f"{name} qpos[:, 0] did not move (mean |dx| {moved})")
    return {"env_steps_per_s": n * steps / seconds, "terminations": terminations}


def profile_env_step(dev, func, label: str, time_limit: int | None, kernel: str | None = None, n: int = NUM_ENVS,
                     steps: int = PROFILED_ENV_STEPS, launches_a_step: int = 1, ranges: tuple[str, ...] = ()) -> dict:
    """``torch.profiler`` over ``steps`` env steps of the functional env
    ``func`` under ``TorchVectorEnv`` at ``n`` envs, after a few unprofiled
    ones: kernels and memory copies a step, the device's busy time a step
    (kernel and copy time; one stream) and its share of the profiled wall
    time, the host's stream synchronisations a step, and the host-clock time
    a step without the profiler. With ``kernel`` (a part of a kernel's
    name), also that kernel's device time a step; a trace that did not see
    ``launches_a_step`` launches of it a step is taken again (up to five
    times). For each ``record_function`` range of ``ranges``, the device
    time a step and the kernels a step that start inside its spans on the
    device's timeline. Also the five kernels (by name) that take the most
    device time a step."""
    from torch.profiler import ProfilerActivity, profile

    from gymnasium_tpu_torch.vector import TorchVectorEnv

    cuda = torch.autograd.DeviceType.CUDA
    env = TorchVectorEnv(func, n, max_episode_steps=time_limit, device=dev)
    env.reset(seed=0)
    env.rollout(ART_WARM_STEPS)
    torch.cuda.synchronize()
    start = time.perf_counter()
    env.rollout(steps)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - start) * 1e3 / steps
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            env.rollout(steps)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - start) * 1e3 / steps
        events = prof.events()
        device = [e for e in events if e.device_type == cuda and not e.is_user_annotation]
        copies = [e for e in device if e.name.startswith(("Memcpy", "Memset"))]
        kernels = [e for e in device if not e.name.startswith(("Memcpy", "Memset"))]
        own = [e for e in kernels if kernel and kernel in e.name]
        if kernel is None or len(own) == steps * launches_a_step:
            break
    check(kernel is None or len(own) == steps * launches_a_step,
          f"the profiler saw {len(own)} of {steps * launches_a_step} launches of {kernel}")
    check(kernels, f"{label}: the profiler saw no kernel on the card")
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3 / steps
    # a copy from pageable host memory waits for the stream: the host stalls on the card
    syncs = sum(e.name == "cudaStreamSynchronize" for e in events)
    result = {"env": label, "envs": n, "profiled_steps": steps, "step_ms": step_ms, "profiled_step_ms": wall_ms,
              "kernels_a_step": len(kernels) / steps, "copies_a_step": len(copies) / steps,
              "device_busy_ms_a_step": busy_ms, "device_busy_share": busy_ms / wall_ms,
              "stream_syncs_a_step": syncs / steps}
    if kernel:
        result["kernel_device_ms_a_step"] = sum(e.time_range.elapsed_us() for e in own) / 1e3 / steps
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:80]] += e.time_range.elapsed_us()
    result["top_kernels_device_ms_a_step"] = {k: us / 1e3 / steps for k, us in by_name.most_common(5)}
    for name in ranges:
        spans = [e.time_range for e in events if e.name == name and e.device_type == cuda and e.is_user_annotation]
        check(len(spans) >= steps, f"{label}: {len(spans)} device spans of {name} over {steps} steps")
        inside = [e for e in device if any(r.start <= e.time_range.start < r.end for r in spans)]
        result[name] = {"device_ms_a_step": sum(e.time_range.elapsed_us() for e in inside) / 1e3 / steps,
                        "kernels_a_step": len(inside) / steps}
    return result


def rest_pose(model) -> np.ndarray:
    """A free-root robot's pose (nq,) at which, with no control and no
    velocity, no internal or external torque turns the root: ``init_qpos``
    with each limited joint moved 0.01 inside its range, lifted 0.05 clear
    of the ground. At ``init_qpos`` itself Humanoid's knees lie outside
    their limits, so the limit springs drive the legs and the root turns in
    reaction (and HumanoidStandup lies on the floor); Ant's ankles too, but
    its four legs' reactions cancel."""
    from gymnasium_tpu_torch.physics.articulated import init_qpos, make_dynamics

    q = init_qpos(model).copy()
    j = model.joints
    for k in range(6, model.nv):
        if j.limited[k]:
            q[k + 1] = np.clip(q[k + 1], j.lower[k] + 0.01, j.upper[k] - 0.01)
    pts = make_dynamics(model)["contact_points"](torch.tensor(q[None], dtype=torch.float32))[0].numpy()
    depth = np.max(np.asarray(model.contact_radius) - (pts[:, 2] - model.ground_z), initial=0.0)
    q[2] += max(depth, 0.0) + 0.05
    return q


def articulated_states(model, n: int, dev, seed: int = 0):
    """Perturbed states, as tests/ops/test_pallas_articulated.py::_states makes
    them. For a free root, every eighth lane instead rests at
    :func:`rest_pose` with no control and an angular velocity below 5e-4, so
    the quaternion exponential takes its small-angle side there."""
    from gymnasium_tpu_torch.physics.articulated import init_qpos

    rng = np.random.default_rng(seed)
    q = np.tile(init_qpos(model)[None, :], (n, 1)).astype(np.float32)
    q += rng.uniform(-0.2, 0.2, q.shape).astype(np.float32)
    if model.root_free:
        q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    qd = rng.uniform(-0.5, 0.5, (n, model.nv)).astype(np.float32)
    ctrl = rng.uniform(-0.4, 0.4, (n, max(model.nu, 1))).astype(np.float32)[:, : model.nu]
    if model.root_free:
        q[::8] = rest_pose(model)
        qd[::8] = 0.0
        qd[::8, 3:6] = rng.uniform(-5e-4, 5e-4, qd[::8, 3:6].shape)
        ctrl[::8] = 0.0
    return tuple(torch.from_numpy(x).to(dev) for x in (q, qd, ctrl))


def small_angle_lanes(model, qd_out) -> int:
    """Lanes whose last substep took the small-angle side (th2 <= 1e-10) of
    the free root's quaternion exponential: it turns by ``dt * qd'[3:6]``."""
    th2 = ((model.timestep * qd_out[:, 3:6].double()) ** 2).sum(dim=1)
    return int((th2 <= 1e-10).sum())


def compare_articulated_with_twin(step, q, qd, ctrl) -> tuple[float, float, int, bool]:
    """One kernel call against the plain twin on the same inputs. Raises if a
    bit differs from the twin's (zero signs too), if two calls differ in a
    bit, or if a free root's states never reach the small-angle side of its
    quaternion exponential. Returns ``(max |dq|, max |dqd|, small-angle
    lanes, True)``: the bits are equal."""
    out = step(q, qd, ctrl)
    again = step(q, qd, ctrl)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, again)), f"{step.name}: same input, different bits")
    ref = step.reference(q, qd, ctrl)
    errs = []
    for label, got, want in (("q", out[0], ref[0]), ("qd", out[1], ref[1])):
        check(bool(torch.isfinite(got).all()), f"{step.name}: kernel {label} not finite")
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"{step.name}: kernel {label} differs from the twin by up to {err}")
        errs.append(err)
    small = small_angle_lanes(step.model, out[1]) if step.model.root_free else 0
    check(not step.model.root_free or small >= q.shape[0] // 8,
          f"{step.name}: only {small} lanes took the small-angle side of the quaternion exponential")
    # torch.equal holds -0.0 equal to 0.0; the bits tell the zeros' signs apart too
    bit_equal = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(out, ref))
    check(bit_equal, f"{step.name}: kernel and twin differ in the sign of a zero")
    return errs[0], errs[1], small, bit_equal


def run_lunar_lander(dev, n: int = NUM_ENVS) -> float:
    """LunarLander-v3 under ``TorchVectorEnv``: reset, a few sampled steps, a
    masked reset of every other lane, then ``rollout(PLANAR_ROLLOUT)``.
    Returns the rollout's host-clock env-steps/s."""
    from gymnasium_tpu_torch.envs.box2d.lunar_lander import LunarLanderFunctional
    from gymnasium_tpu_torch.functional import tree_map
    from gymnasium_tpu_torch.vector import TorchVectorEnv

    env = TorchVectorEnv(LunarLanderFunctional(), n, max_episode_steps=PLANAR_TIME_LIMIT, device=dev)
    obs, _ = env.reset(seed=0)
    terrain_reset = env.carry.state["terrain"].clone()
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(PLANAR_WARM_STEPS):
        actions = env.single_action_space.sample_torch(gen, (n,))
        obs, reward, term, trunc, _ = env.step(actions)
    check(bool(torch.isfinite(obs).all() and torch.isfinite(reward).all()), "lunar_lander step not finite")
    check(not bool(env.carry.prev_done.any()), "a lunar_lander lane ended within the first steps")
    check(torch.equal(env.carry.state["terrain"], terrain_reset), "terrain changed over steps without a reset")

    mask = np.zeros(n, np.bool_)
    mask[::2] = True
    keep = torch.from_numpy(~mask).to(dev)
    before = tree_map(torch.clone, env.carry.state)
    mobs, _ = env.reset(options={"reset_mask": mask})
    for key, leaf in env.carry.state.items():
        check(leaf.dtype == before[key].dtype, f"masked reset changed the dtype of {key}")
        check(torch.equal(leaf[keep], before[key][keep]), f"masked reset moved kept {key}")
    check(not torch.equal(env.carry.state["terrain"][~keep], before["terrain"][~keep]),
          "masked reset kept the terrain of reset lanes")
    check(torch.equal(mobs[keep], obs[keep]), "masked reset changed kept lanes' obs")

    terrain0 = env.carry.state["terrain"].clone()
    done0 = env.carry.prev_done.clone()
    torch.cuda.synchronize()
    start = time.perf_counter()
    carry, traj = env.rollout(PLANAR_ROLLOUT)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    check(traj.obs.shape == (PLANAR_ROLLOUT, n, 8), f"lunar_lander obs shape {tuple(traj.obs.shape)}")
    check(bool(torch.isfinite(traj.obs).all()), "lunar_lander rollout obs not finite")
    check(bool(torch.isfinite(traj.reward).all()), "lunar_lander rollout reward not finite")
    for key in ("leg1", "leg2", "done"):
        check(carry.state[key].dtype == torch.bool, f"lunar_lander {key} is not bool after the rollout")
    ended = traj.terminated
    check(bool(ended.any()), "no lunar_lander lane crashed or landed in the rollout")
    ended_reward = traj.reward[ended]
    check(bool(((ended_reward == -100.0) | (ended_reward == 100.0)).all()),
          "a terminated lunar_lander step's reward is not -100 or +100")
    # a lane resets on the step after a done and draws a new terrain then;
    # a lane with no done before the last step keeps its terrain
    reset = done0 | (traj.terminated[:-1] | traj.truncated[:-1]).any(dim=0)
    changed = (carry.state["terrain"] != terrain0).any(dim=1)
    check(torch.equal(changed, reset), "terrain changed on a lane that did not reset, or kept on one that did")
    print(f"lunar_lander rollout: {int(ended.sum())} terminations "
          f"({int((ended_reward == -100.0).sum())} crashed, {int((ended_reward == 100.0).sum())} landed), "
          f"{int(reset.sum())} of {n} lanes reset", flush=True)
    return n * PLANAR_ROLLOUT / seconds


def planar_states(n: int, dev, seed: int = 0):
    """Inputs of the lander's planar step, in four groups by lane index mod 4.

    0. ``tests/ops/test_pallas_planar.py::_random_lander_states``: the hull
       3.4-6 m up with random velocities, external forces and impulses;
       each leg turned 0.05 rad against the hull, past its hip limit.
    1. The same, with the leg corners within 3 cm of the ground under the hull.
    2. The creation pose of ``initial_state_pre`` with no force and no
       impulses: the reset tick's input, hip joints violated.
    3. The hull 0.5-1.5 m beyond either end of the terrain and 1.2-2 m deep
       in the ground, so the terrain index clips and the position pass's
       contact correction hits its clamp.
    """
    from gymnasium_tpu_torch.envs.dynamics import lunar_lander as dyn

    rng = np.random.default_rng(seed)
    terrain_u = rng.uniform(0, 1, (n, dyn.CHUNKS + 1)).astype(np.float32)
    force_u = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    pre = dyn.initial_state_pre(torch.from_numpy(terrain_u), torch.from_numpy(force_u), dyn.LunarParams())
    terrain = pre["terrain"].numpy()
    group = np.arange(n) % 4
    near, pose, deep = group == 1, group == 2, group == 3

    hx = dyn.W / 2 + rng.uniform(-1, 1, n)
    hy = rng.uniform(3.4, 6.0, n)
    ang = rng.uniform(-0.4, 0.4, n)
    xs = np.linspace(0, dyn.W, dyn.CHUNKS)
    ground = np.array([np.interp(x, xs, h) for x, h in zip(hx, terrain)])
    # the leg corners sit 0.3 + LEG_H / SCALE, about 0.57 m, below the hull centre
    hy[near] = ground[near] + 0.3 + dyn.LEG_H / dyn.SCALE + rng.uniform(-0.03, 0.03, near.sum())
    ang[near] = rng.uniform(-0.1, 0.1, near.sum())
    left = deep & (rng.uniform(size=n) < 0.5)
    right = deep & ~left
    hx[left] = rng.uniform(-1.5, -0.5, left.sum())
    hx[right] = dyn.W + rng.uniform(0.5, 1.5, right.sum())
    end_ground = np.where(hx < 0, terrain[:, 0], terrain[:, -1])
    hy[deep] = end_ground[deep] - rng.uniform(1.2, 2.0, deep.sum())

    bodies = np.zeros((n, 3, 6), np.float32)
    bodies[:, 0, 0], bodies[:, 0, 1], bodies[:, 0, 2] = hx, hy, ang
    bodies[:, 0, 3:6] = rng.uniform(-1, 1, (n, 3))
    for i, sgn in enumerate((-1.0, 1.0)):
        bodies[:, 1 + i, 0] = bodies[:, 0, 0] - sgn * dyn.LEG_AWAY / dyn.SCALE
        bodies[:, 1 + i, 1] = bodies[:, 0, 1] - 0.3
        bodies[:, 1 + i, 2] = bodies[:, 0, 2] + sgn * 0.05
        bodies[:, 1 + i, 3:6] = rng.uniform(-1, 1, (n, 3))
    ext = np.zeros((n, 3, 3), np.float32)
    ext[:, 0, :] = rng.uniform(-5, 5, (n, 3))
    jimp = rng.uniform(-0.05, 0.05, (n, 2, 5)).astype(np.float32)
    cimp = rng.uniform(0, 0.05, (n, dyn.N_CONTACTS, 2)).astype(np.float32)
    bodies[pose] = pre["body"].numpy()[pose]
    ext[pose], jimp[pose], cimp[pose] = 0.0, 0.0, 0.0
    return tuple(torch.from_numpy(x).to(dev) for x in (bodies, ext, terrain, jimp, cimp))


def walker_states(n: int, dev, seed: int = 0):
    """Inputs of the walker's planar step ``(bodies, None, terrain, None,
    cimp, motor_speed, motor_torque)``, in four groups by lane index mod 4,
    each on its own terrain (hardcore on odd lanes):

    0. The creation pose of ``reset_pre`` (hips 0.53 m from their anchors,
       so the position pass pulls at most 0.2 m an iteration), no contact
       impulse, motors of random actions.
    1. An assembled pose (every joint on its anchor) with random joint
       angles, a third of them past a limit, random velocities, the lowest
       foot within 3 cm of the ground, and live warm-start contact impulses.
    2. The same, sunk 1.1-1.5 m into the ground: the contact correction
       clamps.
    3. The same in the air beyond either end of the terrain, so the terrain
       index clips.
    """
    from gymnasium_tpu_torch.envs.box2d import bipedal_walker as bw

    rng = np.random.default_rng(seed)
    draws = [torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)) for shape in
             ((n, bw.TERRAIN_LENGTH), (n, bw.TERRAIN_LENGTH), (n,))]
    normal, hard = bw.BipedalWalkerFunctional(), bw.BipedalWalkerFunctional({"hardcore": True})
    pre, pre_hard = normal.reset_pre(*draws), hard.reset_pre(*draws)
    odd = np.arange(n) % 2 == 1
    terrain = np.where(odd[:, None], pre_hard["terrain"].numpy(), pre["terrain"].numpy())
    group = np.arange(n) % 4

    # an assembled pose from the hull pose and the four links' angles
    hx = rng.uniform(2.0, 80.0, n)
    hx[group == 3] = np.where(rng.uniform(size=(group == 3).sum()) < 0.5,
                              rng.uniform(-3.0, -1.0, (group == 3).sum()),
                              rng.uniform(95.0, 97.0, (group == 3).sum()))
    hang = rng.uniform(-0.5, 0.5, n)
    lower, upper = bw._WORLD.joints.lower, bw._WORLD.joints.upper
    joint = rng.uniform(lower + 0.05, upper - 0.05, (n, 4))
    past = rng.uniform(size=(n, 4)) < 0.33
    beyond = rng.uniform(0.1, 0.3, (n, 4))
    joint[past] = np.where(rng.uniform(size=(n, 4)) < 0.5, lower - beyond, upper + beyond)[past]
    bodies = np.zeros((n, 5, 6))
    bodies[:, 0, 2] = hang
    link = {1: (0, 0), 2: (1, 1), 3: (0, 2), 4: (3, 3)}  # body: (parent, joint)
    hip = np.array(bw._HIP_ANCHOR_HULL)
    half = bw.LEG_H / 2

    def rotate(v, a):
        return np.stack([v[0] * np.cos(a) - v[1] * np.sin(a), v[0] * np.sin(a) + v[1] * np.cos(a)], axis=-1)

    pos = {0: np.zeros((n, 2))}
    for b, (parent, j) in link.items():
        bodies[:, b, 2] = bodies[:, parent, 2] + joint[:, j]
        anchor = hip if parent == 0 else np.array([0.0, -half])
        top = pos[parent] + rotate(anchor, bodies[:, parent, 2])
        pos[b] = top - rotate(np.array([0.0, half]), bodies[:, b, 2])
    feet = np.stack([pos[b][:, 1] + rotate(np.array([0.0, -half]), bodies[:, b, 2])[:, 1] for b in (2, 4)], 1)
    xs = np.arange(bw.TERRAIN_LENGTH) * bw.TERRAIN_STEP
    ground = np.array([np.interp(x, xs, h) for x, h in zip(hx, terrain)])
    hy = ground - feet.min(1) + rng.uniform(-0.03, 0.03, n)
    hy[group == 2] -= rng.uniform(1.1, 1.5, (group == 2).sum())
    hy[group == 3] += rng.uniform(0.5, 2.0, (group == 3).sum())
    for b in range(5):
        bodies[:, b, 0] = hx + pos[b][:, 0]
        bodies[:, b, 1] = hy + pos[b][:, 1]
    bodies[:, :, 3:6] = rng.uniform(-1, 1, (n, 5, 3))
    cimp = rng.uniform(0, 0.5, (n, bw.N_CONTACTS, 2)) * np.array([1.0, 0.2])
    actions = rng.uniform(-1, 1, (n, 4))
    pose = group == 0
    bodies[pose] = np.where(odd[pose, None, None], pre_hard["bodies"].numpy()[pose], pre["bodies"].numpy()[pose])
    cimp[pose] = 0.0
    speed = np.sign(actions) * np.array([bw.SPEED_HIP, bw.SPEED_KNEE, bw.SPEED_HIP, bw.SPEED_KNEE])
    torque = bw.MOTORS_TORQUE * np.abs(actions)
    f32 = [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (bodies, terrain, cimp, speed, torque)]
    return f32[0], None, f32[1], None, f32[2], f32[3], f32[4]


def planar_branch_lanes(step, bodies, external, terrain, jimp, cimp, *motors) -> dict:
    """Lanes whose first tick reaches each side of the solver, counted from
    the inputs with plain float64 arithmetic at the input pose. A world with
    a joint correction clamp also counts the lanes with a joint's anchor
    error above the clamp (pulled in bounded steps) and those with every
    error below it."""
    t = step.tables
    b, terr = bodies.double(), terrain.double()
    ang = b[:, :, 2]
    f64 = dict(dtype=torch.float64, device=b.device)
    idx = torch.tensor(t.c_body, device=b.device)
    pts = torch.tensor(t.c_point, **f64)
    cb, sb = torch.cos(ang[:, idx]), torch.sin(ang[:, idx])
    rx = pts[:, 0] * cb - pts[:, 1] * sb
    ry = pts[:, 0] * sb + pts[:, 1] * cb
    u = (b[:, idx, 0] + rx) / t.spacing
    xc = u.clamp(0.0, t.chunks - 1 - 1e-6)
    i0 = torch.floor(xc).long()
    h0 = terr.gather(1, i0)
    h1 = terr.gather(1, (i0 + 1).clamp(max=t.chunks - 1))
    depth = h0 + (xc - i0) * (h1 - h0) - (b[:, idx, 1] + ry)
    j_angle = ang[:, t.j_b] - ang[:, t.j_a] - torch.tensor(t.j_ref, **f64)
    lower = torch.tensor(t.j_lower, **f64)
    upper = torch.tensor(t.j_upper, **f64)
    over = (j_angle - lower).clamp(max=0.0) + (j_angle - upper).clamp(min=0.0)
    lanes = {
        "active_contact": (depth > 0).any(1),
        "dropped_warm_impulse": ((depth <= 0) & (cimp != 0).any(-1)).any(1),
        "lower_limit": (j_angle < lower).any(1),
        "upper_limit": (j_angle > upper).any(1),
        "clamped_contact_correction": (t.baumgarte * (depth - t.slop) > t.max_corr).any(1),
        "clamped_angle_correction": (over.abs() > 8.0 * 3.14159265 / 180.0).any(1),
        "clipped_terrain_index": ((u < 0) | (u > t.chunks - 1 - 1e-6)).any(1),
    }
    if t.joint_clamp > 0.0:
        def anchors(side, table):
            body = b[:, side]
            arm = torch.tensor(table, **f64)
            c, s = torch.cos(body[:, :, 2]), torch.sin(body[:, :, 2])
            return (body[:, :, 0] + arm[:, 0] * c - arm[:, 1] * s, body[:, :, 1] + arm[:, 0] * s + arm[:, 1] * c)

        (ax, ay), (bx, by) = anchors(t.j_a, t.anchor_a), anchors(t.j_b, t.anchor_b)
        err = torch.hypot(bx - ax, by - ay)
        lanes["clamped_joint_pull"] = (err > t.joint_clamp).any(1)
        lanes["unclamped_joint_pull"] = (err < t.joint_clamp).all(1)
    return {name: int(hit.sum()) for name, hit in lanes.items()}


def compare_planar_with_twin(step, inputs, every_branch: bool = True) -> dict:
    """One kernel call against the plain twin on the same inputs. Raises on
    any differing value or flag, if two calls differ in a bit, or (with
    ``every_branch``; a batch of a few lanes cannot) if a side of the solver
    is reached by no lane. Returns the largest deviations (0), whether the
    bits are equal too, and the branch counts."""
    out = step(*inputs)
    again = step(*inputs)
    torch.cuda.synchronize()
    check(all(a is b or torch.equal(a, b) for a, b in zip(out, again)), f"{step.name}: same input, different bits")
    ref = step.reference(*inputs)
    result, floats = {}, []
    for label, got, want in zip(("bodies", "jimp", "cimp"), out[:3], ref[:3]):
        check((got is None) == (want is None), f"{step.name}: kernel and twin disagree on the {label} output")
        if got is None:
            continue
        check(bool(torch.isfinite(got).all()), f"{step.name}: kernel {label} not finite")
        err = result[f"max_abs_err_{label}"] = float((got - want).abs().max())
        check(torch.equal(got, want), f"{step.name}: kernel {label} differs from the twin by up to {err}")
        floats.append((got, want))
    check(out[3].dtype == torch.bool, f"{step.name}: flags are {out[3].dtype}, not bool")
    result["flag_mismatches"] = int((out[3] != ref[3]).sum())
    check(result["flag_mismatches"] == 0, f"{step.name}: {result['flag_mismatches']} flags differ from the twin")
    result["flags_set"] = int(out[3].sum())
    # torch.equal holds -0.0 equal to 0.0; the bits tell the zeros' signs apart too
    result["bit_equal"] = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in floats)
    check(result["bit_equal"], f"{step.name}: kernel and twin differ in the sign of a zero")
    branches = planar_branch_lanes(step, *inputs)
    missing = [name for name, count in branches.items() if count == 0]
    check(not every_branch or not missing, f"{step.name}: no lane reaches {missing}")
    result["branch_lanes"] = branches
    return result


def planar_bytes_per_env(step) -> int:
    """Bytes an env's call reads and writes once: its body rows, external
    forces, terrain row, joint impulses and per-env motors where the world
    has them, contact impulses; out the bodies, the impulses it carries and
    a flag byte a contact."""
    t = step.tables
    ext = 3 * t.nbody if t.external else 0
    jimp = 5 * t.njoint if t.carry_joints else 0
    motors = 2 * t.njoint if t.motor_speed is None else 0
    floats_in = 6 * t.nbody + ext + t.chunks + jimp + 2 * t.ncontact + motors
    floats_out = 6 * t.nbody + jimp + 2 * t.ncontact
    return 4 * (floats_in + floats_out) + t.ncontact


def planar_bound_ms(step, n: int) -> tuple[float, str]:
    """Each env moves :func:`planar_bytes_per_env` once and runs the float
    operations the generator emitted (cos, sin, floor, divide, select and
    compare count one each; the walker's indexed loads are memory reads, not
    counted) at the float32 rate. The walker's terrain row counts whole,
    though a call reads a few of its 200 heights: operations bound it all
    the same."""
    source = step.source
    loads = source.prologue_ops.get("load", 0) + source.substeps * source.substep_ops.get("load", 0)
    return bound(n * planar_bytes_per_env(step), n * (source.ops_per_env - loads) / FP32_OPS_PER_S)


def walker_env(hardcore: bool = False):
    from gymnasium_tpu_torch.envs.box2d import BipedalWalkerFunctional

    return BipedalWalkerFunctional({"hardcore": hardcore})


def walker_id(hardcore: bool = False) -> str:
    return "BipedalWalkerHardcore-v3" if hardcore else "BipedalWalker-v3"


def run_bipedal(dev, hardcore: bool, n: int = NUM_ENVS) -> dict:
    """BipedalWalker (hardcore: its hardcore variant) under ``TorchVectorEnv``
    at its step limit: reset, a few sampled steps, a masked reset of every
    other lane, then ``rollout(BIPEDAL_ROLLOUT)``. Checks shapes, finite
    values inside the observation's bounds, the terrain kept between resets
    and drawn anew at each, and crashes rewarded -100. Returns the rollout's
    host-clock env-steps/s and its episode ends."""
    from gymnasium_tpu_torch.functional import tree_map
    from gymnasium_tpu_torch.vector import TorchVectorEnv

    func = walker_env(hardcore)
    label = "bipedal_walker_hardcore" if hardcore else "bipedal_walker"
    env = TorchVectorEnv(func, n, max_episode_steps=step_limit(walker_id(hardcore)), device=dev)
    obs, _ = env.reset(seed=0)
    check(obs.shape == (n, 24) and obs.dtype == torch.float32, f"{label} reset obs {tuple(obs.shape)} {obs.dtype}")
    terrain_reset = env.carry.state["terrain"].clone()
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(BIPEDAL_WARM_STEPS):
        obs, reward, term, trunc, _ = env.step(env.single_action_space.sample_torch(gen, (n,)))
    check(bool(torch.isfinite(obs).all() and torch.isfinite(reward).all()), f"{label} step not finite")
    check(torch.equal(env.carry.state["terrain"], terrain_reset), f"{label} terrain changed without a reset")

    mask = np.zeros(n, np.bool_)
    mask[::2] = True
    keep = torch.from_numpy(~mask).to(dev)
    before = tree_map(torch.clone, env.carry.state)
    mobs, _ = env.reset(options={"reset_mask": mask})
    for key, leaf in env.carry.state.items():
        check(leaf.dtype == before[key].dtype, f"{label}: masked reset changed the dtype of {key}")
        check(torch.equal(leaf[keep], before[key][keep]), f"{label}: masked reset moved kept {key}")
    check(not torch.equal(env.carry.state["terrain"][~keep], before["terrain"][~keep]),
          f"{label}: masked reset kept the terrain of reset lanes")
    check(torch.equal(mobs[keep], obs[keep]), f"{label}: masked reset changed kept lanes' obs")

    terrain0, done0 = env.carry.state["terrain"].clone(), env.carry.prev_done.clone()
    torch.cuda.synchronize()
    start = time.perf_counter()
    carry, traj = env.rollout(BIPEDAL_ROLLOUT)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    check(traj.obs.shape == (BIPEDAL_ROLLOUT, n, 24), f"{label} rollout obs shape {tuple(traj.obs.shape)}")
    check(bool(torch.isfinite(traj.obs).all() and torch.isfinite(traj.reward).all()), f"{label} rollout not finite")
    lidar, legs = traj.obs[..., 14:], traj.obs[..., [8, 13]]
    check(bool(((lidar > 0.0) & (lidar <= 1.0)).all()), f"{label}: a lidar reading outside (0, 1]")
    check(bool(((legs == 0.0) | (legs == 1.0)).all()), f"{label}: a leg contact flag not 0 or 1")
    check(carry.state["done"].dtype == torch.bool, f"{label} done is not bool after the rollout")
    ended = traj.terminated
    check(bool(ended.any()), f"no {label} lane crashed in the rollout")
    crashed = int((traj.reward[ended] == -100.0).sum())
    check(crashed > 0, f"no {label} termination was a crash")
    reset = done0 | (traj.terminated[:-1] | traj.truncated[:-1]).any(dim=0)
    changed = (carry.state["terrain"] != terrain0).any(dim=1)
    check(torch.equal(changed, reset), f"{label}: terrain changed on a lane that did not reset, or kept on one that did")
    print(f"{label} rollout: {int(ended.sum())} terminations ({crashed} crashed), "
          f"{int(reset.sum())} of {n} lanes reset", flush=True)
    return {"env_steps_per_s": n * BIPEDAL_ROLLOUT / seconds, "terminations": int(ended.sum()),
            "crashes": crashed, "rollout_steps": BIPEDAL_ROLLOUT, "envs": n}


def terrain_draws(n: int, dev, seed: int = 0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.uniform(lo, 1.0, (n, 200)).astype(np.float32)).to(dev) for lo in (-1.0, 0.0))


def compare_terrain_with_twin(n: int, dev) -> dict:
    """The terrain kernel against its twin on the card, normal and hardcore,
    at ``n`` envs. Raises on any differing bit, or unless every obstacle
    kind occurs. Returns the largest deviation (0)."""
    from gymnasium_tpu_torch.ops.walker_terrain import WINDOWS, walker_terrain, walker_terrain_reference

    u, d = terrain_draws(n, dev)
    err = 0.0
    for draws in (None, d):
        out, again = walker_terrain(u, draws), walker_terrain(u, draws)
        torch.cuda.synchronize()
        ref = walker_terrain_reference(u, draws)
        check(bool(torch.isfinite(out).all()), "walker_terrain: kernel heights not finite")
        check(torch.equal(out.view(torch.int32), again.view(torch.int32)), "walker_terrain: same input, different bits")
        err = max(err, float((out - ref).abs().max()))
        check(torch.equal(out.view(torch.int32), ref.view(torch.int32)),
              f"walker_terrain (hardcore={draws is not None}, N={n}): kernel and twin differ by up to {err}")
    kinds = d[:, list(WINDOWS)]
    check(bool((kinds < 0.33).any() and ((kinds >= 0.33) & (kinds < 0.66)).any() and (kinds >= 0.66).any()),
          "walker_terrain: an obstacle kind never occurs")
    return {"max_abs_err": err, "bit_equal": True, "envs": n}


def terrain_bound_ms(n: int, hardcore: bool) -> tuple[float, str]:
    """Each env reads its 200 steps (and 22 obstacle draws) and writes 200
    heights once, and runs the walk's float operations (and the overlay's)."""
    bytes_moved = n * 4 * (400 + (22 if hardcore else 0))
    ops = TERRAIN_WALK_OPS + (TERRAIN_OVERLAY_OPS if hardcore else 0)
    return bound(bytes_moved, n * ops / FP32_OPS_PER_S)


def teacher_forced_with_cpu(dev, func, n: int, actions, limit: int | None, wrappers=lambda: ()):
    """``len(actions)`` steps of ``func`` at ``n`` envs under ``TorchVectorEnv``
    (step limit ``limit``, the stack ``wrappers()``) on the CPU, its draws
    recorded; the card takes each step from the CPU's carry, with the same
    draws and action. Returns both sides' outputs on the CPU: the reset's
    ``(obs, state)``, then each step's ``(obs, reward, terminated,
    truncated, steps, state)``."""
    from gymnasium_tpu_torch.functional import tree_map
    from gymnasium_tpu_torch.vector import TorchVectorEnv

    drawn = collections.deque()

    def record(hook, draw, rng, count):
        drawn.append(draw(rng, count))
        return drawn[-1]

    def replay(hook, draw, rng, count):
        return tuple(None if x is None else x.to(dev) for x in drawn.popleft())

    cpu_env = TorchVectorEnv(with_draws(func, record), n, max_episode_steps=limit, device="cpu", wrappers=wrappers())
    card_env = TorchVectorEnv(with_draws(func, replay), n, max_episode_steps=limit, device=dev, wrappers=wrappers())

    def env_state(env):
        return (env.carry.env if env.wrappers else env.carry).state

    def host(x):
        return tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t, x)

    cpu_obs, _ = cpu_env.reset(seed=0)
    card_obs, _ = card_env.reset(seed=0)
    cpu, card = [(cpu_obs, env_state(cpu_env))], [host((card_obs, env_state(card_env)))]
    for action in actions:
        card_env.carry = move_carry(cpu_env.carry, card_env.carry, dev)
        obs, reward, term, trunc, _ = cpu_env.step(action)
        carry = cpu_env.carry.env if cpu_env.wrappers else cpu_env.carry
        cpu.append((obs, reward, term, trunc, carry.steps, carry.state))
        obs, reward, term, trunc, _ = card_env.step(action.to(dev))
        carry = card_env.carry.env if card_env.wrappers else card_env.carry
        card.append(host((obs, reward, term, trunc, carry.steps, carry.state)))
    check(not drawn, "the card took fewer draws than the CPU")
    return cpu, card


def walker_branch_lanes(card_step, cpu_step, walker_obs=lambda obs: obs) -> torch.Tensor:
    """Lanes of one walker step where the card and the CPU took a different
    side of a threshold: a contact that carries an impulse on one side only,
    a lidar reading or leg flag, termination. ``walker_obs`` takes the
    walker's (N, 24) observation out of a wrapped one."""
    (obs_c, *_, state_c), (obs_p, *_, state_p) = card_step, cpu_step
    contact = ((state_c["cimp"][..., 0] > 0) != (state_p["cimp"][..., 0] > 0)).any(dim=1)
    flags = [8, 13, *range(14, 24)]
    discrete = (walker_obs(obs_c)[:, flags] != walker_obs(obs_p)[:, flags]).any(dim=1)
    ended = card_step[2] != cpu_step[2] if len(card_step) > 2 else torch.zeros_like(contact)
    return contact | discrete | ended


def compare_bipedal_with_cpu(dev, hardcore: bool, n: int = NUM_ENVS, steps: int = BIPEDAL_CHECK_STEPS,
                             wrappers=lambda: (), walker_obs=lambda obs: obs) -> dict:
    """The walker's steps on the card against the CPU's (teacher-forced,
    :func:`teacher_forced_with_cpu`; step limit ``BIPEDAL_CHECK_LIMIT``).
    Flags and step counters equal on every lane but the branch lanes
    (:func:`walker_branch_lanes`), at most ``BIPEDAL_BRANCH_SHARE`` of them a
    step; every float within ``BIPEDAL_CHECK_TOL * (1 + |cpu|)`` elsewhere.
    With ``wrappers``, the observations are the wrapped ones and
    ``walker_obs`` takes the walker's own out of them. Returns the largest
    deviation off the branch lanes and the branch lanes a step."""
    from gymnasium_tpu_torch.functional import tree_map

    func = walker_env(hardcore)
    gen = torch.Generator().manual_seed(2)
    space = func.action_space
    actions = [space.sample_torch(gen, (n,)) for _ in range(steps)]
    cpu, card = teacher_forced_with_cpu(dev, func, n, actions, BIPEDAL_CHECK_LIMIT, wrappers)
    label = "bipedal_walker_hardcore" if hardcore else "bipedal_walker"
    worst, branch_counts = [0.0], []
    for k, (c, p) in enumerate(zip(card, cpu)):
        branch = walker_branch_lanes(c, p, walker_obs)
        branch_counts.append(int(branch.sum()))
        check(branch_counts[-1] <= BIPEDAL_BRANCH_SHARE * n,
              f"{label} card vs cpu step {k}: {branch_counts[-1]} lanes took another side of a threshold")
        keep = ~branch
        # every leaf of a step has the lane axis first
        tree_map(agree_within(f"{label} step {k}", BIPEDAL_CHECK_TOL, worst),
                 tree_map(lambda x: x[keep], c), tree_map(lambda x: x[keep], p))
    ends = sum(int((step[2] | step[3]).sum()) for step in cpu[1:])
    check(ends > 0, f"{label} card vs cpu: no episode ended")
    return {"max_abs_dev": max(worst), "tolerance": BIPEDAL_CHECK_TOL, "branch_lanes_a_step": branch_counts,
            "episode_ends": ends, "envs": n, "steps": steps}


def replayed_sticky_action(p: float, drawn: collections.deque, dev=None):
    """A StickyAction whose repeat draws the CPU run records into ``drawn``
    (``dev`` None) and the card run on ``dev`` replays: the two generators
    draw different numbers."""
    from gymnasium_tpu_torch.wrappers.func import StickyAction

    class Replayed(StickyAction):
        def draws(self, wstate, n):
            if dev is None:
                drawn.append(super().draws(wstate, n))
                return drawn[-1]
            return drawn.popleft().to(dev)

    return Replayed(p)


def compare_wrappers_with_cpu(dev, n: int = WRAPPER_CHECK_ENVS, steps: int = WRAPPER_CHECK_STEPS) -> dict:
    """The new functional wrappers on the card against the CPU (teacher-forced):
    the walker through ClipAction, TimeAwareObservation and
    FrameStackObservation(4); MountainCar through StickyAction (replayed
    draws), DelayObservation, TransformObservation, TransformReward and
    ClipReward;
    Pendulum through RescaleAction, TransformAction, RescaleObservation and
    TimeAwareObservation (normalised)."""
    from gymnasium_tpu_torch.wrappers import func as w
    from gymnasium_tpu_torch.envs.phys2d import MountainCarFunctional, PendulumFunctional
    from gymnasium_tpu_torch.functional import tree_map

    result = {}
    walker_stack = lambda: (w.ClipAction(-1.0, 1.0), w.TimeAwareObservation(), w.FrameStackObservation(4))  # noqa: E731
    # the last of the four frames is the step's observation, the time appended
    result["bipedal_walker"] = compare_bipedal_with_cpu(dev, False, n, steps, walker_stack, lambda o: o[:, -1, :24])
    result["bipedal_walker"]["wrappers"] = ["ClipAction", "TimeAwareObservation", "FrameStackObservation(4)"]

    drawn = collections.deque()
    sides = iter((None, dev))
    car_stack = lambda: (replayed_sticky_action(0.25, drawn, next(sides)), w.DelayObservation(2),  # noqa: E731
                         w.TransformObservation(lambda o: o * 2.0), w.TransformReward(lambda r: r * 0.5),
                         w.ClipReward(-0.25, 0.0))
    low, high = np.array([-1.0, -1.0, -8.0], np.float32), np.array([1.0, 1.0, 8.0], np.float32)
    pend_stack = lambda: (w.RescaleAction(-2.0, 2.0), w.TransformAction(lambda a: a * 0.75),  # noqa: E731
                          w.RescaleObservation(low, high), w.TimeAwareObservation(True, CLASSIC_CHECK_LIMIT))
    for name, func, stack in (("mountaincar", MountainCarFunctional(), car_stack),
                              ("pendulum", PendulumFunctional(), pend_stack)):
        gen = torch.Generator().manual_seed(3)
        actions = [func.action_space.sample_torch(gen, (n,)) for _ in range(steps)]
        cpu, card = teacher_forced_with_cpu(dev, func, n, actions, CLASSIC_CHECK_LIMIT, stack)
        worst = []
        tree_map(agree_within(f"{name} wrapped", 1e-5, worst), card, cpu)
        result[name] = {"max_abs_dev": max(worst), "tolerance": 1e-5, "envs": n, "steps": steps}
    check(not drawn, "the card took fewer StickyAction draws than the CPU")
    return result


def step_limit(env_id: str) -> int | None:
    """The step limit the port's registry holds for ``env_id``."""
    import gymnasium_tpu_torch as gym

    return gym.spec(env_id).max_episode_steps


def registered_func(env_id: str):
    """A new instance of the functional env that ``env_id``'s spec names
    (``torch_entry_point``), with the spec's options."""
    import gymnasium_tpu_torch as gym
    from gymnasium_tpu_torch.envs.registration import load_env_creator

    spec = gym.spec(env_id)
    return load_env_creator(spec.torch_entry_point)(dict(spec.kwargs) or None)


def classic_env(name: str):
    """A new instance of the functional env ``name`` of :data:`CLASSIC_ENVS`."""
    return registered_func(CLASSIC_ENVS[name][0])


def inside(space, x: torch.Tensor) -> bool:
    """Whether every element of a batch lies in the single-env ``space``."""
    if hasattr(space, "n"):
        return bool(space.contains_torch(x).all())
    return bool(space.contains_torch(x))


def longest_episode(steps0, prev_done0, done) -> int:
    """The most steps any episode reached over a trajectory's (T, N) done
    flags, from the step counters and done flags before it: the step counter
    of ``make_autoreset_step``, replayed."""
    run, prev, longest = steps0.clone(), prev_done0, steps0.clone()
    for flags in done:
        run = torch.where(prev, 0, run + 1)
        longest = torch.maximum(longest, run)
        prev = flags
    return int(longest.max())


def check_classic_episodes(name: str, env, traj, longest: int) -> None:
    """Each env's episodes end where they must, read from the trajectory."""
    obs, term, trunc, reward = traj.obs, traj.terminated, traj.truncated, traj.reward
    func, limit = env.func_env, env.time_limit
    check(not bool((term & trunc).any()), f"{name}: a step both terminated and truncated")
    check(limit is None or longest <= limit, f"{name}: an episode ran {longest} steps, past {limit}")
    check(limit is not None or not bool(trunc.any()), f"{name}: truncated without a step limit")
    if name == "frozenlake8x8":
        ends = torch.from_numpy(np.isin(func.desc.ravel(), [b"G", b"H"])).to(obs.device)
        check(torch.equal(term, ends[obs.long()]), "frozenlake8x8: terminated is not 'on a hole or the goal'")
    elif name == "taxi_v3":
        check(torch.equal(term, reward == 20.0), "taxi_v3: terminated is not 'dropped off, +20'")
    elif name == "cliffwalking_v1":
        check(torch.equal(term, obs == 47), "cliffwalking_v1: terminated is not 'at the goal'")
        check(bool(((reward == -1) | (reward == -100) | (reward == 0)).all()), "cliffwalking_v1: reward")
    elif name == "pendulum_v1":
        check(not bool(term.any()) and bool(trunc.any()), "pendulum_v1: terminated, or never truncated")
    elif name.startswith("mountaincar"):
        goal = func.get_default_params().goal_position
        check(torch.equal(term, (obs[..., 0] >= goal) & (obs[..., 1] >= 0)), f"{name}: terminated is not the goal")
        if name == "mountaincar_continuous_v0":
            check(bool(((reward[term] >= 99.9) & (reward[term] <= 100.0)).all()), f"{name}: goal reward")
    elif name == "acrobot_v1":
        c1, s1, c2, s2 = obs[..., 0], obs[..., 1], obs[..., 2], obs[..., 3]
        height = -c1 - (c1 * c2 - s1 * s2)
        away = (height - 1.0).abs() > ACROBOT_BAND
        check(torch.equal(term[away], (height > 1.0)[away]), "acrobot_v1: terminated is not 'above the bar'")
        check(bool((reward[term] == 0).all() and ((reward == 0) | (reward == -1)).all()), "acrobot_v1: reward")
    elif name == "blackjack_v1":
        check(longest <= BLACKJACK_MAX_STEPS, f"blackjack_v1: a hand lasted {longest} steps")
        check(bool(((reward == -1) | (reward == 0) | (reward == 1)).all()), "blackjack_v1: reward")
    elif name == "cpd_random":
        check(torch.equal(term, obs[..., 3] >= 1.0), "cpd_random: terminated is not round == max_rounds")
        check(longest <= func.max_rounds, f"cpd_random: a game ran {longest} rounds")


def run_classic(dev, name: str, n: int = NUM_ENVS) -> dict:
    """A cheap functional under ``TorchVectorEnv``: reset, a few sampled steps,
    a masked reset of every other lane, then its rollout. Checks that every
    output is finite and inside its space and that episodes end where they
    must. Returns the rollout's host-clock env-steps/s and the episode ends
    seen."""
    from gymnasium_tpu_torch.functional import tree_map
    from gymnasium_tpu_torch.vector import TorchVectorEnv

    env_id, rollout = CLASSIC_ENVS[name]
    env = TorchVectorEnv(classic_env(name), n, max_episode_steps=step_limit(env_id), device=dev)
    obs, _ = env.reset(seed=0)
    check(inside(env.single_observation_space, obs), f"{name}: reset obs outside the observation space")
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(CLASSIC_WARM_STEPS):
        obs, reward, term, trunc, _ = env.step(env.single_action_space.sample_torch(gen, (n,)))
    check(bool(torch.isfinite(obs.float()).all() and torch.isfinite(reward).all()), f"{name}: step not finite")

    mask = np.zeros(n, np.bool_)
    mask[::2] = True
    keep = torch.from_numpy(~mask).to(dev)
    before = tree_map(torch.clone, env.carry.state)
    mobs, _ = env.reset(options={"reset_mask": mask})
    moved = []
    tree_map(lambda a, b: moved.append(not torch.equal(a[keep], b[keep])), env.carry.state, before)
    check(not any(moved), f"{name}: masked reset moved kept lanes")
    check(torch.equal(mobs[keep], obs[keep]), f"{name}: masked reset changed kept lanes' obs")
    check(not bool(env.carry.steps[~keep].any()), f"{name}: masked reset left step counters")

    steps0, done0 = env.carry.steps.clone(), env.carry.prev_done.clone()
    torch.cuda.synchronize()
    start = time.perf_counter()
    carry, traj = env.rollout(rollout)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    check(traj.obs.shape == (rollout, n) + env.single_observation_space.shape,
          f"{name}: obs shape {tuple(traj.obs.shape)}")
    check(bool(torch.isfinite(traj.obs.float()).all() and torch.isfinite(traj.reward).all()),
          f"{name}: rollout not finite")
    check(inside(env.single_observation_space, traj.obs), f"{name}: rollout obs outside the observation space")
    done = traj.terminated | traj.truncated
    check(torch.equal(traj.reward[1:][done[:-1]], torch.zeros_like(traj.reward[1:][done[:-1]])),
          f"{name}: reward is not 0 on the step after a done")
    longest = longest_episode(steps0, done0, done)
    check_classic_episodes(name, env, traj, longest)
    return {"env_steps_per_s": n * rollout / seconds, "rollout_steps": rollout,
            "terminations": int(traj.terminated.sum()), "truncations": int(traj.truncated.sum()),
            "longest_episode": longest}


def with_draws(func, source):
    """A shallow copy of the functional env ``func`` whose ``reset_draws`` and
    ``transition_draws`` (those it has) return ``source(hook, draw, rng, n)``,
    ``draw`` being ``func``'s own."""
    env = copy.copy(func)
    for hook in ("reset_draws", "transition_draws"):
        if hasattr(func, hook):
            setattr(env, hook, functools.partial(source, hook, getattr(func, hook)))
    return env


def cpu_and_card_traces(dev, func, n: int, actions, limit: int | None, extra=lambda env: (), wrap=None):
    """``len(actions)`` steps of ``func`` at ``n`` envs under ``TorchVectorEnv``
    (step limit ``limit``) on the CPU with its draws recorded, then on
    ``dev`` with the same draws and actions. Returns both traces, on the
    CPU: the reset's ``(obs, state, *extra(env))``, then each step's
    ``(obs, reward, terminated, truncated, steps, state, *extra(env))``.
    With ``wrap``, the resets and steps go through ``wrap(env)`` (vector
    wrappers), whose outputs the trace holds; ``extra`` still reads the
    ``TorchVectorEnv``. Raises if the card took fewer draws than the CPU."""
    from gymnasium_tpu_torch.functional import tree_map
    from gymnasium_tpu_torch.vector import TorchVectorEnv

    recorded = {"reset_draws": [], "transition_draws": []}

    def record(hook, draw, rng, count):
        recorded[hook].append(draw(rng, count))
        return recorded[hook][-1]

    def replay(hook, draw, rng, count):
        return tuple(None if x is None else x.to(dev) for x in next(replays[hook]))

    def run(source, device):
        env = TorchVectorEnv(with_draws(func, source), n, max_episode_steps=limit, device=device)
        outer = wrap(env) if wrap else env
        obs, _ = outer.reset(seed=0)
        trace = [(obs, env.carry.state, *extra(env))]
        for action in actions:
            obs, reward, term, trunc, _ = outer.step(action.to(device))
            trace.append((obs, reward, term, trunc, env.carry.steps, env.carry.state, *extra(env)))
        return tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, trace)

    cpu = run(record, "cpu")
    replays = {hook: iter(draws) for hook, draws in recorded.items()}
    card = run(replay, dev)
    check(all(next(it, None) is None for it in replays.values()), "the card took fewer draws than the CPU")
    return cpu, card


def agree_within(label: str, tol: float | None, worst: list):
    """``agree(got, want)``: raises unless dtypes and shapes match and the
    values are equal (integers, bools, or every value with ``tol`` None) or
    within ``tol * (1 + |want|)``; appends the largest deviation to ``worst``."""

    def agree(got, want):
        check(got.dtype == want.dtype and got.shape == want.shape, f"{label} card vs cpu: {got.dtype} vs {want.dtype}")
        if tol is None or not want.is_floating_point():
            check(torch.equal(got, want), f"{label} card vs cpu: {want.dtype} values differ")
            worst.append(float((got.double() - want.double()).abs().max()) if want.numel() else 0.0)
            return
        err = (got.double() - want.double()).abs()
        check(bool((err <= tol * (1.0 + want.double().abs())).all()), f"{label} card vs cpu: differ by {float(err.max())}")
        worst.append(float(err.max()))

    return agree


def compare_classic_with_cpu(dev, name: str, n: int = NUM_ENVS, steps: int = CLASSIC_CHECK_STEPS) -> dict:
    """``steps`` steps of the env ``name`` at ``n`` envs under ``TorchVectorEnv``
    (step limit ``CLASSIC_CHECK_LIMIT``) on the CPU with its draws recorded,
    then on ``dev`` with the same draws and actions. Raises unless flags,
    step counters and integer leaves are equal and every float output and
    state leaf agrees within ``CLASSIC_CHECK_TOL`` (equality where it has no
    entry). Returns the largest absolute deviation and the episode ends."""
    from gymnasium_tpu_torch.functional import tree_map

    func = classic_env(name)
    gen = torch.Generator().manual_seed(2)
    actions = [func.action_space.sample_torch(gen, (n,)) for _ in range(steps)]
    cpu, card = cpu_and_card_traces(dev, func, n, actions, CLASSIC_CHECK_LIMIT)
    tol, worst = CLASSIC_CHECK_TOL.get(name), []
    tree_map(agree_within(name, tol, worst), card, cpu)
    ends = sum(int((step[2] | step[3]).sum()) for step in cpu[1:])
    check(ends > 0, f"{name} card vs cpu: no episode ended")
    return {"max_abs_dev": max(worst), "tolerance": tol, "episode_ends": ends}


def car_racing_env(continuous: bool = True):
    from gymnasium_tpu_torch.envs.box2d import CarRacingFunctional

    return CarRacingFunctional({"continuous": continuous})


def palette_pixels(obs) -> bool:
    """Whether every pixel of the uint8 frames ``obs`` (..., 96, 96, 3) is one
    of the palette's six colours, checked 4096 frames at a time."""
    from gymnasium_tpu_torch.envs.box2d.car_racing_functional import PALETTE

    codes = torch.as_tensor((PALETTE.astype(np.int64) * [65536, 256, 1]).sum(-1), device=obs.device)
    frames = obs.reshape(-1, *obs.shape[-3:])
    for lo in range(0, frames.shape[0], 4096):
        chunk = frames[lo : lo + 4096].to(torch.int64)
        packed = chunk[..., 0] * 65536 + chunk[..., 1] * 256 + chunk[..., 2]
        if not bool(torch.isin(packed, codes).all()):
            return False
    return True


def check_car_racing_episodes(label: str, traj, steps0, done0, limit: int) -> int:
    """Episodes end where the env says, read from a trajectory that starts at
    step counters ``steps0`` with done flags ``done0``: a step after a done
    pays 0; every other step pays -0.1 plus 10/3 a new tile (a car's four
    wheels mark at most four), or -100 where the car left the field, and
    it terminates exactly there (no lap of 285 tiles fits a rollout this
    short); none both terminates and truncates, and none runs past the
    step limit. Returns the longest episode."""
    reward, term, trunc = traj.reward, traj.terminated, traj.truncated
    done = term | trunc
    after = torch.cat([done0[None], done[:-1]])
    check(bool(torch.isfinite(reward).all()), f"{label}: reward not finite")
    check(not bool((term & trunc).any()), f"{label}: a step both terminated and truncated")
    check(bool((reward[after] == 0).all()), f"{label}: reward is not 0 on the step after a done")
    off = reward == -100.0
    check(torch.equal(term & ~after, off & ~after), f"{label}: terminated is not 'left the field, -100'")
    tiles = (reward + 0.1) * 0.3
    paid = ~after & ~off
    check(bool(((tiles[paid] - tiles[paid].round()).abs() < 1e-4).all() and (tiles[paid].round() >= 0).all()
               and (tiles[paid].round() <= 4).all()), f"{label}: a step paid other than -0.1 + 10/3 a tile")
    longest = longest_episode(steps0, done0, done)
    check(longest <= limit, f"{label}: an episode ran {longest} steps, past {limit}")
    return longest


def run_car_racing(dev, n: int = CAR_ENVS, continuous: bool = True) -> dict:
    """CarRacing-v3 under ``TorchVectorEnv`` (step limit ``CAR_TIME_LIMIT``).
    Continuous: reset, a few sampled steps, a masked reset of every other
    lane, then ``rollout(CAR_ROLLOUT)`` (``bench.py``'s row); discrete:
    reset, then ``rollout(CAR_DISCRETE_ROLLOUT)``. Checks that every frame
    is uint8 in the palette and that episodes end where the env says.
    Returns the rollout's host-clock env-steps/s and what the episodes did."""
    from gymnasium_tpu_torch.functional import tree_map
    from gymnasium_tpu_torch.vector import TorchVectorEnv

    label = "carracing_v3" if continuous else "carracing_v3_discrete"
    func = car_racing_env(continuous)
    env = TorchVectorEnv(func, n, max_episode_steps=CAR_TIME_LIMIT, device=dev)
    obs, _ = env.reset(seed=0)
    check(obs.dtype == torch.uint8 and obs.shape == (n, 96, 96, 3), f"{label}: reset obs {obs.dtype} {tuple(obs.shape)}")
    check(palette_pixels(obs), f"{label}: a reset pixel is not a palette colour")
    if continuous:
        gen = torch.Generator(device=dev).manual_seed(1)
        for _ in range(CAR_WARM_STEPS):
            obs, reward, term, trunc, _ = env.step(env.single_action_space.sample_torch(gen, (n,)))
        check(bool(torch.isfinite(reward).all()), f"{label}: step reward not finite")
        mask = np.zeros(n, np.bool_)
        mask[::2] = True
        keep = torch.from_numpy(~mask).to(dev)
        before = tree_map(torch.clone, env.carry.state)
        mobs, _ = env.reset(options={"reset_mask": mask})
        moved = []
        tree_map(lambda a, b: moved.append(not torch.equal(a[keep], b[keep])), env.carry.state, before)
        check(not any(moved), f"{label}: masked reset moved kept lanes")
        check(torch.equal(mobs[keep], obs[keep]), f"{label}: masked reset changed kept lanes' obs")
        check(not bool(env.carry.steps[~keep].any()), f"{label}: masked reset left step counters")
        check(not bool(env.carry.state["visited"][~keep].any()), f"{label}: masked reset left visits")

    steps0, done0 = env.carry.steps.clone(), env.carry.prev_done.clone()
    rollout = CAR_ROLLOUT if continuous else CAR_DISCRETE_ROLLOUT
    torch.cuda.synchronize()
    start = time.perf_counter()
    carry, traj = env.rollout(rollout)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    check(traj.obs.dtype == torch.uint8 and traj.obs.shape == (rollout, n, 96, 96, 3),
          f"{label}: obs {traj.obs.dtype} {tuple(traj.obs.shape)}")
    check(palette_pixels(traj.obs), f"{label}: a pixel is not a palette colour")
    longest = check_car_racing_episodes(label, traj, steps0, done0, CAR_TIME_LIMIT)
    visited = carry.state["visited"].sum(dim=1).float()
    check(float(visited.mean()) > 1.0, f"{label}: the cars visited no tile")
    return {"env_steps_per_s": n * rollout / seconds, "envs": n, "rollout_steps": rollout,
            "terminations": int(traj.terminated.sum()), "truncations": int(traj.truncated.sum()),
            "longest_episode": longest, "mean_tiles_visited": float(visited.mean()),
            "paid_tiles": int((traj.reward > 1.0).sum())}


def compare_car_racing_with_cpu(dev, n: int = CAR_CHECK_ENVS, steps: int = CAR_CHECK_STEPS) -> dict:
    """``steps`` continuous CarRacing steps at ``n`` envs (step limit
    ``CAR_CHECK_LIMIT``) on the CPU and on ``dev`` with the same draws and
    actions. Raises unless visits, flags and step counters are equal, the
    hull, wheels, steering, rewards and tile centres agree within
    ``CAR_CHECK_TOL * (1 + |cpu|)``, the headings within what the centres'
    tolerance subtends over the gap to the next tile, and the road mask and
    the frames are equal but at the CPU state's edge pixels
    (``CarRacingFunctional.edge_pixels``). Returns the deviations and the
    edge pixels' share."""
    func = car_racing_env()
    gen = torch.Generator().manual_seed(2)
    actions = [func.action_space.sample_torch(gen, (n,)) for _ in range(steps)]
    cpu, card = cpu_and_card_traces(dev, func, n, actions, CAR_CHECK_LIMIT,
                                    extra=lambda env: (env.func_env.road_mask(env.carry.state),))
    worst, edge_share, differ, road_differ = [], 0.0, 0, 0
    for got, want in zip(card, cpu):
        state, cstate = got[-2], want[-2]
        edge = func.edge_pixels(cstate)
        edge_share = max(edge_share, float(edge.float().mean()))
        frames = (got[0] != want[0]).any(-1)
        road = got[-1] != want[-1]
        check(not bool((frames & ~edge).any()), f"carracing card vs cpu: {int((frames & ~edge).sum())} pixels differ")
        check(not bool((road & ~edge).any()), f"carracing card vs cpu: the road mask differs at {int((road & ~edge).sum())}")
        differ, road_differ = differ + int(frames.sum()), road_differ + int(road.sum())
        agree = agree_within("carracing", CAR_CHECK_TOL, worst)
        for key in ("hull", "steer_angle", "wheel_omega", "r", "centers", "visited", "done"):
            agree(state[key], cstate[key])
        gap = (torch.roll(cstate["centers"], -1, dims=1) - cstate["centers"]).norm(dim=-1)
        turn = torch.remainder(state["betas"].double() - cstate["betas"].double() + np.pi, 2 * np.pi) - np.pi
        check(bool((turn.abs() <= 2e-4 / gap).all()), f"carracing card vs cpu: headings differ by {float(turn.abs().max())}")
        for i in range(1, len(want) - 2):  # reward, flags, step counters
            agree(got[i], want[i])
    ends = sum(int((step[2] | step[3]).sum()) for step in cpu[1:])
    check(ends > 0, "carracing card vs cpu: no episode ended")
    return {"max_abs_dev": max(worst), "tolerance": CAR_CHECK_TOL, "episode_ends": ends,
            "max_edge_pixel_share": edge_share, "differing_pixels": differ, "differing_road_pixels": road_differ}


def run_swimmer(dev, n: int = NUM_ENVS) -> dict:
    """Swimmer-v5 under ``TorchVectorEnv`` (step limit ``ART_TIME_LIMIT``):
    reset, then ``rollout(SWIMMER_ROLLOUT)``. Returns the rollout's
    host-clock env-steps/s."""
    from gymnasium_tpu_torch.envs.mujoco import SwimmerFunctional
    from gymnasium_tpu_torch.vector import TorchVectorEnv

    env = TorchVectorEnv(SwimmerFunctional(), n, max_episode_steps=ART_TIME_LIMIT, device=dev)
    env.reset(seed=0)
    x0 = env.carry.state["qpos"][:, 0].clone()
    torch.cuda.synchronize()
    start = time.perf_counter()
    carry, traj = env.rollout(SWIMMER_ROLLOUT)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    check(traj.obs.shape == (SWIMMER_ROLLOUT, n, 8), f"swimmer obs shape {tuple(traj.obs.shape)}")
    check(bool(torch.isfinite(traj.obs).all() and torch.isfinite(traj.reward).all()), "swimmer rollout not finite")
    check(not bool(traj.terminated.any()), "a swimmer lane terminated")
    moved = float((carry.state["qpos"][:, 0] - x0).abs().mean())
    check(moved > 1e-3, f"swimmer qpos[:, 0] did not move (mean |dx| {moved})")
    return {"env_steps_per_s": n * SWIMMER_ROLLOUT / seconds, "rollout_steps": SWIMMER_ROLLOUT,
            "mean_abs_dx": moved}


def compare_swimmer_with_cpu(dev, n: int = NUM_ENVS, steps: int = SWIMMER_CHECK_STEPS) -> dict:
    """``steps`` Swimmer steps at ``n`` envs (step limit ``SWIMMER_CHECK_LIMIT``)
    on the CPU (the articulated twin) and on ``dev`` (the kernel) with the
    same draws and actions. Raises unless flags and step counters are equal
    and every float output and state leaf agrees within
    ``SWIMMER_CHECK_TOL * (1 + |cpu|)``."""
    from gymnasium_tpu_torch.envs.mujoco import SwimmerFunctional
    from gymnasium_tpu_torch.functional import tree_map

    func = SwimmerFunctional()
    gen = torch.Generator().manual_seed(2)
    actions = [func.action_space.sample_torch(gen, (n,)) for _ in range(steps)]
    cpu, card = cpu_and_card_traces(dev, func, n, actions, SWIMMER_CHECK_LIMIT)
    worst = []
    tree_map(agree_within("swimmer", SWIMMER_CHECK_TOL, worst), card, cpu)
    ends = sum(int((step[2] | step[3]).sum()) for step in cpu[1:])
    check(ends > 0, "swimmer card vs cpu: no episode ended")
    return {"max_abs_dev": max(worst), "tolerance": SWIMMER_CHECK_TOL, "episode_ends": ends}


def mjcf_env(path: str):
    """A ``MujocoFuncEnv`` over the MJCF file ``path`` at ``MJCF_FRAME_SKIP``,
    paid for its root's forward velocity less 0.1 times the squared action."""
    from gymnasium_tpu_torch.envs.mujoco.locomotion import MujocoFuncEnv
    from gymnasium_tpu_torch.spaces import Box

    class MjcfFunctional(MujocoFuncEnv):
        model_name = path
        frame_skip = MJCF_FRAME_SKIP

        def __init__(self):
            super().__init__()
            self.observation_space = Box(-np.inf, np.inf, (self.model.nq - 1 + self.model.nv,), np.float32)

        def reward(self, state, action, next_state, rng, params=None):
            x_velocity = (next_state["qpos"][:, 0] - next_state["prev_x"]) / self.dt
            return x_velocity - 0.1 * torch.sum(torch.square(action), dim=-1)

    return MjcfFunctional()


def run_mjcf(dev, path: str, n: int = NUM_ENVS) -> dict:
    """A ``MujocoFuncEnv`` over the compiled MJCF file under ``TorchVectorEnv``:
    reset, then ``rollout(MJCF_ROLLOUT)``, one launch of the model's
    generated kernel an env step. Returns the rollout's host-clock
    env-steps/s and how many lanes' foot touched the floor."""
    from gymnasium_tpu_torch.vector import TorchVectorEnv

    func = mjcf_env(path)
    env = TorchVectorEnv(func, n, max_episode_steps=ART_TIME_LIMIT, device=dev)
    env.reset(seed=0)
    torch.cuda.synchronize()
    start = time.perf_counter()
    carry, traj = env.rollout(MJCF_ROLLOUT)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    check(traj.obs.shape == (MJCF_ROLLOUT, n, func.observation_space.shape[0]), f"mjcf obs {tuple(traj.obs.shape)}")
    check(bool(torch.isfinite(traj.obs).all() and torch.isfinite(traj.reward).all()), "mjcf rollout not finite")
    foot = func._dyn["contact_points"](carry.state["qpos"])[:, 0, 2]
    touching = int((foot < float(func.model.contact_radius[0]) + func.model.ground_z).sum())
    return {"env_steps_per_s": n * MJCF_ROLLOUT / seconds, "rollout_steps": MJCF_ROLLOUT,
            "kernel": func._step.build_name, "lanes_on_the_floor": touching}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtypes, shapes and bytes (so -0.0 differs from 0.0)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def hand_built(env_id: str):
    """The functional env of a :data:`REGISTRY_IDS` path built by hand, not
    through the registry."""
    from gymnasium_tpu_torch.envs.box2d import BipedalWalkerFunctional
    from gymnasium_tpu_torch.envs.box2d.lunar_lander import LunarLanderFunctional
    from gymnasium_tpu_torch.envs.mujoco import HalfCheetahFunctional
    from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional

    return {"CartPole-v1": CartPoleFunctional, "HalfCheetah-v5": HalfCheetahFunctional,
            "LunarLander-v3": LunarLanderFunctional,
            "BipedalWalkerHardcore-v3": lambda: BipedalWalkerFunctional({"hardcore": True})}[env_id]()


def run_registry_vec(dev, env_id: str, n: int = NUM_ENVS) -> dict:
    """``gymnasium_tpu_torch.make_vec(env_id, num_envs=n)`` with no mode and
    no device: reset, :data:`REGISTRY_WARM_STEPS` sampled steps, then
    ``rollout(REGISTRY_ROLLOUT)``. Checks the mode (``torch``), the device,
    the step limit against the spec's and :data:`REGISTRY_LIMITS`, the
    outputs, and that ``make_vec(envs.spec)`` rebuilds the same env. Returns
    the wall times, the actions and the first steps' outputs (for
    :func:`compare_registry_with_hand_built`)."""
    import gymnasium_tpu_torch as gym
    from gymnasium_tpu_torch.vector import TorchVectorEnv

    start = time.perf_counter()
    env = gym.make_vec(env_id, num_envs=n)
    make_s = time.perf_counter() - start
    mode = env.spec.kwargs.get("vectorization_mode")
    check(isinstance(env, TorchVectorEnv) and mode == "torch", f"{env_id}: make_vec gave {type(env).__name__}, {mode}")
    check(env.device.type == torch.device(dev).type and env.num_envs == n,
          f"{env_id}: on {env.device} with {env.num_envs} envs")
    limit = gym.spec(env_id).max_episode_steps
    check(env.time_limit == limit == REGISTRY_LIMITS[env_id],
          f"{env_id}: time_limit {env.time_limit}, spec {limit}, registered {REGISTRY_LIMITS[env_id]}")
    obs, _ = env.reset(seed=0)
    outs = [obs.clone()]
    gen = torch.Generator(device=dev).manual_seed(1)
    actions = []
    for _ in range(REGISTRY_WARM_STEPS):
        actions.append(env.single_action_space.sample_torch(gen, (n,)))
        outs.append(tuple(x.clone() for x in env.step(actions[-1])[:4]))
    torch.cuda.synchronize()
    start = time.perf_counter()
    carry, traj = env.rollout(REGISTRY_ROLLOUT)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - start
    shape = (REGISTRY_ROLLOUT, n) + env.single_observation_space.shape
    check(traj.obs.shape == shape, f"{env_id}: rollout obs {tuple(traj.obs.shape)}, want {shape}")
    check(bool(torch.isfinite(traj.obs.float()).all() and torch.isfinite(traj.reward).all()), f"{env_id}: not finite")
    check(int(carry.steps.max()) <= limit, f"{env_id}: a step counter passed the limit {limit}")
    again = gym.make_vec(env.spec)
    check(again.spec.kwargs == env.spec.kwargs and again.time_limit == limit and again.num_envs == n
          and again.device == env.device, f"{env_id}: make_vec(envs.spec) built another env: {again.spec.kwargs}")
    return {"mode": mode, "time_limit": env.time_limit, "device": str(env.device), "make_s": make_s,
            "rollout_steps": REGISTRY_ROLLOUT, "rollout_s": rollout_s, "env_steps_per_s": n * REGISTRY_ROLLOUT / rollout_s,
            "terminations": int(traj.terminated.sum()), "truncations": int(traj.truncated.sum()),
            "_actions": actions, "_outs": outs}


def compare_registry_with_hand_built(dev, env_id: str, run: dict, n: int = NUM_ENVS) -> int:
    """The first steps of :func:`run_registry_vec` against a ``TorchVectorEnv``
    built by hand over the same functional env with the same seed and
    actions on the same card. Raises unless every output equals in every
    bit. Returns the number of tensors compared."""
    from gymnasium_tpu_torch.vector import TorchVectorEnv

    env = TorchVectorEnv(hand_built(env_id), n, max_episode_steps=REGISTRY_LIMITS[env_id], device=dev)
    obs, _ = env.reset(seed=0)
    check(same_bits(obs, run["_outs"][0]), f"{env_id}: make_vec's reset obs differs from the hand-built env's")
    compared = 1
    for i, action in enumerate(run["_actions"]):
        for label, got, want in zip(("obs", "reward", "terminated", "truncated"), run["_outs"][i + 1], env.step(action)):
            check(same_bits(got, want), f"{env_id}: step {i} {label} differs from the hand-built env's")
            compared += 1
    return compared


def wrapper_chain(env) -> list[str]:
    names = []
    while hasattr(env, "env"):
        names.append(type(env).__name__)
        env = env.env
    return names + [type(env).__name__]


def run_registry_single(dev) -> dict:
    """``gymnasium_tpu_torch.make("phys2d/CartPole-v1")`` on the card: one
    episode to its end through ``PassiveEnvChecker``, ``OrderEnforcing`` and
    ``TimeLimit``, every warning raised as an error (the checker must accept
    the CUDA observations). Then ``contains`` of CUDA tensors: a Box
    observation inside and outside its bounds, a Discrete and a
    MultiDiscrete value, each answered as for the same values on the host."""
    import warnings

    import gymnasium_tpu_torch as gym

    start = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        env = gym.make("phys2d/CartPole-v1")
        chain = wrapper_chain(env)
        check(chain == ["TimeLimit", "OrderEnforcing", "PassiveEnvChecker", "FunctionalTorchEnv"],
              f"make's wrappers {chain}")
        check(env.unwrapped.device.type == torch.device(dev).type, f"make's env on {env.unwrapped.device}")
        env.action_space.seed(0)
        obs, _ = env.reset(seed=0)
        steps, inside_all = 0, True
        while True:
            obs, reward, terminated, truncated, _ = env.step(env.action_space.sample())
            steps += 1
            check(obs.device.type == torch.device(dev).type and obs.shape == (4,), f"make's obs {obs.device} {tuple(obs.shape)}")
            inside_all &= env.observation_space.contains(obs) or terminated
            if terminated or truncated:
                break
    seconds = time.perf_counter() - start
    check(inside_all, "a CartPole observation before the episode's end is not in its space")
    check(steps <= step_limit("phys2d/CartPole-v1"), f"an episode of {steps} steps")
    box = env.observation_space
    inside = torch.zeros(4, device=dev)
    outside = torch.tensor([10.0, 0.0, 0.0, 0.0], device=dev)
    answers = {
        "box_inside": box.contains(inside), "box_inside_host": box.contains(inside.cpu()),
        "box_outside": box.contains(outside), "box_outside_host": box.contains(outside.cpu()),
        "discrete": gym.spaces.Discrete(2).contains(torch.tensor(1, device=dev)),
        "discrete_host": gym.spaces.Discrete(2).contains(torch.tensor(1)),
        "multidiscrete": gym.spaces.MultiDiscrete([3, 3]).contains(torch.tensor([1, 2], device=dev)),
        "multidiscrete_host": gym.spaces.MultiDiscrete([3, 3]).contains(torch.tensor([1, 2])),
    }
    check(answers["box_inside"] and not answers["box_outside"] and answers["discrete"], f"contains {answers}")
    for key in ("box_inside", "box_outside", "discrete", "multidiscrete"):
        check(answers[key] == answers[f"{key}_host"], f"contains of a CUDA tensor differs from the host's: {answers}")
    return {"steps": steps, "terminated": bool(terminated), "truncated": bool(truncated), "seconds": seconds,
            "wrappers": chain, "contains": answers}


def run_single_env(dev, env_id: str, steps: int = SINGLE_STEPS) -> dict:
    """``FunctionalTorchEnv`` over ``env_id``'s functional env on the card (a
    batch of one): reset, then ``steps`` seeded actions of its space, with
    the draws recorded. Returns the wall time, the first state, the actions,
    the draws and the steps' outputs (for :func:`compare_single_env_with_cpu`)."""
    from gymnasium_tpu_torch.envs.functional_torch_env import FunctionalTorchEnv
    from gymnasium_tpu_torch.functional import tree_map

    draws = {"reset_draws": [], "transition_draws": []}

    def record(hook, draw, rng, count):
        draws[hook].append(draw(rng, count))
        return draws[hook][-1]

    env = FunctionalTorchEnv(with_draws(registered_func(env_id), record), device=dev)
    env.action_space.seed(0)
    actions = [env.action_space.sample() for _ in range(steps)]
    start = time.perf_counter()
    obs, _ = env.reset(seed=0)
    state0 = tree_map(torch.clone, env.state)
    outs = [env.step(action) for action in actions]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    check(all(o[0].device.type == env.device.type and o[0].shape == env.observation_space.shape for o in outs),
          f"{env_id}: single-env obs")
    check(all(bool(torch.isfinite(o[0]).all()) for o in outs), f"{env_id}: single-env obs not finite")
    return {"steps": steps, "seconds": seconds, "_state0": state0, "_actions": actions, "_draws": draws, "_outs": outs}


def compare_single_env_with_cpu(env_id: str, run: dict, tol: float) -> dict:
    """The same steps as :func:`run_single_env` on the CPU, from the card's
    first state with the card's actions and draws. Raises unless the flags
    are equal and every observation and reward is within ``tol * (1 +
    |cpu|)``. Returns the largest deviations."""
    from gymnasium_tpu_torch.envs.functional_torch_env import FunctionalTorchEnv
    from gymnasium_tpu_torch.functional import tree_map

    replays = {hook: iter(draws) for hook, draws in run["_draws"].items()}

    def replay(hook, draw, rng, count):
        return tuple(None if x is None else x.cpu() for x in next(replays[hook]))

    env = FunctionalTorchEnv(with_draws(registered_func(env_id), replay), device="cpu")
    env.reset(seed=0)
    env.state = tree_map(lambda x: x.cpu(), run["_state0"])
    worst = {"obs": 0.0, "reward": 0.0}
    for i, (action, card) in enumerate(zip(run["_actions"], run["_outs"])):
        cpu = env.step(action)
        err = (card[0].cpu().double() - cpu[0].double()).abs()
        check(bool((err <= tol * (1.0 + cpu[0].double().abs())).all()),
              f"{env_id} single env, step {i}: obs differs from the CPU's by {float(err.max())}")
        check(abs(card[1] - cpu[1]) <= tol * (1.0 + abs(cpu[1])), f"{env_id} step {i}: reward {card[1]} vs {cpu[1]}")
        check(card[2] == cpu[2] and card[3] == cpu[3], f"{env_id} step {i}: flags differ from the CPU's")
        worst["obs"] = max(worst["obs"], float(err.max()))
        worst["reward"] = max(worst["reward"], abs(card[1] - cpu[1]))
    check(all(next(it, None) is None for it in replays.values()), f"{env_id}: the CPU took fewer draws than the card")
    return {"max_abs_dev": worst, "tolerance": tol}


def host_actions(env, steps: int, seed: int = 0) -> np.ndarray:
    """``steps`` actions inside ``env``'s Box (or Discrete), from a numpy generator."""
    space = env.action_space
    if not hasattr(space, "low"):
        return [int(a) for a in np.random.default_rng(seed).integers(0, space.n, steps)]
    return np.random.default_rng(seed).uniform(space.low, space.high, (steps, *space.shape)).astype(np.float32)


def run_host_env(dev, env_id: str, steps: int = HOST_STEPS) -> dict:
    """``gymnasium_tpu_torch.make(env_id)`` with no device, so on the card:
    ``reset(seed=0)``, then ``steps`` numpy actions. Records the launches at
    reset and over the steps (every count set to 0 before each), the
    host-clock ms a step (each step reads its state back to the host, as the
    API asks), and for :func:`compare_host_env_with_cpu` the state before
    each step and the step's outputs."""
    import gymnasium_tpu_torch as gym
    from gymnasium_tpu_torch.ops import articulated_step as art

    env = gym.make(env_id)
    check(env.unwrapped.device.type == torch.device(dev).type, f"{env_id}: make's env on {env.unwrapped.device}")
    check(wrapper_chain(env)[:3] == ["TimeLimit", "OrderEnforcing", "PassiveEnvChecker"],
          f"{env_id}: make's wrappers {wrapper_chain(env)}")
    actions = host_actions(env, steps)
    art.launches.clear()
    start = time.perf_counter()
    obs, _ = env.reset(seed=0)
    reset_ms = (time.perf_counter() - start) * 1e3
    reset_launches = dict(art.launches)
    art.launches.clear()
    states, outs = [], []
    start = time.perf_counter()
    for action in actions:
        states.append(env.unwrapped.get_state())
        outs.append(env.step(action))
    seconds = time.perf_counter() - start
    step_launches = dict(art.launches)
    for o in outs:
        check(o[0].dtype == np.float64 and o[0].shape == env.observation_space.shape, f"{env_id}: obs {o[0].shape}")
        check(bool(np.isfinite(o[0]).all()) and isinstance(o[1], float), f"{env_id}: obs not finite or reward not a float")
    env.close()
    return {"steps": steps, "ms_a_step": seconds * 1e3 / steps, "reset_ms": reset_ms,
            "reset_launches": reset_launches, "step_launches": step_launches,
            "terminations": sum(bool(o[2]) for o in outs),
            "_states": states, "_actions": actions, "_outs": outs}


def compare_host_env_with_cpu(env_id: str, run: dict, checked: int = HOST_CHECK_STEPS,
                              tol: float = HOST_CHECK_TOL) -> dict:
    """The first ``checked`` steps of :func:`run_host_env` on the same env
    made with ``device="cpu"``, set to the card's state before each step
    (a float32 difference does not compound). Raises unless ``terminated``
    is equal and the observation, the reward and the new ``qpos``/``qvel``
    are within ``tol * (1 + |cpu|)``. Returns the largest deviations."""
    import gymnasium_tpu_torch as gym

    env = gym.make(env_id, device="cpu")
    env.reset(seed=0)
    worst = {"obs": 0.0, "reward": 0.0, "state": 0.0}
    for i in range(checked):
        env.unwrapped.set_state(*run["_states"][i])
        card, cpu = run["_outs"][i], env.step(run["_actions"][i])
        for label, got, want in (("obs", card[0], cpu[0]), ("reward", np.float64(card[1]), np.float64(cpu[1])),
                                 ("state", np.concatenate(run["_states"][i + 1]), env.unwrapped.state_vector())):
            err = np.abs(got - want)
            check(bool((err <= tol * (1.0 + np.abs(want))).all()),
                  f"{env_id} step {i}: {label} differs from the CPU's by {float(err.max())}")
            worst[label] = max(worst[label], float(err.max()))
        check(card[2] == cpu[2], f"{env_id} step {i}: terminated {card[2]} on the card, {cpu[2]} on the CPU")
    env.close()
    return {"max_abs_dev": worst, "checked_steps": checked, "tolerance": tol}


def profile_host_env_step(dev, env_id: str, kernel: str, steps: int = PROFILED_ENV_STEPS) -> dict:
    """``torch.profiler`` over ``steps`` host-env steps of ``make(env_id)`` on
    the card, after a reset and an unprofiled step (:func:`profile_steps`)."""
    import gymnasium_tpu_torch as gym

    env = gym.make(env_id)
    env.reset(seed=0)
    actions = host_actions(env, 2 + steps, seed=1)
    env.step(actions[0])
    out = profile_steps(env_id, env.step, actions[1:], kernel, 1)
    env.close()
    return {"env": env_id, **out}


def profile_steps(label: str, step, actions, kernel: str, launches_a_step: int) -> dict:
    """``torch.profiler`` over ``step(a)`` for each of ``actions[1:]``:
    kernels, memory copies and stream synchronisations a step, the device's
    busy time a step and its share of the profiled wall time, and
    ``kernel``'s device time a step, which must launch ``launches_a_step``
    times a step. The first launches of a trace can be lost, as in
    :func:`device_ms`: a trace that opened with one untimed HalfCheetah step
    (0.2 ms) held 4 of its 6 launches in every try of a run, where one
    untimed Ant step (4 ms) lost none. So each trace opens with untimed
    steps of ``actions[0]`` for :data:`TRACE_OPENING_S` and a
    synchronisation; the timed steps and a closing synchronisation run
    inside a ``host_env_steps`` range, and a device event counts where it
    starts inside that range's span on the host's clock, which CUPTI's
    device times share: every timed step is launched after the range opens
    and done before it closes. A trace that did not see every launch of
    ``kernel`` is taken again, up to five times."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.autograd.DeviceType.CUDA
    steps = len(actions) - 1
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            opened = time.perf_counter()
            step(actions[0])
            while time.perf_counter() - opened < TRACE_OPENING_S:
                step(actions[0])
            torch.cuda.synchronize()
            with record_function("host_env_steps"):
                start = time.perf_counter()
                for action in actions[1:]:
                    step(action)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - start) * 1e3 / steps
        events = prof.events()
        host = [e.time_range for e in events if e.name == "host_env_steps" and e.device_type != cuda]
        check(len(host) == 1, f"{label}: {len(host)} host ranges of host_env_steps in a trace")
        lo, hi = host[0].start, host[0].end
        everywhere = [e for e in events if e.device_type == cuda and not e.is_user_annotation]
        device = [e for e in everywhere if lo <= e.time_range.start < hi]
        copies = [e for e in device if e.name.startswith(("Memcpy", "Memset"))]
        kernels = [e for e in device if not e.name.startswith(("Memcpy", "Memset"))]
        own = [e for e in kernels if kernel in e.name]
        if len(own) == steps * launches_a_step:
            break
        starts = [round(e.time_range.start - lo) for e in everywhere if kernel in e.name]
        print(f"profile_steps: a trace of {label} saw {len(own)} of {steps * launches_a_step} launches of "
              f"{kernel} in the range; the trace's start at {starts} us from the range's, which lasts "
              f"{round(hi - lo)} us", flush=True)
    check(len(own) == steps * launches_a_step,
          f"{label}: the profiler saw {len(own)} of {steps * launches_a_step} launches of {kernel}")
    syncs = [e for e in events if e.name == "cudaStreamSynchronize" and lo <= e.time_range.start < hi]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3 / steps
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:80]] += e.time_range.elapsed_us()
    return {"profiled_steps": steps, "profiled_step_ms": wall_ms,
            "kernels_a_step": len(kernels) / steps, "copies_a_step": len(copies) / steps,
            "stream_syncs_a_step": len(syncs) / steps,
            "device_busy_ms_a_step": busy_ms, "device_busy_share": busy_ms / wall_ms,
            "kernel_device_ms_a_step": sum(e.time_range.elapsed_us() for e in own) / 1e3 / steps,
            "top_kernels_device_ms_a_step": {k: us / 1e3 / steps for k, us in by_name.most_common(5)}}


def render_host_frame(env_id: str, shape: tuple = (480, 480, 3)) -> dict:
    """One ``rgb_array`` frame of ``make(env_id, render_mode="rgb_array")`` on
    the card after ``reset(seed=0)``: ``shape`` uint8 and not constant."""
    import gymnasium_tpu_torch as gym

    env = gym.make(env_id, render_mode="rgb_array")
    env.reset(seed=0)
    start = time.perf_counter()
    frame = env.render()
    ms = (time.perf_counter() - start) * 1e3
    env.close()
    check(isinstance(frame, np.ndarray) and frame.shape == shape and frame.dtype == np.uint8,
          f"{env_id}: frame {getattr(frame, 'shape', None)} {getattr(frame, 'dtype', None)}")
    colours = int(np.unique(frame.reshape(-1, 3), axis=0).shape[0])
    check(colours > 1, f"{env_id}: the frame is one colour")
    return {"shape": list(frame.shape), "dtype": str(frame.dtype), "colours": colours, "render_ms": ms}


def box2d_kind(env_id: str) -> str:
    return "walker" if env_id.startswith("Bipedal") else "lander"


def run_box2d_env(dev, label: str, steps: int = BOX2D_STEPS) -> dict:
    """``gymnasium_tpu_torch.make`` of the Box2D path ``label`` with no device,
    so on the card: ``reset(seed=0)``, then ``steps`` numpy actions. Records
    the planar and terrain launches at reset and over the steps (every count
    set to 0 before the reset), the host-clock ms a step (each step reads one
    packed row back, as the API asks), and for :func:`compare_box2d_env_with_cpu`
    the env's state, generator and wind indices before each step (a step
    replaces the state's tensors and never writes into them, so a shallow
    copy keeps them) and the step's outputs."""
    import gymnasium_tpu_torch as gym
    from gymnasium_tpu_torch.ops import planar_step as pl
    from gymnasium_tpu_torch.ops import walker_terrain as wt

    env_id, kwargs = BOX2D_PATHS[label]
    env = gym.make(env_id, **kwargs)
    inner = env.unwrapped
    check(inner.device.type == torch.device(dev).type, f"{label}: make's env on {inner.device}")
    check(wrapper_chain(env)[:3] == ["TimeLimit", "OrderEnforcing", "PassiveEnvChecker"],
          f"{label}: make's wrappers {wrapper_chain(env)}")
    actions = host_actions(env, steps)

    def counts() -> dict:
        return {k: v for k, v in {**pl.launches, "walker_terrain": wt.launches}.items() if v}

    pl.launches.clear()
    wt.launches = 0
    start = time.perf_counter()
    obs, _ = env.reset(seed=0)
    reset_ms = (time.perf_counter() - start) * 1e3
    reset_launches = counts()
    reset_snap = (dict(inner.state), inner.np_random.bit_generator.state)
    snaps, outs = [], []
    start = time.perf_counter()
    for action in actions:
        snaps.append((dict(inner.state), inner.np_random.bit_generator.state,
                      getattr(inner, "wind_idx", None), getattr(inner, "torque_idx", None)))
        outs.append(env.step(action))
    seconds = time.perf_counter() - start
    # the counts run on from the reset's, so the caller's total holds both
    step_launches = {k: v - reset_launches.get(k, 0) for k, v in counts().items() if v != reset_launches.get(k, 0)}
    shape = env.observation_space.shape
    for o in (obs, *(o[0] for o in outs)):
        check(isinstance(o, np.ndarray) and o.dtype == np.float32 and o.shape == shape, f"{label}: obs {o.shape}")
        check(bool(np.isfinite(o).all()), f"{label}: obs not finite")
    check(all(isinstance(o[1], float) and isinstance(o[2], bool) for o in outs), f"{label}: reward or flag type")
    env.close()
    return {"env_id": env_id, "kwargs": kwargs, "steps": steps, "ms_a_step": seconds * 1e3 / steps,
            "reset_ms": reset_ms, "reset_launches": reset_launches, "step_launches": step_launches,
            "terminations": sum(o[2] for o in outs), "_reset": (obs, reset_snap), "_snaps": snaps,
            "_actions": actions, "_outs": outs}


def compare_box2d_env_with_cpu(label: str, run: dict, checked: int = BOX2D_CHECK_STEPS) -> dict:
    """The reset and the first ``checked`` steps of :func:`run_box2d_env` on
    the same env made with ``device="cpu"``: the reset from the same seed,
    each step from the card's state, generator and wind indices before it.
    Raises unless ``terminated`` and the generators after each step are
    equal and the observation and the reward are within
    :data:`BOX2D_TOL` of the CPU's, element by element. Returns the largest
    deviations."""
    import gymnasium_tpu_torch as gym

    env_id, kwargs = BOX2D_PATHS[label]
    tol = BOX2D_TOL[box2d_kind(env_id)]
    cpu = gym.make(env_id, device="cpu", **kwargs).unwrapped
    worst = {"obs": 0.0, "reward": 0.0}

    def agree(what: str, got, want, where: str) -> None:
        atol, rtol = tol[what]
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        err = np.abs(got - want)
        check(bool((err <= atol + rtol * np.abs(want)).all()),
              f"{label} {where}: {what} differs from the CPU's by {float(err.max())}")
        worst[what] = max(worst[what], float(err.max()))

    card_obs, (_, card_rng) = run["_reset"]
    agree("obs", card_obs, cpu.reset(seed=0)[0], "reset")
    check(cpu.np_random.bit_generator.state == card_rng, f"{label}: the generators differ after the reset")
    for i in range(checked):
        state, rng, wind_idx, torque_idx = run["_snaps"][i]
        cpu.state = {k: v.cpu() for k, v in state.items()}
        cpu.np_random.bit_generator.state = rng
        if wind_idx is not None:
            cpu.wind_idx, cpu.torque_idx = wind_idx, torque_idx
        card, want = run["_outs"][i], cpu.step(run["_actions"][i])
        agree("obs", card[0], want[0], f"step {i}")
        agree("reward", card[1], want[1], f"step {i}")
        check(card[2] == want[2], f"{label} step {i}: terminated {card[2]} on the card, {want[2]} on the CPU")
        check(cpu.np_random.bit_generator.state == run["_snaps"][i + 1][1],
              f"{label} step {i}: the generators differ after the step")
    cpu.close()
    return {"max_abs_dev": worst, "checked_steps": checked, "tolerance": tol}


def run_heuristic_landings() -> dict:
    """``demo_heuristic_lander`` on ``make("LunarLander-v3")`` (the card) at
    each of :data:`HEURISTIC_SEEDS`: the episode's total reward, which must
    exceed :data:`HEURISTIC_LANDING`, its steps and host-clock seconds."""
    import gymnasium_tpu_torch as gym
    from gymnasium_tpu_torch.envs.box2d.lunar_lander import demo_heuristic_lander

    out = {}
    for seed in HEURISTIC_SEEDS:
        env = gym.make("LunarLander-v3")
        start = time.perf_counter()
        total = demo_heuristic_lander(env, seed=seed)
        seconds = time.perf_counter() - start
        out[seed] = {"total_reward": total, "steps": env._elapsed_steps, "seconds": seconds}
        env.close()
        print(f"demo_heuristic_lander(make('LunarLander-v3'), seed={seed}) on the card: total reward {total:.4f} "
              f"in {out[seed]['steps']} steps, {seconds:.2f} s", flush=True)
        check(total > HEURISTIC_LANDING, f"the heuristic lander scored {total} at seed {seed}")
    return out


def run_car_racing_host(steps: int = CAR_HOST_STEPS) -> dict:
    """``make("CarRacing-v3")``, which runs on the host: ``reset(seed=0)``
    and ``steps`` numpy actions, each observation (96, 96, 3) uint8."""
    import gymnasium_tpu_torch as gym

    env = gym.make("CarRacing-v3")
    obs, _ = env.reset(seed=0)
    start = time.perf_counter()
    outs = [env.step(a) for a in host_actions(env, steps)]
    seconds = time.perf_counter() - start
    env.close()
    for o in (obs, *(o[0] for o in outs)):
        check(o.shape == (96, 96, 3) and o.dtype == np.uint8, f"CarRacing-v3: obs {o.shape} {o.dtype}")
    return {"steps": steps, "ms_a_step": seconds * 1e3 / steps, "rewards": [o[1] for o in outs][:5]}


def compare_terrain_at_n1(dev) -> dict:
    """The terrain kernel against its twin at N=1, normal and hardcore (bit
    for bit, every obstacle kind in the draws), and its CUDA-events time a
    call in each mode."""
    from gymnasium_tpu_torch.ops import walker_terrain as wt

    out = compare_terrain_with_twin(1, dev)
    u, d = terrain_draws(1, dev)
    for mode, draws in (("normal", None), ("hardcore", d)):
        out[f"{mode}_events_ms"] = cuda_ms(lambda: wt.walker_terrain(u, draws), 50, 5)
    return out


def host_class_episode(env, steps: int, render_mode: str) -> dict:
    """``reset(seed=0)``, ``steps`` samples of the seeded action space (a
    reset after each episode's end), then one render: every observation
    inside its space, the frame uint8 and not one colour, or the text not
    empty. Returns the host-clock ms a step and the render's."""
    obs, _ = env.reset(seed=0)
    env.action_space.seed(0)
    inside, episodes = env.observation_space.contains(obs), 0
    start = time.perf_counter()
    for _ in range(steps):
        obs, reward, terminated, truncated, _ = env.step(env.action_space.sample())
        inside &= env.observation_space.contains(obs) and isinstance(reward, (float, np.floating))
        if terminated or truncated:
            episodes += 1
            env.reset()
    seconds = time.perf_counter() - start
    start = time.perf_counter()
    frame = env.render()
    render_ms = (time.perf_counter() - start) * 1e3
    check(inside, f"{env.spec.id}: an observation outside its space or a reward not a float")
    if render_mode == "ansi":
        check(isinstance(frame, str) and frame.strip() != "", f"{env.spec.id}: ansi render {frame!r}")
        shown = f"{len(frame)} characters"
    else:
        check(isinstance(frame, np.ndarray) and frame.dtype == np.uint8 and frame.ndim == 3
              and np.unique(frame.reshape(-1, 3), axis=0).shape[0] > 1, f"{env.spec.id}: rgb_array frame")
        shown = list(frame.shape)
    return {"ms_a_step": seconds * 1e3 / steps, "episodes": episodes, "render": shown, "render_ms": render_ms}


def run_cartpole_vector_env(n: int = CARTPOLE_VECTOR_ENVS, steps: int = CARTPOLE_VECTOR_STEPS) -> dict:
    """``make_vec("CartPole-v1", n, vectorization_mode="vector_entry_point")``,
    the numpy ``CartPoleVectorEnv``: ``reset(seed=0)`` and ``steps`` sampled
    steps; float32 (n, 4) observations inside the space, an autoreset step
    (reward 0, no flag) after every lane's end, no lane past 500 steps."""
    import gymnasium_tpu_torch as gym
    from gymnasium_tpu_torch.envs.classic_control import CartPoleVectorEnv

    env = gym.make_vec("CartPole-v1", n, vectorization_mode="vector_entry_point", render_mode="rgb_array")
    check(isinstance(env, CartPoleVectorEnv), f"make_vec gave {type(env).__name__}")
    obs, _ = env.reset(seed=0)
    env.action_space.seed(0)
    ends, truncations, prev_done = 0, 0, np.zeros(n, bool)
    start = time.perf_counter()
    for _ in range(steps):
        obs, reward, terminated, truncated, _ = env.step(env.action_space.sample())
        check(obs.dtype == np.float32 and obs.shape == (n, 4), f"CartPoleVectorEnv obs {obs.dtype} {obs.shape}")
        check(bool((reward[prev_done] == 0).all() and not (terminated | truncated)[prev_done].any()),
              "CartPoleVectorEnv: an autoreset step with a reward or a flag")
        prev_done = terminated | truncated
        ends += int(prev_done.sum())
        truncations += int(truncated.sum())
    seconds = time.perf_counter() - start
    check(int(env.steps.max()) <= 500 and ends > 0, f"CartPoleVectorEnv: steps {env.steps}, {ends} episode ends")
    frames = env.render()
    env.close()
    check(len(frames) == n and all(f.shape == (400, 600, 3) and f.dtype == np.uint8 for f in frames),
          "CartPoleVectorEnv: its frames")
    return {"envs": n, "steps": steps, "ms_a_step": seconds * 1e3 / steps, "episode_ends": ends,
            "truncations": truncations, "frames": [len(frames), *frames[0].shape]}


def run_host_classes() -> dict:
    """The host-class phase (:data:`HOST_CLASS_IDS`): each id through
    :func:`host_class_episode` with ``make``'s wrappers, and the
    ``CartPoleVectorEnv``, timed; then all of it again under
    ``torch.profiler`` with the card's activity recorded, which must hold no
    device event and no kernel launch or copy call."""
    from torch.profiler import ProfilerActivity, profile

    import gymnasium_tpu_torch as gym

    def every_path(results):
        for env_id in HOST_CLASS_IDS:
            mode = "ansi" if env_id.startswith("BlockchainCPD") else "rgb_array"
            env = gym.make(env_id, render_mode=mode)
            check(wrapper_chain(env)[-2] == "PassiveEnvChecker" and not hasattr(env.unwrapped, "device"),
                  f"{env_id}: make's wrappers {wrapper_chain(env)}")
            results[env_id] = host_class_episode(env, HOST_CLASS_STEPS, mode)
            env.close()
        results["CartPoleVectorEnv"] = run_cartpole_vector_env()

    timed, profiled = {}, {}
    every_path(timed)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        every_path(profiled)
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    device = [e.name for e in events if e.device_type == cuda]
    calls = [e.name for e in events if e.name.startswith(CUDA_RUNTIME_CALLS)]
    aten = sum(e.name.startswith("aten::") for e in events)
    check(not device and not calls, f"the host classes touched the card: device events {device[:5]}, calls {calls[:5]}")
    for env_id in HOST_CLASS_IDS:
        r = timed[env_id]
        print(f"make({env_id!r}) host class: {r['ms_a_step']:.4f} ms a step (host clock, {HOST_CLASS_STEPS} "
              f"steps, {r['episodes']} episode ends), render {r['render']} in {r['render_ms']:.2f} ms", flush=True)
    r = timed["CartPoleVectorEnv"]
    print(f"CartPoleVectorEnv ({r['envs']} envs): {r['ms_a_step']:.4f} ms a step (host clock, {r['steps']} steps, "
          f"{r['episode_ends']} lane ends, {r['truncations']} truncations), frames {r['frames']}", flush=True)
    return {"timed": timed, "profiled_ms_a_step": {k: r["ms_a_step"] for k, r in profiled.items()},
            "profiler": {"device_events": len(device), "cuda_launch_or_copy_calls": len(calls),
                         "aten_ops": aten, "events": len(events)}}


def kernel_launches() -> dict:
    """The articulated and planar launch counts of the process this runs in."""
    from gymnasium_tpu_torch.ops import articulated_step as art
    from gymnasium_tpu_torch.ops import planar_step as pl

    return {k: v for k, v in {**art.launches, **pl.launches}.items() if v}


def report_launches(env):
    """A ``make_vec`` wrapper: the sub-env answers ``call("kernel_launches")``
    with the counts of the process it steps in (its worker's, under
    ``async``) and ``get_attr("made_at")`` with the wall-clock time it was
    made. A module-level function, so that a spawned worker unpickles it
    from this script."""
    env.unwrapped.kernel_launches = kernel_launches
    env.unwrapped.made_at = time.time()
    return env


def identical(a, b) -> bool:
    """``a`` and ``b`` hold the same values in every bit: containers of the
    same types and keys, arrays of the same dtype, shape and bytes."""
    if isinstance(b, dict):
        return isinstance(a, dict) and list(a) == list(b) and all(identical(a[k], b[k]) for k in b)
    if isinstance(b, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(identical(x, y) for x, y in zip(a, b))
    if isinstance(b, np.ndarray) and b.dtype == object:
        return isinstance(a, np.ndarray) and a.shape == b.shape and all(identical(x, y) for x, y in zip(a.flat, b.flat))
    if isinstance(b, (np.ndarray, np.generic)):
        return (isinstance(a, (np.ndarray, np.generic)) and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(b, float):
        return type(a) is type(b) and np.float64(a).tobytes() == np.float64(b).tobytes()
    return type(a) is type(b) and a == b


def vector_actions(envs, steps: int, seed: int = 0) -> np.ndarray:
    """``steps`` batches of actions inside ``envs``' single action space."""
    space, rng = envs.single_action_space, np.random.default_rng(seed)
    if hasattr(space, "low"):
        return rng.uniform(space.low, space.high, (steps, envs.num_envs, *space.shape)).astype(np.float32)
    return rng.integers(0, space.n, (steps, envs.num_envs))


def sub_env_snapshot(env) -> tuple:
    """What a sub-env steps from: a MuJoCo-class env's ``qpos``/``qvel``, a
    planar env's state (a step replaces its tensors, so a shallow copy keeps
    them) and wind indices, and the generator's state."""
    inner = env.unwrapped
    rng = inner.np_random.bit_generator.state
    if hasattr(inner, "get_state"):
        return ("articulated", inner.get_state(), rng)
    return ("planar", dict(inner.state), rng, getattr(inner, "wind_idx", None), getattr(inner, "torque_idx", None))


def restore_sub_env(env, snapshot: tuple) -> None:
    """Set a sub-env to a :func:`sub_env_snapshot`, on its own device."""
    inner = env.unwrapped
    if snapshot[0] == "articulated":
        inner.set_state(*snapshot[1])
    else:
        inner.state = {k: v.to(inner.device) for k, v in snapshot[1].items()}
        if snapshot[3] is not None:
            inner.wind_idx, inner.torque_idx = snapshot[3], snapshot[4]
    inner.np_random.bit_generator.state = snapshot[2]


def run_sync_vector(dev, env_id: str, steps: int) -> dict:
    """``make_vec(env_id, VEC_ENVS, vectorization_mode="sync")`` with no
    device, so every sub-env on the card: ``reset(seed=0)``, then ``steps``
    steps of fixed numpy actions. Each step must launch each sub-env's build
    once (its step, or its reset after an episode's end) and hand back a
    numpy batch. Records the host-clock ms a step (the steps alone), the
    launches at the reset, and for :func:`compare_sync_vector_with_cpu` and
    :func:`run_async_vector` each sub-env's state before each step and the
    step's outputs."""
    import gymnasium_tpu_torch as gym
    from gymnasium_tpu_torch.vector import SyncVectorEnv

    envs = gym.make_vec(env_id, VEC_ENVS, vectorization_mode="sync", wrappers=(report_launches,))
    check(isinstance(envs, SyncVectorEnv), f"make_vec({env_id!r}, sync) gave {type(envs).__name__}")
    devices = {env.unwrapped.device.type for env in envs.envs}
    check(devices == {torch.device(dev).type}, f"{env_id}: sub-envs on {devices}")
    actions = vector_actions(envs, steps)
    space = envs.single_observation_space
    before = sum(kernel_launches().values())
    obs, _ = envs.reset(seed=0)
    reset_launches = sum(kernel_launches().values()) - before
    snaps, outs, seconds = [], [], 0.0
    for k, action in enumerate(actions):
        snaps.append([sub_env_snapshot(env) for env in envs.envs])
        count = sum(kernel_launches().values())
        start = time.perf_counter()
        out = envs.step(action)
        seconds += time.perf_counter() - start
        rose = sum(kernel_launches().values()) - count
        check(rose == VEC_ENVS, f"{env_id} sync step {k}: {rose} launches, want one a sub-env ({VEC_ENVS})")
        check(isinstance(out[0], np.ndarray) and out[0].shape == (VEC_ENVS, *space.shape)
              and out[0].dtype == space.dtype and bool(np.isfinite(out[0]).all()),
              f"{env_id} sync step {k}: obs {type(out[0]).__name__} {getattr(out[0], 'shape', None)}")
        check(all(isinstance(x, np.ndarray) for x in out[1:4]), f"{env_id} sync step {k}: not numpy")
        outs.append(out)
    envs.close()
    return {"envs": VEC_ENVS, "steps": steps, "ms_a_step": seconds * 1e3 / steps, "reset_launches": reset_launches,
            "episode_ends": int(sum((o[2] | o[3]).sum() for o in outs)),
            "_reset": obs, "_snaps": snaps, "_actions": actions, "_outs": outs}


def vector_tolerance(env_id: str) -> dict:
    """(atol, rtol) by output: the lander's of the Box2D host phase, the
    MuJoCo-class robots' ``HOST_CHECK_TOL * (1 + |cpu|)``."""
    if env_id.startswith("LunarLander"):
        return BOX2D_TOL["lander"]
    return {"obs": (HOST_CHECK_TOL, HOST_CHECK_TOL), "reward": (HOST_CHECK_TOL, HOST_CHECK_TOL)}


def compare_sync_vector_with_cpu(env_id: str, run: dict, first: int = VEC_CHECK_STEPS) -> dict:
    """Steps of :func:`run_sync_vector` on the same vector env made with
    ``device="cpu"`` (whose twin takes tens of ms a sub-env step): the reset
    from the same seed, then the ``first`` steps and each step that ended a
    sub-episode with the autoreset step after it, with each sub-env set to
    its card state and generator before the step and the vector env to the
    card's pending autoresets. Raises unless the flags are equal and the
    observation and reward are within :func:`vector_tolerance` of the CPU's,
    element by element."""
    import gymnasium_tpu_torch as gym

    tol = vector_tolerance(env_id)
    cpu = gym.make_vec(env_id, VEC_ENVS, vectorization_mode="sync", wrappers=(report_launches,), device="cpu")
    worst = {"obs": 0.0, "reward": 0.0}

    def agree(what: str, got, want, where: str) -> None:
        atol, rtol = tol[what]
        err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
        check(bool((err <= atol + rtol * np.abs(np.asarray(want, np.float64))).all()),
              f"{env_id} sync {where}: {what} differs from the CPU's by {float(err.max())}")
        worst[what] = max(worst[what], float(err.max()))

    agree("obs", run["_reset"], cpu.reset(seed=0)[0], "reset")
    outs = run["_outs"]
    ends = [k for k, o in enumerate(outs) if (o[2] | o[3]).any()]
    checked = sorted({*range(first), *ends, *(k + 1 for k in ends)} & set(range(len(outs))))
    for i in checked:
        for env, snapshot in zip(cpu.envs, run["_snaps"][i]):
            restore_sub_env(env, snapshot)
        cpu._needs_autoreset = outs[i - 1][2] | outs[i - 1][3] if i else np.zeros(VEC_ENVS, bool)
        card, want = outs[i], cpu.step(run["_actions"][i])
        agree("obs", card[0], want[0], f"step {i}")
        agree("reward", card[1], want[1], f"step {i}")
        check(bool((card[2] == want[2]).all() and (card[3] == want[3]).all()),
              f"{env_id} sync step {i}: flags {card[2]} {card[3]} on the card, {want[2]} {want[3]} on the CPU")
        check(list(card[4]) == list(want[4]), f"{env_id} sync step {i}: info keys {list(card[4])} vs {list(want[4])}")
    cpu.close()
    return {"max_abs_dev": worst, "checked_steps": checked, "tolerance": tol}


def profile_sync_vector(env_id: str, kernel: str, steps: int = VEC_PROFILED_STEPS) -> dict:
    """:func:`profile_steps` over ``steps`` steps of the sync vector env on
    the card: each step launches ``kernel`` once a sub-env."""
    import gymnasium_tpu_torch as gym

    envs = gym.make_vec(env_id, VEC_ENVS, vectorization_mode="sync")
    envs.reset(seed=0)
    actions = vector_actions(envs, 2 + steps, seed=1)
    envs.step(actions[0])
    out = profile_steps(f"make_vec({env_id!r}, sync)", envs.step, actions[1:], kernel, VEC_ENVS)
    envs.close()
    return out


def run_async_vector(dev, sync_run: dict, build_name: str) -> dict:
    """``make_vec("HalfCheetah-v5", VEC_ENVS, vectorization_mode="async")``
    in spawned workers over shared memory, each sub-env on the card: the
    reset and steps of :func:`run_sync_vector`'s HalfCheetah run, which must
    come out equal in every bit. Each worker reports its env's device
    (``cuda``), the wall-clock time its env was made and its own launches of
    ``build_name``, one a step; then :data:`VEC_ROUND_TRIPS` calls that
    touch no card time the pipes alone. Every wait has a timeout and the
    env is closed with ``terminate=True``."""
    import importlib.util

    import gymnasium_tpu_torch as gym
    from gymnasium_tpu_torch.vector import AsyncVectorEnv

    def wait_call(envs, name):
        envs.call_async(name)
        return envs.call_wait(timeout=VEC_WAIT_S)

    began_wall, start = time.time(), time.perf_counter()
    envs = gym.make_vec("HalfCheetah-v5", VEC_ENVS, vectorization_mode="async", wrappers=(report_launches,),
                        vector_kwargs={"context": "spawn", "shared_memory": True})
    try:
        startup_s = time.perf_counter() - start
        check(isinstance(envs, AsyncVectorEnv) and envs.context == "spawn" and envs.shared_memory,
              f"make_vec(async) gave {type(envs).__name__}")
        devices = wait_call(envs, "device")
        check(all(d.type == "cuda" for d in devices), f"async workers' envs on {devices}")
        made_at = wait_call(envs, "made_at")
        envs.reset_async(seed=0)
        obs, _ = envs.reset_wait(timeout=VEC_WAIT_S)
        check(identical(obs, sync_run["_reset"]), "async HalfCheetah: the reset differs from the sync env's")
        seconds = 0.0
        for k, (action, want) in enumerate(zip(sync_run["_actions"], sync_run["_outs"])):
            start = time.perf_counter()
            envs.step_async(action)
            got = envs.step_wait(timeout=VEC_WAIT_S)
            seconds += time.perf_counter() - start
            check(identical(got, want), f"async HalfCheetah step {k}: differs from the sync env's")
        launches = wait_call(envs, "kernel_launches")
        steps = len(sync_run["_outs"])
        # the pipes alone: a call that every worker answers without the card
        start = time.perf_counter()
        for _ in range(VEC_ROUND_TRIPS):
            wait_call(envs, "made_at")
        round_trip_ms = (time.perf_counter() - start) * 1e3 / VEC_ROUND_TRIPS
        check(all(w == {build_name: steps} for w in launches),
              f"async workers' launches {launches}, want {{{build_name!r}: {steps}}} each")
    finally:
        envs.close(terminate=True)
    check(not any(p.is_alive() for p in envs.processes), "async workers still alive after close")
    return {"envs": VEC_ENVS, "context": "spawn", "shared_memory": True, "steps": steps,
            "ms_a_step": seconds * 1e3 / steps, "call_round_trip_ms": round_trip_ms, "startup_s": startup_s,
            "worker_startup_s": [t - began_wall for t in made_at],
            "worker_devices": [str(d) for d in devices], "worker_launches": launches,
            "cloudpickle": importlib.util.find_spec("cloudpickle") is not None, "equal_to_sync": True}


class AsyncHang(Exception):
    """The default-context async env neither raised nor finished in time."""


def run_async_default_context(limit: int = VEC_FORK_LIMIT_S) -> dict:
    """``make_vec("HalfCheetah-v5", VEC_ENVS, vectorization_mode="async")``
    with the default context: forked workers cannot open CUDA in a process
    whose parent has, so the env must raise in the parent within ``limit``
    seconds (torch's re-initialisation error from a worker, or a wait's
    ``multiprocessing.TimeoutError``) and leave no worker behind: a worker
    that reported its error exits by itself, the others are terminated. An
    alarm turns a hang into :class:`AsyncHang`, which fails the run."""
    import multiprocessing
    import signal

    import gymnasium_tpu_torch as gym

    def on_alarm(signum, frame):
        raise AsyncHang(f"the default-context async env hung for {limit} s")

    previous = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(limit)
    envs, raised, start = None, None, time.perf_counter()
    try:
        envs = gym.make_vec("HalfCheetah-v5", VEC_ENVS, vectorization_mode="async")
        envs.reset_async(seed=0)
        envs.reset_wait(timeout=limit / 2)
        envs.step_async(np.zeros((VEC_ENVS, 6), np.float32))
        envs.step_wait(timeout=limit / 2)
    except AsyncHang:
        raise
    except Exception as e:  # noqa: BLE001  (the phase's point is which exception comes)
        raised = e
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)
        if envs is not None:
            envs.close(terminate=True)
    seconds = time.perf_counter() - start
    # workers that reported an error exit on their own; wait for them
    deadline = time.perf_counter() + limit
    while multiprocessing.active_children() and time.perf_counter() < deadline:
        time.sleep(0.05)
    exit_s = time.perf_counter() - start - seconds
    check(raised is not None, "the default-context async env on the card raised nothing")
    if isinstance(raised, multiprocessing.TimeoutError):
        kind = "multiprocessing.TimeoutError"
    else:
        check("re-initialize CUDA in forked subprocess" in str(raised),
              f"the default-context async env raised something else: {raised!r}")
        kind = "CUDA re-initialisation in a forked worker"
    check(not multiprocessing.active_children(), f"workers left: {multiprocessing.active_children()}")
    return {"context": multiprocessing.get_start_method(), "raised": kind, "exception": type(raised).__name__,
            "message": str(raised)[:200], "seconds": seconds, "workers_exited_after_s": exit_s}


def run_native_tabular() -> dict:
    """The native tabular stepper: built with ``g++`` into the package's
    ``build/`` (its path and seconds), then for each of :data:`TABULAR_IDS`
    ``make_vec(id, TABULAR_ENVS, vectorization_mode="vector_entry_point")``
    native and on its numpy path from one seed: ``TABULAR_STEPS`` equal
    steps, each path's env-steps/s (host clock), and the native run again
    under ``torch.profiler``, which must see no device event."""
    from torch.profiler import ProfilerActivity, profile

    import gymnasium_tpu_torch as gym
    from gymnasium_tpu_torch.native import tabular_library
    from gymnasium_tpu_torch.native.build import library_path

    path = library_path("gymtpu_tabular", ["tabular.cpp"])
    existed = path.exists()
    tabular_library.cache_clear()
    start = time.perf_counter()
    lib = tabular_library()
    build_s = time.perf_counter() - start
    check(lib is not None and lib._name == str(path), f"the native tabular stepper did not build at {path}")
    out = {"library": os.path.relpath(path), "built_here": not existed, "build_s": build_s, "envs": TABULAR_ENVS,
           "steps": TABULAR_STEPS}
    print(f"native tabular stepper: {out['library']} {'built' if not existed else 'found'} in {build_s:.2f} s",
          flush=True)

    def run(env_id, native: bool, actions):
        env = gym.make_vec(env_id, TABULAR_ENVS, vectorization_mode="vector_entry_point")
        if not native:
            env.stepper.lib = None
        check(env.stepper.is_native == native, f"{env_id}: is_native {env.stepper.is_native}, want {native}")
        outs = [env.reset(seed=0)]
        start = time.perf_counter()
        outs += [env.step(a) for a in actions]
        return outs, time.perf_counter() - start

    for env_id in TABULAR_IDS:
        probe = gym.make_vec(env_id, 1, vectorization_mode="vector_entry_point")
        actions = np.random.default_rng(0).integers(0, probe.single_action_space.n, (TABULAR_STEPS, TABULAR_ENVS))
        native, native_s = run(env_id, True, actions)
        plain, plain_s = run(env_id, False, actions)
        for k, (a, b) in enumerate(zip(native, plain)):
            check(identical(a, b), f"{env_id}: the native step {k} differs from the numpy path's")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(env_id, True, actions)
        device = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        check(not device, f"{env_id}: the native stepper made device events {device[:5]}")
        out[env_id] = {"is_native": True, "native_env_steps_per_s": TABULAR_ENVS * TABULAR_STEPS / native_s,
                       "numpy_env_steps_per_s": TABULAR_ENVS * TABULAR_STEPS / plain_s,
                       "episode_ends": int(sum((o[2] | o[3]).sum() for o in native[1:])),
                       "device_events": len(device), "equal_to_numpy_path": True}
        print(f"make_vec({env_id!r}, {TABULAR_ENVS}, vector_entry_point): native "
              f"{out[env_id]['native_env_steps_per_s']:.0f} env-steps/s, numpy path "
              f"{out[env_id]['numpy_env_steps_per_s']:.0f} (host clock, {TABULAR_STEPS} steps)", flush=True)
    return out


def host_wrapper_stack(W, env):
    """The host wrappers of the wrapper phase, over ``env``."""
    return W.FrameStackObservation(W.NormalizeObservation(W.ClipAction(W.RescaleAction(env, -1.0, 1.0))), 4)


def run_host_wrappers(dev, steps: int = WRAPPER_HOST_STEPS) -> dict:
    """:func:`host_wrapper_stack` over ``make("HalfCheetah-v5")`` on the card
    and with ``device="cpu"``: one reset and ``steps`` steps of actions
    beyond the rescaled range, the CPU env set to the card's state before
    each step. The raw observation, the reward and NormalizeObservation's
    running moments agree within ``HOST_CHECK_TOL * (1 + |cpu|)``; the
    newest stacked frame within twice that over the running standard
    deviation, by which normalising scales a difference; the older frames
    are the last step's. Then the host-clock ms a step of a fresh wrapped
    env and of the bare env, each timed alone."""
    import gymnasium_tpu_torch as gym
    import gymnasium_tpu_torch.wrappers as W

    card = host_wrapper_stack(W, gym.make("HalfCheetah-v5"))
    cpu = host_wrapper_stack(W, gym.make("HalfCheetah-v5", device="cpu"))
    check(card.unwrapped.device.type == torch.device(dev).type, f"wrapped env on {card.unwrapped.device}")
    actions = np.random.default_rng(0).uniform(-1.5, 1.5, (steps, 6)).astype(np.float32)
    card_obs, cpu_obs = card.reset(seed=0)[0], cpu.reset(seed=0)[0]
    check(identical(card_obs, cpu_obs), "wrapped HalfCheetah: the resets differ")
    worst = {"raw_obs": 0.0, "reward": 0.0, "running_moments": 0.0, "newest_frame": 0.0}

    def agree(what, got, want, bound, where):
        err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
        check(bool((err <= bound).all()), f"wrapped HalfCheetah {where}: {what} off by {float(err.max())}")
        worst[what] = max(worst[what], float(err.max()))

    for k, action in enumerate(actions):
        cpu.unwrapped.set_state(*card.unwrapped.get_state())
        got, want = card.step(action), cpu.step(action)
        raw = cpu.unwrapped._get_obs()
        agree("raw_obs", card.unwrapped._get_obs(), raw, HOST_CHECK_TOL * (1 + np.abs(raw)), f"step {k}")
        agree("reward", got[1], want[1], HOST_CHECK_TOL * (1 + abs(want[1])), f"step {k}")
        rms_card, rms_cpu = card.get_wrapper_attr("obs_rms"), cpu.get_wrapper_attr("obs_rms")
        for stat in ("mean", "var"):
            value = getattr(rms_cpu, stat)
            agree("running_moments", getattr(rms_card, stat), value, HOST_CHECK_TOL * (1 + np.abs(value)),
                  f"step {k} {stat}")
        scale = np.sqrt(rms_cpu.var + cpu.get_wrapper_attr("epsilon"))
        agree("newest_frame", got[0][-1], want[0][-1], 2 * HOST_CHECK_TOL * (1 + np.abs(raw)) / scale, f"step {k}")
        check(identical(got[0][:-1], card_obs[1:]), f"wrapped HalfCheetah step {k}: the frame stack did not shift")
        check(got[2:4] == want[2:4], f"wrapped HalfCheetah step {k}: flags {got[2:4]} vs {want[2:4]}")
        card_obs = got[0]
    check(card_obs.shape == (4, 17) and card_obs.dtype == np.float64, f"stacked obs {card_obs.shape}")
    card.close()
    cpu.close()
    # timed alone: the CPU twin's threads between the card's steps slow them
    timed = {}
    for label, env, batch in (("wrapped", host_wrapper_stack(W, gym.make("HalfCheetah-v5")), actions),
                              ("bare", gym.make("HalfCheetah-v5"), np.clip(actions, -1.0, 1.0))):
        env.reset(seed=0)
        start = time.perf_counter()
        for action in batch:
            env.step(action)
        timed[label] = (time.perf_counter() - start) * 1e3 / steps
        env.close()
    return {"wrappers": ["FrameStackObservation(4)", "NormalizeObservation", "ClipAction", "RescaleAction(-1, 1)"],
            "steps": steps, "ms_a_step": timed["wrapped"], "bare_ms_a_step": timed["bare"],
            "max_abs_dev": worst, "tolerance": HOST_CHECK_TOL}


def vector_wrapper_chain(V, env, depth: int = len(VW_LAYERS)):
    """``env`` under the first ``depth`` wrappers of ``VW_LAYERS`` (the
    vector wrappers a PPO user runs, innermost first) from ``V``, the vector
    wrapper package."""
    for name in VW_LAYERS[:depth]:
        env = getattr(V, name)(env)
    return env


def time_chain_layers(n: int = NUM_ENVS, steps: int = VW_LAYER_STEPS) -> dict:
    """Host-clock ms a step of ``make_vec("HalfCheetah-v5", n)`` under each
    prefix of :func:`vector_wrapper_chain` (the bare env, then one wrapper
    more each time), ``steps`` steps of :func:`wide_actions` each after a
    reset, ending in a synchronize: what each wrapper adds to a step."""
    import gymnasium_tpu_torch as gym
    import gymnasium_tpu_torch.wrappers.vector as V

    actions = wide_actions(n, steps, seed=2)
    out = {}
    for depth in range(len(VW_LAYERS) + 1):
        env = vector_wrapper_chain(V, gym.make_vec("HalfCheetah-v5", n, vector_kwargs={"max_episode_steps": VW_LIMIT}),
                                   depth)
        env.reset(seed=0)
        batch = actions if depth > 1 else np.clip(actions, -1.0, 1.0)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for action in batch:
            env.step(action)
        torch.cuda.synchronize()
        out["bare" if depth == 0 else f"+{VW_LAYERS[depth - 1]}"] = (time.perf_counter() - start) * 1e3 / steps
    return out


def wide_actions(n: int, steps: int, seed: int = 0) -> np.ndarray:
    """``steps`` batches of HalfCheetah actions in [-VW_ACTION_BOUND,
    VW_ACTION_BOUND], past the action space's [-1, 1]."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-VW_ACTION_BOUND, VW_ACTION_BOUND, (steps, n, 6)).astype(np.float32)


def run_vector_wrappers(dev, build_name: str, n: int = NUM_ENVS, steps: int = VW_STEPS) -> dict:
    """:func:`vector_wrapper_chain` over ``make_vec("HalfCheetah-v5", n)`` on
    the card (step limit ``VW_LIMIT``): a reset and ``steps`` steps of
    :func:`wide_actions`. Each step launches ``build_name`` once; every
    action that reaches the env lies in [-1, 1]; the observations are numpy
    float32 and finite, the rewards numpy and the flags tensors on the card
    (JAX's kinds over its device env); every env reports one episode, of
    ``VW_LIMIT`` steps. Records the host-clock ms a step."""
    import gymnasium_tpu_torch as gym
    import gymnasium_tpu_torch.wrappers.vector as V
    from gymnasium_tpu_torch.ops import articulated_step as art
    from gymnasium_tpu_torch.vector import TorchVectorEnv

    base = gym.make_vec("HalfCheetah-v5", n, vector_kwargs={"max_episode_steps": VW_LIMIT})
    check(isinstance(base, TorchVectorEnv) and base.device.type == torch.device(dev).type,
          f"make_vec('HalfCheetah-v5') gave {type(base).__name__}")
    reached, env_step = [], base.step

    def step(actions):
        reached.append(actions)
        return env_step(actions)

    base.step = step
    env = vector_wrapper_chain(V, base)
    check(isinstance(env.single_observation_space, type(base.single_observation_space)), "chain observation space")
    actions = wide_actions(n, steps)
    obs, infos = env.reset(seed=0)
    check(isinstance(obs, np.ndarray) and obs.dtype == np.float32 and obs.shape == (n, 17), f"reset obs {type(obs)}")
    check(isinstance(infos, list) and len(infos) == n, "reset infos are not a list a env")
    before = art.launches.get(build_name, 0)
    episodes, seconds = np.zeros(n, np.int64), 0.0
    for k, action in enumerate(actions):
        start = time.perf_counter()
        obs, reward, term, trunc, infos = env.step(action)
        seconds += time.perf_counter() - start
        check(isinstance(obs, np.ndarray) and obs.dtype == np.float32 and obs.shape == (n, 17)
              and bool(np.isfinite(obs).all()), f"chain step {k}: obs {type(obs).__name__} {getattr(obs, 'dtype', None)}")
        check(isinstance(reward, np.ndarray) and reward.shape == (n,) and bool(np.isfinite(reward).all()),
              f"chain step {k}: reward {type(reward).__name__}")
        check(all(isinstance(f, torch.Tensor) and f.device.type == torch.device(dev).type for f in (term, trunc)),
              f"chain step {k}: flags {type(term).__name__} on {getattr(term, 'device', None)}")
        check(isinstance(infos, list) and len(infos) == n, f"chain step {k}: infos")
        for i, info in enumerate(infos):
            if "episode" in info:
                episodes[i] += 1
                check(int(info["episode"]["l"]) == VW_LIMIT, f"chain step {k}: env {i} ended at {info['episode']['l']}")
    launched = art.launches.get(build_name, 0) - before
    check(launched == steps, f"the chain's {steps} steps launched {build_name} {launched} times")
    check(len(reached) == steps, f"{len(reached)} steps reached the env")
    for k, a in enumerate(reached):
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        check(a.shape == (n, 6) and bool(((a >= -1.0) & (a <= 1.0)).all()), f"chain step {k}: an action outside [-1, 1]")
    check(bool((episodes == 1).all()), f"episodes by env: {np.bincount(episodes)} (want one each)")
    stats = env.env.env.env.env
    check(type(stats).__name__ == "RecordEpisodeStatistics" and stats.episode_count == n, "episode count")
    return {"env": "make_vec('HalfCheetah-v5', %d)" % n, "step_limit": VW_LIMIT, "steps": steps,
            "wrappers": list(VW_LAYERS),
            "launches_in_the_steps": launched, "episodes": int(episodes.sum()),
            "ms_a_step": seconds * 1e3 / steps, "env_steps_per_s": n * steps / seconds}


def compare_vector_wrappers_with_cpu(dev, n: int = NUM_ENVS, steps: int = VW_CHECK_STEPS) -> dict:
    """The first ``steps`` steps of :func:`run_vector_wrappers`' chain on the
    card and on the CPU, from the same reset draws and actions
    (:func:`cpu_and_card_traces`). Raw observations (the env's own) and
    states within ``HOST_CHECK_TOL * (1 + |cpu|)``, the normalised rewards
    too; the normalised observations within twice that over the standard
    deviation of the raw observations so far, by which normalising scales a
    difference; the flags equal."""
    import gymnasium_tpu_torch.wrappers.vector as V
    from gymnasium_tpu_torch.functional import tree_map

    func = registered_func("HalfCheetah-v5")
    actions = torch.from_numpy(wide_actions(n, steps, seed=1))
    cpu, card = cpu_and_card_traces(dev, func, n, actions, VW_LIMIT, extra=lambda env: (env._last_obs,),
                                    wrap=lambda env: vector_wrapper_chain(V, env))
    worst = {"raw_obs": [], "state": [], "reward": [], "normalised_obs": []}
    raw = [cpu[0][2]]
    for k in range(steps + 1):
        got, want = card[k], cpu[k]
        where = "reset" if k == 0 else f"step {k - 1}"
        agree_within(f"chain {where} raw obs", HOST_CHECK_TOL, worst["raw_obs"])(got[-1], want[-1])
        tree_map(agree_within(f"chain {where} state", HOST_CHECK_TOL, worst["state"]), got[-2], want[-2])
        if k:
            raw.append(want[-1])
            agree_within(f"chain {where} reward", HOST_CHECK_TOL, worst["reward"])(
                torch.as_tensor(got[1]), torch.as_tensor(want[1]))
            check(torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]), f"chain {where}: flags differ")
        seen = torch.cat(raw).double()
        bound = 2 * HOST_CHECK_TOL * (1 + want[-1].double().abs()) / torch.sqrt(seen.var(0, unbiased=False) + 1e-8)
        err = (torch.as_tensor(got[0]).double() - torch.as_tensor(want[0]).double()).abs()
        check(bool((err <= bound).all()), f"chain {where}: normalised obs differ by {float(err.max())}")
        worst["normalised_obs"].append(float(err.max()))
    return {"envs": n, "steps": steps, "tolerance": HOST_CHECK_TOL,
            "max_abs_dev": {k: max(v) for k, v in worst.items()}}


def run_cartpole_episode_stats(n: int = NUM_ENVS, steps: int = VW_CARTPOLE_STEPS) -> dict:
    """``make_vec("CartPole-v1", n)`` on the card under RecordEpisodeStatistics
    and DictInfoToList: ``steps`` steps of sampled actions; each step's
    ``episode`` entries belong to exactly the envs whose episode ended, with
    a length of at least 8 steps and a return equal to it (CartPole pays 1 a
    step)."""
    import gymnasium_tpu_torch as gym
    import gymnasium_tpu_torch.wrappers.vector as V

    env = V.DictInfoToList(V.RecordEpisodeStatistics(gym.make_vec("CartPole-v1", n)))
    env.reset(seed=0)
    env.action_space.seed(0)
    ended, seconds = 0, 0.0
    for k in range(steps):
        action = env.action_space.sample()
        start = time.perf_counter()
        _, _, term, trunc, infos = env.step(action)
        seconds += time.perf_counter() - start
        done = (term | trunc).cpu().numpy()
        have = np.array(["episode" in info for info in infos])
        check(bool((have == done).all()), f"CartPole step {k}: episode entries {have.sum()} for {done.sum()} ends")
        for i in np.flatnonzero(done):
            episode = infos[i]["episode"]
            check(episode["l"] >= 8 and float(episode["r"]) == float(episode["l"]),
                  f"CartPole step {k}: env {i} episode {episode}")
        ended += int(done.sum())
    check(ended > n, f"CartPole: {ended} episodes ended in {steps} steps")
    return {"envs": n, "steps": steps, "episodes": ended, "ms_a_step": seconds * 1e3 / steps}


def changed_share(a: np.ndarray, b: np.ndarray) -> float:
    """The share of pixels where frames ``a`` and ``b`` differ."""
    return float((a != b).any(-1).mean())


def run_rendering(dev, folder: str) -> dict:
    """The render hooks and the rendering wrappers on the card.

    ``make("phys2d/CartPole-v1", render_mode="rgb_array")``: a (400, 600, 3)
    uint8 frame after the reset and each of 3 steps, equal to the hook's
    frame of the same state moved to the CPU. ``make("HalfCheetah-v5",
    render_mode="rgb_array_list")``: make's RenderCollection fallback, one
    frame for the reset and one a step over ``RENDER_STEPS`` steps.
    ObstructView over AddWhiteNoise over ``make("HalfCheetah-v5",
    render_mode="rgb_array")``: each frame differs from the env's own on a
    share of its pixels near what the two wrappers draw. RecordVideo of one
    ``RECORD_STEPS``-step episode into ``folder``: an ``.mp4`` where moviepy
    or OpenCV imports, else the ``.npz`` frame dump of JAX's fallback,
    whose frames are the episode's."""
    import gymnasium_tpu_torch as gym
    import gymnasium_tpu_torch.wrappers as W

    out = {}
    env = gym.make("phys2d/CartPole-v1", render_mode="rgb_array")
    inner = env.unwrapped
    check(inner.device.type == torch.device(dev).type, f"phys2d/CartPole-v1 on {inner.device}")
    env.reset(seed=0)
    for k in range(4):
        frame = inner.render()
        _, want = inner.func_env.render_image(inner.state.cpu(), inner.func_env.render_init(), inner.params)
        check(isinstance(frame, np.ndarray) and frame.shape == (400, 600, 3) and frame.dtype == np.uint8,
              f"phys2d/CartPole-v1 frame {getattr(frame, 'shape', None)}")
        check(np.array_equal(frame, want), f"phys2d/CartPole-v1 frame after {k} steps differs from the CPU hook's")
        if k < 3:
            env.step(k % 2)
    env.close()
    out["phys2d_cartpole"] = {"frame": [400, 600, 3], "frames_checked": 4}

    env = gym.make("HalfCheetah-v5", render_mode="rgb_array_list")
    check(type(env).__name__ == "RenderCollection" and env.render_mode == "rgb_array_list",
          f"make('HalfCheetah-v5', 'rgb_array_list') gave {type(env).__name__}")
    check(env.unwrapped.device.type == torch.device(dev).type, f"HalfCheetah on {env.unwrapped.device}")
    actions = np.random.default_rng(0).uniform(-1.0, 1.0, (RECORD_STEPS, 6)).astype(np.float32)
    env.reset(seed=0)
    start = time.perf_counter()
    for action in actions[:RENDER_STEPS]:
        env.step(action)
    collect_ms = (time.perf_counter() - start) * 1e3 / RENDER_STEPS
    frames = env.render()
    check(len(frames) == 1 + RENDER_STEPS and all(
        f.shape == (480, 480, 3) and f.dtype == np.uint8 for f in frames), f"RenderCollection gave {len(frames)} frames")
    check(env.render() == [], "RenderCollection kept frames after they were popped")
    env.close()
    out["render_collection"] = {"frames": len(frames), "ms_a_step": collect_ms}

    env = W.ObstructView(W.AddWhiteNoise(gym.make("HalfCheetah-v5", render_mode="rgb_array"), NOISE_SHARE),
                         OBSTRUCTED_SHARE, OBSTRUCTION_WIDTH)
    env.reset(seed=0)
    shares = []
    for action in actions[:RENDER_STEPS]:
        env.step(action)
        noisy, clean = env.render(), env.unwrapped.render()
        check(noisy.shape == clean.shape == (480, 480, 3) and noisy.dtype == np.uint8, "noisy frame shape")
        shares.append(changed_share(noisy, clean))
    env.close()
    # a noise pixel equals the frame's with probability about 1/255; obstructions overlap
    check(all(0.5 * NOISE_SHARE < share < NOISE_SHARE + 1.5 * OBSTRUCTED_SHARE for share in shares),
          f"noisy frames differ from the env's on {shares}")
    out["noise_and_obstruction"] = {"changed_share": [min(shares), max(shares)],
                                    "noise": NOISE_SHARE, "obstructed": OBSTRUCTED_SHARE}

    env = W.RecordVideo(gym.make("HalfCheetah-v5", render_mode="rgb_array", max_episode_steps=RECORD_STEPS),
                        folder, episode_trigger=lambda episode: episode == 0, name_prefix="half_cheetah")
    encoder = env._encoder
    env.reset(seed=0)
    for k, action in enumerate(actions):
        *_, trunc, _ = env.step(action)
        check(trunc == (k == RECORD_STEPS - 1), f"RecordVideo step {k}: truncated {trunc}")
    env.close()
    written = sorted(os.listdir(folder))
    suffix = ".npz" if encoder == "npz" else ".mp4"
    check(written == [f"half_cheetah-episode-0{suffix}"], f"RecordVideo ({encoder}) wrote {written}")
    path = os.path.join(folder, written[0])
    if encoder == "npz":
        dump = np.load(path)
        check(dump["frames"].shape == (1 + RECORD_STEPS, 480, 480, 3) and int(dump["fps"]) == env.frames_per_sec,
              f"RecordVideo's frame dump holds {dump['frames'].shape}")
    else:
        check(os.path.getsize(path) > 0, f"RecordVideo's {path} is empty")
    out["record_video"] = {"encoder": encoder, "file": written[0], "bytes": os.path.getsize(path),
                           "frames": 1 + RECORD_STEPS}
    return out


def launch_total(build_name: str) -> int:
    """The launches of ``build_name``'s articulated or planar kernel so far."""
    from gymnasium_tpu_torch.ops import articulated_step as art
    from gymnasium_tpu_torch.ops import planar_step as pl

    return art.launches[build_name] + pl.launches[build_name]


def checked_env(dev, env_id: str, build_name: str | None) -> dict:
    """``check_env(make(env_id, device=dev).unwrapped, skip_render_check=True)``:
    its seconds, the launches of ``build_name`` it made and the warnings it
    raised."""
    import warnings

    import gymnasium_tpu_torch as gym
    from gymnasium_tpu_torch.utils import check_env

    env = gym.make(env_id, disable_env_checker=True, device=dev).unwrapped
    check(env.device.type == torch.device(dev).type, f"{env_id} on {env.device}")
    before = launch_total(build_name) if build_name else 0
    start = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        check_env(env, skip_render_check=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    env.close()
    out = {"seconds": seconds, "warnings": [re.sub(r"\x1b\[[0-9;]*m", "", str(w.message)) for w in caught]}
    if build_name:
        out["launches"] = launch_total(build_name) - before
        check(out["launches"] > 0, f"check_env over {env_id} launched no {build_name}")
    return out


def matched_env(dev, env_id: str, steps: int = CHECKER_MATCH_STEPS, atol: float = CHECKER_MATCH_ATOL) -> dict:
    """``check_environments_match`` of ``make(env_id, device=dev)`` against
    ``make(env_id, device="cpu")``, observations and rewards within
    ``atol`` and infos with the same keys (``data_equivalence`` holds an
    info's float to its bits), after a run of the same seed and action
    stream that measures the largest deviation of each."""
    import gymnasium_tpu_torch as gym
    from gymnasium_tpu_torch.utils import check_environments_match

    card, cpu = gym.make(env_id, device=dev), gym.make(env_id, device="cpu")
    card_obs, cpu_obs = card.reset(seed=0)[0], cpu.reset(seed=0)[0]
    worst = {"obs": float(np.abs(card_obs - cpu_obs).max()), "reward": 0.0, "info": 0.0}
    scale = float(np.abs(cpu_obs).max())
    card.action_space.seed(0)
    for _ in range(steps):
        action = card.action_space.sample()
        got, want = card.step(action), cpu.step(action)
        worst["obs"] = max(worst["obs"], float(np.abs(got[0] - want[0]).max()))
        worst["reward"] = max(worst["reward"], abs(float(got[1]) - float(want[1])))
        check(got[4].keys() == want[4].keys(), f"{env_id}: info keys {list(got[4])} vs {list(want[4])}")
        for key, value in want[4].items():
            worst["info"] = max(worst["info"], float(np.abs(np.asarray(got[4][key], np.float64) - value).max()))
        scale = max(scale, float(np.abs(want[0]).max()))
        if got[2:4] != want[2:4]:
            worst["flags_differ"] = True
        if want[2] or want[3]:
            card.reset()
            cpu.reset()
    card.close()
    cpu.close()
    start = time.perf_counter()
    check_environments_match(gym.make(env_id, device=dev), gym.make(env_id, device="cpu"), num_steps=steps, seed=0,
                             atol=atol, info_comparison="keys-equivalence")
    return {"steps": steps, "atol": atol, "seconds": time.perf_counter() - start, "max_abs_dev": worst,
            "max_abs_cpu_obs": scale}


def run_numpy_to_torch(dev) -> dict:
    """``NumpyToTorch(make("CartPole-v1"), device=dev)`` and the vector
    form over ``make_vec("CartPole-v1", VEC_ENVS, "sync")``: tensors on
    ``dev`` out, actions on ``dev`` in, for ``NUMPY_TO_TORCH_STEPS`` steps
    each."""
    import gymnasium_tpu_torch as gym
    import gymnasium_tpu_torch.wrappers as W

    out = {}
    for label, env, shape in (
            ("single", W.NumpyToTorch(gym.make("CartPole-v1"), device=dev), ()),
            ("vector", W.vector.NumpyToTorch(gym.make_vec("CartPole-v1", VEC_ENVS, vectorization_mode="sync"),
                                             device=dev), (VEC_ENVS,))):
        obs, _ = env.reset(seed=0)
        on_dev = torch.device(dev).type
        check(isinstance(obs, torch.Tensor) and obs.device.type == on_dev, f"NumpyToTorch {label} reset obs")
        start = time.perf_counter()
        for k in range(NUMPY_TO_TORCH_STEPS):
            action = torch.full(shape, k % 2, dtype=torch.int64, device=dev)
            obs, reward, terminated, truncated, info = env.step(action)
            check(obs.device.type == on_dev and bool(torch.isfinite(obs).all()), f"NumpyToTorch {label} step {k}")
            if label == "vector":
                check(all(x.device.type == on_dev for x in (reward, terminated, truncated)),
                      f"NumpyToTorch vector step {k}: flags off the card")
            elif terminated or truncated:
                env.reset()
        out[label] = {"ms_a_step": (time.perf_counter() - start) * 1e3 / NUMPY_TO_TORCH_STEPS,
                      "obs": f"{obs.dtype} {tuple(obs.shape)} on {obs.device}"}
        env.close()
    return out


def is_numpy_tree(x) -> bool:
    if isinstance(x, dict):
        return all(is_numpy_tree(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return all(is_numpy_tree(v) for v in x)
    return not isinstance(x, torch.Tensor)


def run_array_conversion(dev, build_name: str, n: int = NUM_ENVS, steps: int = CONVERSION_STEPS) -> dict:
    """``ArrayConversion(make_vec("HalfCheetah-v5", n), "torch", "numpy")``
    against the bare env, in turns (bare, converted, converted, bare), each
    a fresh env from one seed: ``steps`` steps on the host clock after two
    untimed ones, one launch a step, every converted output numpy and equal
    to the bare env's."""
    import gymnasium_tpu_torch as gym
    import gymnasium_tpu_torch.wrappers as W

    actions = np.random.default_rng(0).uniform(-1.0, 1.0, (steps + 2, n, 6)).astype(np.float32)
    device_actions = torch.from_numpy(actions).to(dev)
    times, last = {"bare": [], "converted": []}, {}
    out = {"envs": n, "steps": steps}
    for label in ("bare", "converted", "converted", "bare"):
        env = gym.make_vec("HalfCheetah-v5", n, vector_kwargs={"device": dev})
        check(type(env).__name__ == "TorchVectorEnv", f"make_vec gave {type(env).__name__}")
        if label == "converted":
            env = W.vector.ArrayConversion(env, env_xp="torch", target_xp="numpy")
        env.reset(seed=0)
        batch = actions if label == "converted" else device_actions
        for k in range(2):
            env.step(batch[k])
        torch.cuda.synchronize()
        before = launch_total(build_name)
        start = time.perf_counter()
        for k in range(2, steps + 2):
            result = env.step(batch[k])
        torch.cuda.synchronize()
        times[label].append((time.perf_counter() - start) * 1e3 / steps)
        launched = launch_total(build_name) - before
        check(launched == steps, f"{label} HalfCheetah: {launched} launches in {steps} steps")
        if label == "converted":
            check(is_numpy_tree(result) and isinstance(result[0], np.ndarray) and result[0].shape == (n, 17),
                  f"ArrayConversion handed out {[type(x).__name__ for x in result]}")
            out["outputs"] = [f"{type(x).__name__}{getattr(x, 'shape', '')}" for x in result]
            last[label] = result[0]
        else:
            last[label] = result[0].cpu().numpy()
        env.close()
    check(np.array_equal(last["converted"], last["bare"]), "ArrayConversion's last observation differs from the bare env's")
    for label, runs in times.items():
        out[f"{label}_ms_a_step"] = sum(runs) / len(runs)
        out[f"{label}_ms_a_step_runs"] = runs
    out["launches_a_step"] = 1
    return out


def run_step_api_round_trip(dev, n: int = STEP_API_ENVS, steps: int = STEP_API_STEPS) -> dict:
    """``convert_to_done_step_api`` then ``convert_to_terminated_truncated_step_api``
    over ``steps`` steps of ``make_vec("HalfCheetah-v5", n)`` truncating every
    ``STEP_API_LIMIT`` steps: the round trip gives back each step's flags."""
    import gymnasium_tpu_torch as gym
    from gymnasium_tpu_torch.utils import convert_to_done_step_api, convert_to_terminated_truncated_step_api

    env = gym.make_vec("HalfCheetah-v5", n, vector_kwargs={"max_episode_steps": STEP_API_LIMIT, "device": dev})
    env.reset(seed=0)
    truncations = 0
    for k in range(steps):
        step = env.step(torch.zeros(n, 6, device=dev))
        terminated, truncated = step[2].cpu().numpy(), step[3].cpu().numpy()
        done_step = convert_to_done_step_api(step, is_vector_env=True)
        check(np.array_equal(done_step[2], terminated | truncated), f"step {k}: done")
        _, _, term, trunc, _ = convert_to_terminated_truncated_step_api(done_step, is_vector_env=True)
        check(np.array_equal(term, terminated) and np.array_equal(trunc, truncated & ~terminated),
              f"step {k}: the round trip changed the flags")
        truncations += int(truncated.sum())
    env.close()
    check(truncations > 0, f"no truncation in {steps} steps")
    return {"envs": n, "steps": steps, "truncations": truncations}


def run_play(dev, build_name: str, frames: int = PLAY_FRAMES) -> dict:
    """``play`` over ``make("LunarLander-v3", render_mode="rgb_array", device=dev)``
    under ``SDL_VIDEODRIVER=dummy`` for ``frames`` steps, ended by a callback
    that posts ``pygame.QUIT``; without pygame, ``play`` must raise
    ``DependencyNotInstalled``."""
    import gymnasium_tpu_torch as gym
    from gymnasium_tpu_torch.error import DependencyNotInstalled
    from gymnasium_tpu_torch.utils import play

    env = gym.make("LunarLander-v3", render_mode="rgb_array", device=dev)
    try:
        import pygame
    except ImportError:
        try:
            play(env, keys_to_action=PLAY_KEYS)
        except DependencyNotInstalled as e:
            env.close()
            return {"branch": "pygame absent: DependencyNotInstalled", "message": str(e)}
        check(False, "play ran without pygame")
    previous = os.environ.get("SDL_VIDEODRIVER")
    os.environ["SDL_VIDEODRIVER"] = "dummy"
    seen = []

    def callback(obs_t, obs_tp1, action, rew, terminated, truncated, info):
        seen.append(action)
        if len(seen) == frames:
            pygame.event.post(pygame.event.Event(pygame.QUIT))

    before = launch_total(build_name)
    start = time.perf_counter()
    try:
        play(env, fps=1000, callback=callback, keys_to_action=PLAY_KEYS, seed=0)
    finally:
        if previous is None:
            os.environ.pop("SDL_VIDEODRIVER", None)
        else:
            os.environ["SDL_VIDEODRIVER"] = previous
    seconds = time.perf_counter() - start
    launches = launch_total(build_name) - before
    env.close()
    check(len(seen) == frames, f"play took {len(seen)} steps, want {frames}")
    # each step one launch, each of play's two seeded resets one settle tick
    check(launches >= frames, f"play launched {launches} planar kernels over {frames} steps")
    return {"branch": f"pygame {pygame.version.ver}, SDL_VIDEODRIVER=dummy", "frames": len(seen),
            "launches": launches, "seconds": seconds}


def run_examples(dev, timeout: int = EXAMPLE_TIMEOUT_S) -> dict:
    """Each of the four examples as a process of its own on ``dev``, all at
    once, at ``EXAMPLE_ARGS``: each must exit 0."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root}
    start = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, os.path.join(root, "examples", name), "--device", str(dev), *args],
                                    cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, args in EXAMPLE_ARGS.items()}
    out = {}
    for name, proc in procs.items():
        try:
            text, _ = proc.communicate(timeout=max(1.0, timeout - (time.perf_counter() - start)))
        except subprocess.TimeoutExpired:
            for other in procs.values():
                other.kill()
                other.wait()
            check(False, f"example {name} did not end within {timeout} s")
        out[name] = {"rc": proc.returncode, "last_line": text.strip().splitlines()[-1] if text.strip() else ""}
        check(proc.returncode == 0, f"example {name} exited {proc.returncode}: {text[-2000:]}")
    out["seconds_all"] = time.perf_counter() - start
    return out


def run_checkers_and_conversion(dev, hc_build: str, lander_build: str) -> dict:
    """The env checkers, the array conversions, the step-API converters,
    ``play`` and the four examples on the card; each part's launches of
    HalfCheetah's and LunarLander's kernels under ``launches_by_part``."""
    builds = {"articulated": hc_build, "planar": lander_build, "functional torch": None}
    parts = {
        **{f"check_env({env_id})": functools.partial(checked_env, dev, env_id, builds[path])
           for env_id, path in CHECKER_IDS.items()},
        **{f"check_environments_match({env_id})": functools.partial(matched_env, dev, env_id)
           for env_id in CHECKER_MATCH_IDS},
        "NumpyToTorch": functools.partial(run_numpy_to_torch, dev),
        "ArrayConversion": functools.partial(run_array_conversion, dev, hc_build),
        "step-API round trip": functools.partial(run_step_api_round_trip, dev),
        "play": functools.partial(run_play, dev, lander_build),
        "examples": functools.partial(run_examples, dev),
    }
    out = {"launches_by_part": {}}
    for label, part in parts.items():
        before = {name: launch_total(name) for name in (hc_build, lander_build)}
        out[label] = part()
        out["launches_by_part"][label] = {name: launch_total(name) - before[name] for name in before}
    for env_id, path in CHECKER_IDS.items():
        out[f"check_env({env_id})"]["path"] = path
    return out


def run_benchmark_step() -> dict:
    """``utils.performance.benchmark_step`` for :data:`BENCHMARK_SECONDS` of
    ``make("CartPole-v1")`` (host) and of ``make("HalfCheetah-v5")`` on the
    card, whose steps a wrapper counts: the articulated build must launch
    once a step and never at a reset."""
    import gymnasium_tpu_torch as gym
    from gymnasium_tpu_torch.core import Wrapper
    from gymnasium_tpu_torch.ops import articulated_step as art
    from gymnasium_tpu_torch.utils.performance import benchmark_step

    class CountSteps(Wrapper):
        steps = 0

        def step(self, action):
            self.steps += 1
            return self.env.step(action)

    cartpole = CountSteps(gym.make("CartPole-v1"))
    art.launches.clear()
    cartpole_rate = benchmark_step(cartpole, BENCHMARK_SECONDS, seed=0)
    check(not art.launches, f"benchmark_step of CartPole-v1 launched {dict(art.launches)}")
    cheetah = CountSteps(gym.make("HalfCheetah-v5"))
    build_name = cheetah.unwrapped._step.build_name
    cheetah_rate = benchmark_step(cheetah, BENCHMARK_SECONDS, seed=0)
    check(dict(art.launches) == {build_name: cheetah.steps},
          f"benchmark_step of HalfCheetah-v5: launches {dict(art.launches)} over {cheetah.steps} steps")
    print(f"benchmark_step ({BENCHMARK_SECONDS} s): CartPole-v1 {cartpole_rate:.1f} steps/s host "
          f"({cartpole.steps} steps); HalfCheetah-v5 {cheetah_rate:.1f} steps/s on the card "
          f"({cheetah.steps} steps, {cheetah.steps} launches)", flush=True)
    return {"cartpole_steps_per_s": cartpole_rate, "cartpole_steps": cartpole.steps,
            "half_cheetah_steps_per_s": cheetah_rate, "half_cheetah_steps": cheetah.steps,
            "half_cheetah_launches": cheetah.steps}


def launch_us(dev, launches: int = 2000) -> float:
    """Host-clock microseconds a launch of a one-element ``add_``, over
    ``launches`` back-to-back launches ended by a synchronisation: the
    host's price of one eager kernel launch."""
    x = torch.zeros(1, device=dev)
    x.add_(1)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(launches):
        x.add_(1)
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e6 / launches


def run_compiled_rollout(dev, registry_rate: float, early_launch_us: float, n: int = NUM_ENVS) -> dict:
    """``benchmark_compiled_rollout(make_vec("HalfCheetah-v5", n))``, beside
    the registry phase's ``rollout(REGISTRY_ROLLOUT)`` rate of the same env
    and the host's price of a launch now and before the first profiled
    phase (``early_launch_us``)."""
    import gymnasium_tpu_torch as gym
    from gymnasium_tpu_torch.ops import articulated_step as art
    from gymnasium_tpu_torch.utils.performance import benchmark_compiled_rollout

    env = gym.make_vec("HalfCheetah-v5", n)
    check(env.device.type == torch.device(dev).type, f"make_vec on {env.device}")
    build_name = env.func_env._step.build_name
    before = art.launches[build_name]
    out = benchmark_compiled_rollout(env, num_steps=COMPILED_ROLLOUT_STEPS, repeats=COMPILED_ROLLOUT_REPEATS)
    launched = art.launches[build_name] - before
    want = COMPILED_ROLLOUT_STEPS * (1 + COMPILED_ROLLOUT_REPEATS)
    check(launched == want, f"benchmark_compiled_rollout launched {launched}, want {want}")
    check(set(out) == {"steps_per_second", "first_call_seconds", "steady_state_seconds_per_rollout"}
          and all(v > 0 and math.isfinite(v) for v in out.values()), f"benchmark_compiled_rollout gave {out}")
    # one more rollout of the same env, timed as the registry phase times its own
    torch.cuda.synchronize()
    start = time.perf_counter()
    env.rollout(COMPILED_ROLLOUT_STEPS)
    torch.cuda.synchronize()
    again = n * COMPILED_ROLLOUT_STEPS / (time.perf_counter() - start)
    now_launch_us = launch_us(dev)
    print(f"benchmark_compiled_rollout(make_vec('HalfCheetah-v5', {n}), num_steps={COMPILED_ROLLOUT_STEPS}, "
          f"repeats={COMPILED_ROLLOUT_REPEATS}): {json.dumps(out)}; the registry phase's rollout("
          f"{REGISTRY_ROLLOUT}) of the same env: {registry_rate:.1f} env-steps/s; one more rollout of this env "
          f"timed as the registry phase times it: {again:.1f} env-steps/s; host us a launch now "
          f"{now_launch_us:.2f}, before the first profiled phase {early_launch_us:.2f}; clocks.sm, power.draw "
          f"{query_gpu('clocks.sm,power.draw')}", flush=True)
    return {**out, "launches": launched, "registry_rollout_steps_per_second": registry_rate,
            "one_more_rollout_steps_per_second": again, "launch_us": now_launch_us,
            "launch_us_before_the_first_profile": early_launch_us}


def run_trace(dev, log_root: str, n: int = NUM_ENVS, steps: int = TRACE_ENV_STEPS) -> dict:
    """``utils.performance.trace`` around ``steps`` steps of
    ``make_vec("HalfCheetah-v5", n)``, closed by a synchronisation: the
    Chrome trace written under its directory must hold the articulated
    kernel ``steps`` times or more. A trace loses the events of its first
    moments: one opened right before the steps held 4 of their 5 launches in
    each of five tries. So the trace opens with :data:`TRACE_OPENING_S` of
    small kernels and a synchronisation before the steps, as
    :func:`profile_host_env_step` does, and a trace that still holds fewer is
    taken again, up to five times; ``tries`` counts them."""
    import gymnasium_tpu_torch as gym
    from gymnasium_tpu_torch.utils.performance import trace

    env = gym.make_vec("HalfCheetah-v5", n)
    env.reset(seed=0)
    gen = torch.Generator(device=dev).manual_seed(4)
    actions = [env.single_action_space.sample_torch(gen, (n,)) for _ in range(steps)]
    torch.cuda.synchronize()
    for tries in range(1, 6):
        log_dir = os.path.join(log_root, f"trace_{tries}")
        with trace(log_dir):
            opened, filler = time.perf_counter(), torch.zeros(1, device=dev)
            while time.perf_counter() - opened < TRACE_OPENING_S:
                filler.add_(1)
            torch.cuda.synchronize()
            for action in actions:
                env.step(action)
            torch.cuda.synchronize()
        files = [os.path.join(log_dir, f) for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
        check(len(files) == 1, f"trace wrote {files}")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        named = [e for e in kernels if "ArticulatedStep" in e.get("name", "")]
        if len(named) >= steps:
            break
        print(f"run_trace: try {tries} named the articulated kernel {len(named)} times in {len(kernels)} kernels",
              flush=True)
    check(len(named) >= steps, f"the trace named the articulated kernel {len(named)} times, want {steps}")
    out = {"steps": steps, "tries": tries, "trace_bytes": os.path.getsize(files[0]), "events": len(events),
           "kernels": len(kernels), "articulated_kernels": len(named), "name": named[0]["name"][:80]}
    print(f"trace around {steps} HalfCheetah steps at {n} envs: {json.dumps(out)}", flush=True)
    return out


def tree_leaves(x) -> list:
    """The tensors and generators of a tree of NamedTuples, tuples, lists and dicts."""
    if isinstance(x, (torch.Tensor, torch.Generator)):
        return [x]
    if isinstance(x, dict):
        return [leaf for v in x.values() for leaf in tree_leaves(v)]
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in tree_leaves(v)]
    return []


def same_ppo_step(label: str, a, ma, b, mb) -> int:
    """Raises unless two PPO states after a train step and their metrics are
    equal in every bit: the parameters, every Adam moment and ``step`` with
    the param groups, every carry leaf with its generator's state, ``obs``,
    the trainer's generator and ``update_count``. Returns the values compared."""
    pairs = [(f"parameter {name}", p, q) for (name, p), (_, q)
             in zip(a.policy.named_parameters(), b.policy.named_parameters())]
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    check(sa["param_groups"] == sb["param_groups"] and list(sa["state"]) == list(sb["state"]),
          f"{label}: Adam's param groups or states differ")
    pairs += [(f"adam {k} {key}", v, sb["state"][k][key]) for k in sa["state"] for key, v in sa["state"][k].items()]
    carry_a, carry_b = tree_leaves(a.env_carry), tree_leaves(b.env_carry)
    check(len(carry_a) == len(carry_b), f"{label}: the carries differ in structure")
    pairs += [(f"carry leaf {i}", x, y) for i, (x, y) in enumerate(zip(carry_a, carry_b))]
    pairs += [("obs", a.obs, b.obs), ("rng", a.rng, b.rng), ("update_count", a.update_count, b.update_count)]
    pairs += [(f"metric {k}", ma[k], mb[k]) for k in ma]
    for name, x, y in pairs:
        if isinstance(x, torch.Generator):
            check(x.device == y.device and torch.equal(x.get_state(), y.get_state()), f"{label}: {name} state differs")
        else:
            check(same_bits(x.detach(), y.detach()), f"{label}: {name} differs")
    return len(pairs)


def run_checkpoint(dev, tmp: str) -> dict:
    """The HalfCheetah PPO workload of :func:`ppo_case` at its widths: one
    train step, ``save_pytree`` of the state, one step (A); then two fresh
    ``init_ppo(seed=1)`` states restored from the file, one step each (B1,
    B2). B1 must equal B2 in every bit (the card's train step is
    deterministic) and A (the resume is exact); each train step launches the
    articulated kernel once an env step."""
    from gymnasium_tpu_torch.ops import articulated_step as art
    from gymnasium_tpu_torch.train.ppo import init_ppo, make_train_step
    from gymnasium_tpu_torch.utils.checkpoint import restore_pytree, save_pytree

    func_env, config, wrappers = ppo_case("half_cheetah")
    build_name = func_env._step.build_name
    state, env_params = init_ppo(func_env, config, seed=0, wrappers=wrappers, device=dev)
    train_step = make_train_step(func_env, config, env_params, wrappers)

    def step(s):
        before = art.launches[build_name]
        s, metrics = train_step(s)
        torch.cuda.synchronize()
        launched = art.launches[build_name] - before
        check(launched == config.rollout_steps, f"a train step launched {launched}, want {config.rollout_steps}")
        return s, metrics

    state, _ = step(state)
    start = time.perf_counter()
    path = save_pytree(os.path.join(tmp, "ppo_half_cheetah"), state)
    save_s = time.perf_counter() - start
    file_bytes = os.path.getsize(path)
    with np.load(path, allow_pickle=False) as data:
        leaves = len(data.files) - 1
    a, metrics_a = step(state)
    restored, restore_s = [], []
    for _ in range(2):
        fresh, _ = init_ppo(func_env, config, seed=1, wrappers=wrappers, device=dev)
        torch.cuda.synchronize()
        start = time.perf_counter()
        r = restore_pytree(path, fresh)
        torch.cuda.synchronize()
        restore_s.append(time.perf_counter() - start)
        check(r.policy is fresh.policy and r.optimizer is fresh.optimizer and r.rng is fresh.rng,
              "restore_pytree did not load into the template's objects")
        restored.append(step(r))
    (b1, metrics_b1), (b2, metrics_b2) = restored
    deterministic = same_ppo_step("two steps from one restored state", b1, metrics_b1, b2, metrics_b2)
    compared = same_ppo_step("the resumed step against the uninterrupted one", a, metrics_a, b1, metrics_b1)
    out = {"envs": config.num_envs, "rollout_steps": config.rollout_steps, "hidden_sizes": list(config.hidden_sizes),
           "file_bytes": file_bytes, "leaves": leaves, "save_s": save_s, "restore_s": restore_s,
           "values_compared": compared, "deterministic_values_compared": deterministic,
           "train_steps": 4, "launches_a_train_step": config.rollout_steps}
    print(f"checkpoint of the HalfCheetah PPO state ({config.num_envs} x {config.rollout_steps}): "
          f"{file_bytes} bytes in {leaves} leaves, save {save_s:.4f} s, restore {restore_s[0]:.4f} s and "
          f"{restore_s[1]:.4f} s; two steps from the restored state equal in {deterministic} values, the resumed "
          f"step equals the uninterrupted one in {compared} values", flush=True)
    return out


def check_torch_generator(dev) -> dict:
    """``torch_generator(0, dev)`` draws what ``torch.Generator(dev).manual_seed(0)`` draws."""
    from gymnasium_tpu_torch.utils.seeding import torch_generator

    ours, theirs = torch_generator(0, dev), torch.Generator(device=dev).manual_seed(0)
    check(ours.device.type == torch.device(dev).type, f"torch_generator on {ours.device}")
    for draw in (torch.rand, torch.randn):
        got = draw(GENERATOR_DRAWS, generator=ours, device=dev)
        want = draw(GENERATOR_DRAWS, generator=theirs, device=dev)
        check(same_bits(got, want), f"torch_generator(0) draws differ from manual_seed(0)'s ({draw.__name__})")
    return {"draws": 2 * GENERATOR_DRAWS, "bit_equal": True, "device": str(ours.device)}


def run_device_spaces(dev, n: int = NUM_ENVS) -> dict:
    """``sample_torch`` of ``Tuple(Box, Discrete)``, ``Dict`` and
    ``MultiBinary`` at batch ``n`` on the card: on the device, inside the
    space (``contains_torch``), and two draws differ."""
    from gymnasium_tpu_torch import spaces

    cases = {
        "Tuple(Box, Discrete)": spaces.Tuple([spaces.Box(-1.0, 2.0, (3,)), spaces.Discrete(6, start=-2)]),
        "Dict": spaces.Dict({"u": spaces.Box(0.0, 1.0, (2,)), "k": spaces.Discrete(4), "m": spaces.MultiBinary(3)}),
        "MultiBinary": spaces.MultiBinary([2, 3]),
    }

    def leaves(x):
        if isinstance(x, dict):
            return [leaf for key in x for leaf in leaves(x[key])]
        return [leaf for part in x for leaf in leaves(part)] if isinstance(x, tuple) else [x]

    gen = torch.Generator(device=dev).manual_seed(3)
    result = {}
    for name, space in cases.items():
        first, second = space.sample_torch(gen, (n,)), space.sample_torch(gen, (n,))
        check(all(leaf.device.type == torch.device(dev).type and leaf.shape[0] == n for leaf in leaves(first)),
              f"{name}: samples not on the device")
        check(bool(space.contains_torch(first)) and bool(space.contains_torch(second)), f"{name}: sample outside")
        check(any(not torch.equal(a, b) for a, b in zip(leaves(first), leaves(second))), f"{name}: two draws equal")
        result[name] = [f"{tuple(leaf.shape)} {leaf.dtype}" for leaf in leaves(first)]
    return result


def ppo_case(name: str, n: int = NUM_ENVS, rollout: int = PPO_ROLLOUT, compute_dtype=torch.bfloat16):
    """``(func_env, config, wrappers)`` of a PPO workload of ``tools/bench_ppo.py``,
    HalfCheetah with the episode statistics of the multichip dry run added."""
    from gymnasium_tpu_torch.train.ppo import PPOConfig
    from gymnasium_tpu_torch.wrappers.func import EpisodeStatistics, NormalizeObservation, NormalizeReward

    if name == "cartpole":
        from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional

        config = PPOConfig(num_envs=n, rollout_steps=rollout, hidden_sizes=(128, 128), compute_dtype=compute_dtype)
        return CartPoleFunctional(), config, ()
    from gymnasium_tpu_torch.envs.mujoco.half_cheetah import HalfCheetahFunctional

    config = PPOConfig(num_envs=n, rollout_steps=rollout, hidden_sizes=(256, 256), max_episode_steps=ART_TIME_LIMIT,
                       compute_dtype=compute_dtype)
    return HalfCheetahFunctional(), config, (NormalizeObservation(), NormalizeReward(), EpisodeStatistics())


def ppo_phase_times(step, state, kernel: str | None, launches: int):
    """One train step under ``torch.profiler``: for each phase, its span on
    the device's timeline (the range its ``record_function`` shows there),
    the device time of the kernels that start inside that span (one stream
    runs them in order, so the backward's kernels, launched from autograd's
    own thread, count in the update), and the host time of its range; the
    device's busy time and the wall time of the step. A trace that did not
    see ``launches`` launches of ``kernel`` is taken again with another train
    step, up to five times (the profiler drops a trace's events now and
    then); ``profiled_steps`` counts the steps taken."""
    from torch.profiler import ProfilerActivity, profile

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    for tries in range(1, 6):
        torch.cuda.synchronize()
        start = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, _ = step(state)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
        events = prof.events()
        # a record_function range also shows on the device's timeline: not a kernel
        device = [e for e in events if e.device_type == cuda and not e.is_user_annotation]
        seen = sum(kernel in e.name for e in device) if kernel else 0
        if seen == launches:
            break
    check(seen == launches, f"the profiler saw {seen} of {launches} launches of {kernel}")
    phases = {}
    for name in PPO_PHASES:
        host = [e for e in events if e.name == name and e.device_type == cpu]
        spans = [e.time_range for e in events if e.name == name and e.device_type == cuda and e.is_user_annotation]
        check(len(host) == 1 and spans, f"{name}: {len(host)} host ranges, {len(spans)} device spans")
        lo, hi = min(r.start for r in spans), max(r.end for r in spans)
        inside = [e.time_range.elapsed_us() for e in device if lo <= e.time_range.start < hi]
        phases[name] = {"device_ms": sum(inside) / 1e3, "kernels": len(inside), "device_span_ms": (hi - lo) / 1e3,
                        "host_ms": host[0].cpu_time_total / 1e3}
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    check(busy_ms > 0 and all(p["device_ms"] > 0 for p in phases.values()), f"no device time in {phases}")
    return state, {"phases": phases, "device_busy_ms": busy_ms, "kernels": len(device),
                   "profiled_wall_ms": wall_ms, "device_busy_share": busy_ms / wall_ms, "profiled_steps": tries}


def run_ppo(dev, name: str, n: int = NUM_ENVS, rollout: int = PPO_ROLLOUT, timed: int = PPO_TIMED_STEPS) -> dict:
    """The port's PPO trainer: one untimed train step, ``timed`` steps each
    ended by a synchronise, then one under the profiler. Checks that every
    metric is finite and the parameters changed, that CartPole finished
    episodes, that the normalisation counts grew by a batch an env step, and
    that a HalfCheetah train step launched the articulated kernel once an env
    step. Returns the host-clock env-steps/s, the step times and the phase
    split."""
    from gymnasium_tpu_torch.ops import articulated_step as art
    from gymnasium_tpu_torch.train.ppo import init_ppo, make_train_step

    func_env, config, wrappers = ppo_case(name, n, rollout)
    state, env_params = init_ppo(func_env, config, seed=0, wrappers=wrappers, device=dev)
    step = make_train_step(func_env, config, env_params, wrappers)
    before = [p.detach().clone() for p in state.policy.parameters()]
    build = getattr(func_env, "_step", None)
    build_name = build.build_name if build is not None else None

    torch.cuda.synchronize()
    start = time.perf_counter()
    state, metrics = step(state)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - start) * 1e3
    all_metrics, times, counts = [metrics], [], []
    for k in range(timed):
        launched = art.launches[build_name] if build_name else 0
        start = time.perf_counter()
        state, metrics = step(state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        if build_name:
            per_step = art.launches[build_name] - launched
            check(per_step == rollout, f"{name}: {per_step} articulated launches in a train step, want {rollout}")
        all_metrics.append(metrics)
        if wrappers:
            counts.append((float(state.env_carry.wrappers[0].count), float(state.env_carry.wrappers[1].rms.count)))
    state, profiled = ppo_phase_times(step, state, "ArticulatedStep" if build_name else None,
                                      rollout if build_name else 0)

    for i, m in enumerate(all_metrics):
        for key, value in m.items():
            check(bool(torch.isfinite(value.float())), f"{name} step {i}: {key} = {value}")
        if name == "cartpole":
            check(int(m["episodes_finished"]) > 0, f"cartpole step {i}: no episode finished")
    after = list(state.policy.parameters())
    check(all(bool(torch.isfinite(p).all()) for p in after), f"{name}: a parameter is not finite")
    check(any(not torch.equal(a, b) for a, b in zip(after, before)), f"{name}: no parameter changed")
    steps_taken = 1 + timed + profiled["profiled_steps"]
    check(int(state.update_count) == steps_taken, f"{name}: update_count {int(state.update_count)}, want {steps_taken}")
    batch = n * rollout
    for k, (obs_count, rew_count) in enumerate(counts, start=2):
        want = 1e-4 + n * (1 + rollout * k)
        check(abs(obs_count - want) <= 1e-6 * want, f"{name}: obs count {obs_count} after {k} steps, want {want}")
    for (_, a), (_, b) in zip(counts, counts[1:]):
        check(b - a == batch, f"{name}: the return statistics grew by {b - a}, want {batch}")
    mean_ms = sum(times) / len(times)
    result = {
        "num_envs": n,
        "rollout_steps": rollout,
        "hidden_sizes": list(config.hidden_sizes),
        "wrappers": [type(w).__name__ for w in wrappers],
        "env_steps_per_s": batch * timed / (sum(times) / 1e3),
        # device time of the profiled step over the mean host time of a timed
        # one: the profiler slows the host, not the kernels
        "device_busy_share_of_timed_step": profiled["device_busy_ms"] / mean_ms,
        "step_ms": times,
        "first_step_ms": first_ms,
        **profiled,
        "metrics": {k: float(v) for k, v in all_metrics[-1].items()},
    }
    if build_name:
        result["articulated_launches_per_step"] = rollout
    print(f"ppo {name}: {result['env_steps_per_s']:.4e} env-steps/s host clock, step ms "
          + " ".join(f"{t:.2f}" for t in times)
          + "; phases " + ", ".join(f"{k} device {v['device_ms']:.3f} ms host {v['host_ms']:.3f} ms"
                                    for k, v in profiled["phases"].items())
          + f"; device busy {profiled['device_busy_ms']:.3f} ms, {profiled['device_busy_share']:.2%} of the "
          f"profiled step, {result['device_busy_share_of_timed_step']:.2%} of a timed one", flush=True)
    return result


def move_carry(src, like, dev):
    """``src``'s tensors moved to ``dev``, with ``like``'s generator (a tree
    of one structure on that device)."""
    from gymnasium_tpu_torch.functional import tree_map

    return tree_map(lambda a, b: a.to(dev) if isinstance(a, torch.Tensor) else b, src, like)


def compare_ppo_with_cpu(dev, n: int = PPO_CHECK_ENVS, rollout: int = PPO_CHECK_STEPS) -> dict:
    """One float32 HalfCheetah train step with the wrapper stack and injected
    draws on ``dev`` against the same step on the CPU, from one state. Raises
    if a metric, wrapper statistic, observation or parameter differs by more
    than ``PPO_CHECK_TOL`` (relative and absolute). Returns the largest
    deviation of each."""
    from gymnasium_tpu_torch.train.ppo import PPODraws, init_ppo, make_train_step

    func_env, config, wrappers = ppo_case("half_cheetah", n, rollout, torch.float32)
    cpu_state, env_params = init_ppo(func_env, config, seed=1, wrappers=wrappers, device="cpu")
    dev_state, _ = init_ppo(func_env, config, seed=1, wrappers=wrappers, device=dev)
    dev_state = dev_state._replace(env_carry=move_carry(cpu_state.env_carry, dev_state.env_carry, dev),
                                   obs=cpu_state.obs.to(dev))
    g = torch.Generator().manual_seed(2)
    nu = func_env.action_space.shape[0]
    draws = PPODraws(torch.randn((rollout, n, nu), generator=g),
                     torch.stack([torch.randperm(rollout, generator=g) for _ in range(config.update_epochs)]))
    step = make_train_step(func_env, config, env_params, wrappers)
    cpu_new, cpu_metrics = step(cpu_state, draws)
    dev_new, dev_metrics = step(dev_state, PPODraws(*(x.to(dev) for x in draws)))
    torch.cuda.synchronize()

    def deviation(label, got, want):
        got, want = got.detach().cpu().double(), want.detach().double()
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / (PPO_CHECK_TOL + PPO_CHECK_TOL * want.abs())).max())
        check(rel <= 1.0, f"ppo device vs cpu: {label} differs by {err}")
        return err

    errs = {key: deviation(key, dev_metrics[key], cpu_metrics[key]) for key in ("loss", "reward_per_step", "mean_value")}
    check(int(dev_metrics["episodes_finished"]) == int(cpu_metrics["episodes_finished"]), "episodes_finished differ")
    (d_obs, d_rew, d_eps), (c_obs, c_rew, c_eps) = dev_new.env_carry.wrappers, cpu_new.env_carry.wrappers
    errs["obs_statistics"] = max(deviation("obs " + k, getattr(d_obs, k), getattr(c_obs, k)) for k in ("mean", "var"))
    errs["return_statistics"] = max(deviation("return " + k, getattr(d_rew.rms, k), getattr(c_rew.rms, k))
                                    for k in ("mean", "var"))
    errs["episode_return"] = deviation("episode return", d_eps.episode_return, c_eps.episode_return)
    check(torch.equal(d_eps.episode_length.cpu(), c_eps.episode_length), "episode lengths differ")
    errs["obs"] = deviation("obs", dev_new.obs, cpu_new.obs)
    errs["parameters"] = max(deviation(name, p, q) for (name, p), (_, q)
                             in zip(dev_new.policy.named_parameters(), cpu_new.policy.named_parameters()))
    print(f"ppo half_cheetah train step on the card vs the CPU (float32, N={n}, T={rollout}, injected draws, "
          f"TF32 off): largest deviations {errs}", flush=True)
    return errs


def run_entry() -> None:
    from gymnasium_tpu_torch.entry import entry

    forward_step, (policy, carry, rng) = entry()
    for _ in range(4):
        carry, obs, reward, logits, actions = forward_step(policy, carry, rng)
    torch.cuda.synchronize()
    check(logits.shape == (256, 2) and bool(torch.isfinite(logits).all()), "entry logits")
    check(bool(((actions == 0) | (actions == 1)).all()), "entry actions not in {0, 1}")
    check(bool(torch.isfinite(obs).all()), "entry obs not finite")


def ranged(func, hook: str, label: str):
    """A shallow copy of the functional env ``func`` whose ``hook`` runs
    inside ``torch.profiler.record_function(label)``."""
    env = copy.copy(func)
    inner = getattr(func, hook)

    def call(*args, **kwargs):
        with torch.profiler.record_function(label):
            return inner(*args, **kwargs)

    setattr(env, hook, call)
    return env

def sharded_and_plain(dev, func, limit: int, steps: int, mesh) -> dict:
    """``rollout(steps)`` of ``func`` at 4096 envs from seed 0, sharded over
    ``mesh``'s dp axis and on this card alone, each after an untimed
    one-step rollout; raises unless this rank's rows of every trajectory
    leaf and of the final state are the same bits, and the gathered
    trajectory the whole one. Returns the seconds of both and the launches
    of the sharded run."""
    from gymnasium_tpu_torch.parallel.mesh import NamedSharding, gather_trajectory, local
    from gymnasium_tpu_torch.vector.torch_vector_env import TorchVectorEnv

    kw = dict(max_episode_steps=limit, seed=0, device=dev)
    plain = TorchVectorEnv(func, NUM_ENVS, **kw)
    plain.reset()
    plain.rollout(1)  # untimed: the first call of each path sets up its caches
    torch.cuda.synchronize()
    start = time.perf_counter()
    plain.reset()
    plain_carry, plain_traj = plain.rollout(steps)
    torch.cuda.synchronize()
    plain_seconds = time.perf_counter() - start
    sharded = TorchVectorEnv(func, NUM_ENVS, sharding=NamedSharding(mesh, ("dp",)), **kw)
    sharded.reset()
    sharded.rollout(1)
    before = dict(kernel_launches())
    torch.cuda.synchronize()
    start = time.perf_counter()
    sharded.reset()
    carry, traj = sharded.rollout(steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {k: v - before.get(k, 0) for k, v in kernel_launches().items() if v - before.get(k, 0)}
    shard = sharded._shard_of(carry)
    rows = lambda x, dim=0: shard.take(x, dim)  # noqa: E731
    compared = 0
    for key in ("obs", "reward", "terminated", "truncated"):
        check(same_bits(local(getattr(traj, key)), rows(getattr(plain_traj, key), 1)), f"sharded {key} differs")
        compared += 1
    for got, want in zip(tree_leaves(local(carry.state)), tree_leaves(plain_carry.state)):
        check(same_bits(got, rows(want)), "a sharded state leaf differs")
        compared += 1
    gathered = gather_trajectory(traj, mesh)
    for key in ("obs", "reward"):
        check(same_bits(local(getattr(gathered, key)), getattr(plain_traj, key)), f"gathered {key} differs")
    resets = int((plain_traj.terminated | plain_traj.truncated).sum())
    return {"envs": NUM_ENVS, "steps": steps, "seconds": seconds, "unsharded_seconds": plain_seconds,
            "launches": launches, "leaves_in_bits": compared,
            "episode_ends": resets, "gathered_in_bits": True, "local_shape": list(local(traj.obs).shape)}


def kernel_launches() -> dict:
    """Launches so far of every generated articulated and planar build."""
    from gymnasium_tpu_torch.ops import articulated_step as art
    from gymnasium_tpu_torch.ops import planar_step as pl

    return {**art.launches, **pl.launches}


def sharded_ppo_step(dev, mesh) -> dict:
    """One HalfCheetah PPO step at ``tools/bench_ppo.py``'s widths (three
    wrappers) over ``shard_ppo_state``'s state, against the same step
    unsharded from the same seed: parameters within ``PARALLEL_PPO_TOL`` of
    their largest magnitude."""
    from gymnasium_tpu_torch.parallel.mesh import shard_ppo_state
    from gymnasium_tpu_torch.train.ppo import init_ppo, make_train_step

    func_env, config, wrappers = ppo_case("half_cheetah")
    plain, env_params = init_ppo(func_env, config, seed=0, wrappers=wrappers, device=dev)
    step = make_train_step(func_env, config, env_params, wrappers)
    plain, plain_metrics = step(plain)
    state, _ = init_ppo(func_env, config, seed=0, wrappers=wrappers, device=dev)
    state = shard_ppo_state(state, mesh)
    before = dict(kernel_launches())
    torch.cuda.synchronize()
    start = time.perf_counter()
    state, metrics = step(state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {k: v - before.get(k, 0) for k, v in kernel_launches().items() if v - before.get(k, 0)}
    worst, bits = 0.0, True
    for (name, p), (_, q) in zip(state.policy.named_parameters(), plain.policy.named_parameters()):
        err = float((p - q).detach().abs().max())
        check(err <= PARALLEL_PPO_TOL * float(q.detach().abs().max()), f"sharded PPO parameter {name} differs by {err}")
        worst, bits = max(worst, err), bits and same_bits(p.detach(), q.detach())
    check(all(bool(torch.isfinite(v)) for v in metrics.values()), f"sharded PPO metrics {metrics}")
    return {"envs": config.num_envs, "rollout": config.rollout_steps, "hidden": list(config.hidden_sizes),
            "seconds": seconds, "launches": launches, "max_abs_param_diff": worst, "params_in_bits": bits,
            "loss": float(metrics["loss"]), "loss_unsharded": float(plain_metrics["loss"])}


def parallel_rank(rank: int, world: int, full: bool) -> dict:
    """The sharded paths on this rank of an NCCL group, one card a rank. With
    ``full``, the whole one-rank phase; else the HalfCheetah and LunarLander
    trajectories alone. Returns each part's result and seconds."""
    import contextlib
    import io

    import torch.distributed as dist

    from gymnasium_tpu_torch.entry import dryrun_multichip
    from gymnasium_tpu_torch.envs.box2d.lunar_lander import LunarLanderFunctional
    from gymnasium_tpu_torch.envs.mujoco.half_cheetah import HalfCheetahFunctional
    from gymnasium_tpu_torch.parallel.mesh import NamedSharding, make_mesh, scaling_report
    from gymnasium_tpu_torch.vector.torch_vector_env import TorchVectorEnv

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"rank": rank, "world": world, "backend": dist.get_backend(), "card": torch.cuda.get_device_name(dev)}
    start = time.perf_counter()
    mesh = make_mesh()
    out["mesh"] = {"shape": dict(zip(mesh.mesh_dim_names, list(mesh.mesh.shape))), "seconds": time.perf_counter() - start}
    out["half_cheetah"] = sharded_and_plain(dev, HalfCheetahFunctional(), PARALLEL_CHEETAH_LIMIT,
                                            PARALLEL_CHEETAH_STEPS, mesh)
    out["lunar_lander"] = sharded_and_plain(dev, LunarLanderFunctional(), PLANAR_TIME_LIMIT, PARALLEL_LANDER_STEPS, mesh)
    if not full:
        return out
    out["ppo_half_cheetah"] = sharded_ppo_step(dev, mesh)
    env = TorchVectorEnv(HalfCheetahFunctional(), NUM_ENVS, max_episode_steps=ART_TIME_LIMIT, seed=0, device=dev,
                         sharding=NamedSharding(mesh, ("dp",)))
    env.reset()
    carry = env.carry
    before = dict(kernel_launches())
    start = time.perf_counter()
    out["scaling_report"] = scaling_report(lambda c: env.rollout(PARALLEL_SCALING_STEPS, carry=c), (carry,), mesh,
                                           iters=5)
    out["scaling_report"]["seconds"] = time.perf_counter() - start
    out["scaling_report"]["launches"] = {k: v - before.get(k, 0) for k, v in kernel_launches().items()
                                         if v - before.get(k, 0)}
    env.carry = carry
    text = io.StringIO()
    before = dict(kernel_launches())
    start = time.perf_counter()
    with contextlib.redirect_stdout(text):
        dryrun_multichip(world)
    out["dryrun"] = {"lines": text.getvalue().splitlines(), "seconds": time.perf_counter() - start,
                     "launches": {k: v - before.get(k, 0) for k, v in kernel_launches().items() if v - before.get(k, 0)}}
    check(len(out["dryrun"]["lines"]) == 3 and all(line.endswith("ok") for line in out["dryrun"]["lines"]),
          f"dryrun_multichip({world}): {out['dryrun']['lines']}")
    return out


def run_parallel(dev) -> dict:
    """The sharded paths on one NCCL rank in a spawned process (no process
    group outlives it), then ``examples/torch_sharded_rollout.py --device
    cuda``; with two or more cards, one rank a card (up to 4) for the sharded
    trajectories. Returns each part's result, seconds and launches."""
    import torch.distributed as dist

    from gymnasium_tpu_torch.parallel import launch

    out = {"torch": torch.__version__, "nccl_available": dist.is_nccl_available(), "cards": torch.cuda.device_count()}
    start = time.perf_counter()
    (out["one_rank"],) = launch.run_ranks(parallel_rank, 1, True, device="cuda", timeout=PARALLEL_TIMEOUT_S)
    out["one_rank"]["seconds"] = time.perf_counter() - start
    root = os.path.dirname(os.path.abspath(__file__))
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(root, "examples", "torch_sharded_rollout.py"), "--device",
                           "cuda", "--ranks", "1"], cwd=root, env={**os.environ, "PYTHONPATH": root},
                          capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT_S)
    check(proc.returncode == 0, f"torch_sharded_rollout.py --device cuda exited {proc.returncode}: {proc.stderr[-2000:]}")
    out["example"] = {"rc": proc.returncode, "lines": proc.stdout.strip().splitlines()[-2:],
                      "seconds": time.perf_counter() - start}
    ranks = min(torch.cuda.device_count(), PARALLEL_MAX_RANKS)
    if ranks >= 2:
        start = time.perf_counter()
        out["multi_rank"] = launch.run_ranks(parallel_rank, ranks, False, device="cuda", timeout=PARALLEL_TIMEOUT_S)
        out["multi_rank_seconds"] = time.perf_counter() - start
    else:
        out["multi_rank"] = (f"not run: {torch.cuda.device_count()} card; the 2- and 4-rank paths are held by the "
                             "CPU tests over gloo (tests/test_torch_parallel*.py)")
    return out



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        xml_path = os.path.join(tmp, "chain.xml")
        with open(xml_path, "w") as f:
            f.write(MJCF_CHAIN_XML)
        return smoke(xml_path)


def smoke(xml_path: str) -> int:
    """Every phase on the card; ``xml_path`` holds :data:`MJCF_CHAIN_XML`."""
    from gymnasium_tpu_torch.envs.box2d.bipedal_walker import walker_solver
    from gymnasium_tpu_torch.envs.dynamics.lunar_lander import lander_step
    from gymnasium_tpu_torch.envs.mujoco import SwimmerFunctional
    from gymnasium_tpu_torch.envs.mujoco.mujoco_env import load_model
    from gymnasium_tpu_torch.ops import articulated_step as art
    from gymnasium_tpu_torch.ops import build
    from gymnasium_tpu_torch.ops import cartpole_rollout as cr
    from gymnasium_tpu_torch.ops import planar_step as pl
    from gymnasium_tpu_torch.ops import walker_terrain as wt

    began = time.perf_counter()
    laps = [began]

    def lap(label: str) -> None:
        """Print the seconds since the script's start and since the last lap."""
        laps.append(time.perf_counter())
        print(f"elapsed after {label}: {laps[-1] - began:.1f} s (+{laps[-1] - laps[-2]:.1f} s)", flush=True)

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}", flush=True)
    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")

    # -- build every kernel at once -------------------------------------------
    start = time.perf_counter()
    steps = {name: art.fused_step(name, articulated_env(name).frame_skip) for name in ART_ENVS}
    planar = lander_step(PLANAR_GRAVITY)
    walker = walker_solver()  # BipedalWalker and its hardcore variant share the world
    # Swimmer's substep (frame_skip 1) and the MJCF model's step, compiled from XML
    xml_model, xml_meta = load_model(xml_path)
    print(f"mjcf: compiled {xml_path} through load_model: nq {xml_model.nq}, nv {xml_model.nv}, "
          f"nu {xml_model.nu}, contacts {len(xml_model.contact_body)}, bodies {xml_meta['body_names']}", flush=True)
    more = {"swimmer_fs1": art.fused_step("swimmer", 1), "mjcf": art.fused_step(xml_path, MJCF_FRAME_SKIP)}
    generated = {step.build_name: step.source.text for step in (*steps.values(), *more.values())}
    generated[planar.build_name] = planar.source.text
    generated[walker.build_name] = walker.source.text
    print(f"generate: {time.perf_counter() - start:.2f} s; operations an env-call: "
          + ", ".join(f"{name} {step.source.ops_per_env}" for name, step in (*steps.items(), *more.items()))
          + f", lunar_lander {planar.source.ops_per_env}, bipedal_walker {walker.source.ops_per_env}", flush=True)
    start = time.perf_counter()
    built = build.build(build.KERNELS, generated)
    print(f"build: {time.perf_counter() - start:.2f} s for {sorted(built)}", flush=True)
    ptxas = {}
    for name, info in built.items():
        ptxas[name] = ptxas_summary(info["log"])
        print(f"nvcc {name}: {info['seconds']:.2f} s, {ptxas[name]}", flush=True)
        print(info["log"].strip(), flush=True)
    lap("the builds")
    # one cuobjdump a library, all at once
    libraries = {name: build.library_path(name) for name in build.KERNELS}
    libraries.update({name: build.library_path(name, text) for name, text in generated.items()})
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        sass = dict(zip(libraries, pool.map(sass_instructions, libraries.values())))
    print("SASS instructions a library: " + ", ".join(f"{k} {v}" for k, v in sass.items()), flush=True)
    lap("the SASS counts")
    early_launch_us = launch_us(dev)
    print(f"host us a launch of a one-element add_, before any profiled phase: {early_launch_us:.2f}", flush=True)

    # -- main path: each path with every launch count at 0 just before --------
    # Counts by kernel: the CartPole rollout, and each generated build by its
    # name; a launch of any other generated build shows as a key too.
    gen_zero = {step.build_name: 0 for step in (*steps.values(), *more.values())}
    gen_zero[planar.build_name] = 0
    gen_zero[walker.build_name] = 0
    gen_zero["walker_terrain"] = 0

    def counted(label, fn):
        cr.launches = 0
        wt.launches = 0
        art.launches.clear()
        pl.launches.clear()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        counts = {"cartpole_rollout_fused": cr.launches, **gen_zero, **art.launches, **pl.launches,
                  "walker_terrain": wt.launches}
        print(f"path {label}: {time.perf_counter() - start:.2f} s, launches {counts}", flush=True)
        return out, counts

    print(f"clocks.sm, power.draw before the warm-up block: {query_gpu('clocks.sm,power.draw')}", flush=True)
    warm_ms = warm_headline(dev)
    print(f"warm-up headline block (untimed): {warm_ms:.4f} ms host clock", flush=True)
    print(f"clocks.sm, power.draw after it, before bf16 block 0: {query_gpu('clocks.sm,power.draw')}",
          flush=True)
    (headline, block_ms), head_counts = counted("headline", lambda: run_headline(dev))
    print(f"clocks.sm, power.draw after the headline blocks: {query_gpu('clocks.sm,power.draw')}", flush=True)
    vec_rate, vec_counts = counted("cartpole TorchVectorEnv", lambda: run_vector_env(dev))
    _, entry_counts = counted("entry()", run_entry)
    robots, robot_counts = {}, {}
    for name in ART_ENVS:
        robots[name], robot_counts[name] = counted(f"{name} TorchVectorEnv", lambda: run_articulated(dev, name))
        print(f"{name} TorchVectorEnv: {robots[name]}", flush=True)
    ll_rate, ll_counts = counted("lunar_lander TorchVectorEnv", lambda: run_lunar_lander(dev))
    bipedal, bipedal_counts = {}, {}
    for hardcore in (False, True):
        name = "bipedal_walker_hardcore" if hardcore else "bipedal_walker"
        bipedal[name], bipedal_counts[name] = counted(f"{name} TorchVectorEnv", lambda: run_bipedal(dev, hardcore))
        print(f"{name} TorchVectorEnv: {bipedal[name]}", flush=True)
    classic, classic_counts = {}, {}
    for name in CLASSIC_ENVS:
        classic[name], classic_counts[name] = counted(f"{name} TorchVectorEnv", lambda: run_classic(dev, name))
        print(f"{name} TorchVectorEnv: {classic[name]}", flush=True)
    car, car_counts = counted("carracing_v3 TorchVectorEnv", lambda: run_car_racing(dev))
    print(f"carracing_v3 TorchVectorEnv: {car}", flush=True)
    car_discrete, car_discrete_counts = counted("carracing_v3 discrete TorchVectorEnv",
                                                lambda: run_car_racing(dev, continuous=False))
    print(f"carracing_v3 discrete TorchVectorEnv: {car_discrete}", flush=True)
    swim, swim_counts = counted("swimmer TorchVectorEnv", lambda: run_swimmer(dev))
    print(f"swimmer TorchVectorEnv: {swim}", flush=True)
    mjcf, mjcf_counts = counted("mjcf TorchVectorEnv", lambda: run_mjcf(dev, xml_path))
    print(f"mjcf TorchVectorEnv: {mjcf}", flush=True)
    registry, registry_counts = {}, {}
    for env_id in REGISTRY_IDS:
        registry[env_id], registry_counts[env_id] = counted(f"make_vec({env_id!r}, {NUM_ENVS})",
                                                            lambda: run_registry_vec(dev, env_id))
    single_cartpole, single_cartpole_counts = counted('make("phys2d/CartPole-v1")', lambda: run_registry_single(dev))
    single, single_counts = {}, {}
    for env_id in SINGLE_IDS:
        single[env_id], single_counts[env_id] = counted(f"FunctionalTorchEnv({env_id})",
                                                        lambda: run_single_env(dev, env_id))
    host, host_counts = {}, {}
    for env_id in HOST_IDS:
        host[env_id], host_counts[env_id] = counted(f"make({env_id!r})", lambda: run_host_env(dev, env_id))
        print(f"make({env_id!r}) on the card: {host[env_id]['ms_a_step']:.4f} ms a step (host clock, "
              f"{HOST_STEPS} steps), reset {host[env_id]['reset_ms']:.2f} ms", flush=True)
    check(head_counts == {"cartpole_rollout_fused": 2 * HEADLINE_BLOCKS, **gen_zero},
          f"headline launches {head_counts}")
    check(not any(vec_counts.values()) and not any(entry_counts.values()),
          "the CartPole TorchVectorEnv or entry() launched a kernel")
    for name, counts in robot_counts.items():
        want = {"cartpole_rollout_fused": 0, **gen_zero, steps[name].build_name:
                ART_WARM_STEPS + ART_ROLLOUT if name in ART_FULL_PATHS else ROBOT_ROLLOUT}
        check(counts == want, f"{name} path launches {counts}, want {want}")
    check(robots["half_cheetah"]["terminations"] == 0, "a half_cheetah lane terminated")
    # reset, then two launches a step (transition, reset tick), the masked reset
    ll_want = {"cartpole_rollout_fused": 0, **gen_zero,
               planar.build_name: 1 + 2 * PLANAR_WARM_STEPS + 1 + 2 * PLANAR_ROLLOUT}
    check(ll_counts == ll_want, f"lunar_lander path launches {ll_counts}, want {ll_want}")
    # reset, then two walker launches and one terrain launch a step (the
    # transition, the reset drawn for every lane), the masked reset
    env_steps = BIPEDAL_WARM_STEPS + BIPEDAL_ROLLOUT
    for name, counts in bipedal_counts.items():
        want = {"cartpole_rollout_fused": 0, **gen_zero, walker.build_name: 1 + 2 * env_steps + 1,
                "walker_terrain": 1 + env_steps + 1}
        check(counts == want, f"{name} path launches {counts}, want {want}")
    for name, counts in classic_counts.items():
        check(not any(counts.values()), f"{name}: the path launched {counts}; it runs no kernel of the port")
    for name, counts in (("carracing_v3", car_counts), ("carracing_v3 discrete", car_discrete_counts)):
        check(not any(counts.values()), f"{name}: the path launched {counts}; it runs no kernel of the port")
    # four substeps an env step, one launch each
    swim_want = {"cartpole_rollout_fused": 0, **gen_zero, more["swimmer_fs1"].build_name: 4 * SWIMMER_ROLLOUT}
    check(swim_counts == swim_want, f"swimmer path launches {swim_counts}, want {swim_want}")
    mjcf_want = {"cartpole_rollout_fused": 0, **gen_zero, more["mjcf"].build_name: MJCF_ROLLOUT}
    check(mjcf_counts == mjcf_want, f"mjcf path launches {mjcf_counts}, want {mjcf_want}")
    # the registry's paths launch a step as the direct paths do: CartPole none,
    # HalfCheetah one, the lander two (the transition, the reset tick drawn
    # for every lane) after one at reset, the walker two and a terrain launch
    reg_steps = REGISTRY_WARM_STEPS + REGISTRY_ROLLOUT
    registry_want = {
        "CartPole-v1": {},
        "HalfCheetah-v5": {steps["half_cheetah"].build_name: reg_steps},
        "LunarLander-v3": {planar.build_name: 1 + 2 * reg_steps},
        "BipedalWalkerHardcore-v3": {walker.build_name: 1 + 2 * reg_steps, "walker_terrain": 1 + reg_steps},
    }
    for env_id, counts in registry_counts.items():
        want = {"cartpole_rollout_fused": 0, **gen_zero, **registry_want[env_id]}
        check(counts == want, f"make_vec({env_id!r}) path launches {counts}, want {want}")
        registry[env_id]["launches"] = {k: v for k, v in counts.items() if v}
        registry[env_id]["launches_a_step"] = {k: (v - (1 if env_id in ("LunarLander-v3", "BipedalWalkerHardcore-v3")
                                                      else 0)) / reg_steps for k, v in counts.items() if v}
    check(not any(single_cartpole_counts.values()), f"make('phys2d/CartPole-v1') launched {single_cartpole_counts}")
    # a single env's step is one transition: one launch; the lander's reset one more
    single_want = {"HalfCheetah-v5": {steps["half_cheetah"].build_name: SINGLE_STEPS},
                   "Ant-v5": {steps["ant"].build_name: SINGLE_STEPS},
                   "LunarLander-v3": {planar.build_name: 1 + SINGLE_STEPS}}
    for env_id, counts in single_counts.items():
        want = {"cartpole_rollout_fused": 0, **gen_zero, **single_want[env_id]}
        check(counts == want, f"FunctionalTorchEnv({env_id}) path launches {counts}, want {want}")
        single[env_id]["launches"] = {k: v for k, v in counts.items() if v}
    # a host env step is one launch of the robot's build (Swimmer: four of its
    # frame_skip=1 build); its reset launches none
    host_builds = {**steps, "swimmer_fs1": more["swimmer_fs1"]}
    for env_id, counts in host_counts.items():
        key, per_step = HOST_IDS[env_id]
        build_name = host_builds[key].build_name
        want = {"cartpole_rollout_fused": 0, **gen_zero, build_name: per_step * HOST_STEPS}
        check(counts == want, f"make({env_id!r}) path launches {counts}, want {want}")
        check(host[env_id]["reset_launches"] == {}, f"make({env_id!r}): reset launched {host[env_id]['reset_launches']}")
        check(host[env_id]["step_launches"] == {build_name: per_step * HOST_STEPS},
              f"make({env_id!r}): steps launched {host[env_id]['step_launches']}")
        host[env_id]["launches"] = {build_name: counts[build_name]}
    main_launches = head_counts["cartpole_rollout_fused"]
    print(f"main path: host-clock env-steps/s headline bf16={headline['torch.bfloat16']:.0f} "
          f"f32={headline['torch.float32']:.0f}, CartPole TorchVectorEnv.rollout(256)={vec_rate:.0f}, "
          + "".join(f"{name} TorchVectorEnv.rollout({ART_ROLLOUT if name in ART_FULL_PATHS else ROBOT_ROLLOUT})="
                    f"{robots[name]['env_steps_per_s']:.0f}, " for name in ART_ENVS)
          + f"LunarLander TorchVectorEnv.rollout({PLANAR_ROLLOUT})={ll_rate:.0f}, "
          + "".join(f"{name} TorchVectorEnv.rollout({BIPEDAL_ROLLOUT})={r['env_steps_per_s']:.0f}, "
                    for name, r in bipedal.items())
          + ", ".join(f"{name} TorchVectorEnv.rollout({r['rollout_steps']})={r['env_steps_per_s']:.0f}"
                      for name, r in classic.items())
          + f", CarRacing (N={CAR_ENVS}) TorchVectorEnv.rollout({CAR_ROLLOUT})={car['env_steps_per_s']:.0f}"
          f", discrete rollout({CAR_DISCRETE_ROLLOUT})={car_discrete['env_steps_per_s']:.0f}"
          f", Swimmer TorchVectorEnv.rollout({SWIMMER_ROLLOUT})={swim['env_steps_per_s']:.0f}"
          f", MJCF chain TorchVectorEnv.rollout({MJCF_ROLLOUT})={mjcf['env_steps_per_s']:.0f}", flush=True)
    print("terminations seen on each robot's path: "
          + ", ".join(f"{name} {robots[name]['terminations']}" for name in ART_ENVS), flush=True)
    for name, times in block_ms.items():
        print(f"headline host-clock ms per block, obs={name}: "
              + " ".join(f"{t:.4f}" for t in times), flush=True)

    lap("the main paths")
    # -- the CartPole kernel against its plain version ------------------------
    n, s, seed = NUM_ENVS, STEPS_PER_BLOCK, 0
    args = (
        torch.zeros((4, n), device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev),
        torch.zeros(n, dtype=torch.bool, device=dev),
    )
    f32 = cr.cartpole_rollout_fused(*args, seed, s)
    torch.cuda.synchronize()
    max_err, near, mismatch = compare_rollout_with_twin(*args, seed, f32)
    print(f"kernel vs twin (f32 obs, N={n}, S={s}): max_abs_err={max_err:.3e} "
          f"near-threshold lanes={near} flag mismatches there={mismatch}", flush=True)

    bf16 = cr.cartpole_rollout_fused(*args, seed, s, obs_dtype=torch.bfloat16)
    check(torch.equal(bf16[3], f32[3].to(torch.bfloat16)), "bf16 obs are not the f32 obs rounded")
    for i in (0, 1, 2, 4, 5, 6):
        check(torch.equal(bf16[i], f32[i]), f"bf16 run output {i} differs from the f32 run")
    again = cr.cartpole_rollout_fused(*args, seed, s)
    other = cr.cartpole_rollout_fused(*args, seed + 1, s)
    check(all(torch.equal(a, b) for a, b in zip(again, f32)), "same seed, different bits")
    check(not torch.equal(other[3], f32[3]), "seed + 1 gave the same trajectory")
    print("kernel: bf16 obs equal the f32 obs rounded; deterministic per seed", flush=True)

    # -- the articulated kernels against their twin ---------------------------
    art_inputs, art_errs = {}, {}
    for name, step in (*steps.items(), *more.items()):
        art_inputs[name] = articulated_states(step.model, NUM_ENVS, dev)
        art_errs[name] = compare_articulated_with_twin(step, *art_inputs[name])
        print(f"articulated kernel vs twin ({name}, N={NUM_ENVS}, frame_skip {step.frame_skip}, "
              f"layout {step.source.layout}): max|dq|={art_errs[name][0]:.3e} max|dqd|={art_errs[name][1]:.3e}, "
              f"bit_equal={art_errs[name][3]}; deterministic; {art_errs[name][2]} lanes on the small-angle side",
              flush=True)

    # -- the planar kernel against its twin -----------------------------------
    planar_inputs = planar_states(NUM_ENVS, dev)
    planar_cmp = compare_planar_with_twin(planar, planar_inputs)
    print(f"planar kernel vs twin (lunar_lander, N={NUM_ENVS}, substeps {planar.substeps}): {planar_cmp}; "
          "deterministic", flush=True)
    walker_inputs = walker_states(NUM_ENVS, dev)
    walker_cmp = compare_planar_with_twin(walker, walker_inputs)
    walker_ragged = compare_planar_with_twin(walker, walker_states(BIPEDAL_RAGGED, dev, seed=1))
    print(f"planar kernel vs twin (bipedal_walker, N={NUM_ENVS}, substeps {walker.substeps}): {walker_cmp}; "
          f"N={BIPEDAL_RAGGED}: {walker_ragged}; deterministic", flush=True)
    terrain_cmp = [compare_terrain_with_twin(n, dev) for n in (NUM_ENVS, BIPEDAL_RAGGED)]
    print(f"walker_terrain kernel vs twin, normal and hardcore: {terrain_cmp}", flush=True)

    # -- the registry paths' kernels at a batch of one and a ragged batch -----
    small = {"articulated_step[half_cheetah]": {}, "articulated_step[ant]": {},
             "planar_step[lunar_lander]": {}, "planar_step[bipedal_walker]": {}}
    for n_small in (1, RAGGED_ENVS):
        for name in ("half_cheetah", "ant"):
            inputs = articulated_states(steps[name].model, n_small, dev, seed=n_small)
            dq, dqd, lanes, bits = compare_articulated_with_twin(steps[name], *inputs)
            small[f"articulated_step[{name}]"][n_small] = {
                "max_abs_err": max(dq, dqd), "bit_equal": bits, "small_angle_lanes": lanes,
                "events_ms": cuda_ms(lambda: steps[name](*inputs), 50, 5)}
        for label, step, inputs in (("lunar_lander", planar, planar_states(n_small, dev, seed=n_small)),
                                    ("bipedal_walker", walker, walker_states(n_small, dev, seed=n_small))):
            cmp = compare_planar_with_twin(step, inputs, every_branch=False)
            cmp["events_ms"] = cuda_ms(lambda: step(*inputs), 50, 5)
            small[f"planar_step[{label}]"][n_small] = cmp
    print(f"kernels vs twins at N=1 and N={RAGGED_ENVS}: {json.dumps(small)}", flush=True)
    lap("the kernels against their twins")
    # every host env's build at a batch of one, as its env step launches it
    host_small = {}
    for env_id, (key, _) in HOST_IDS.items():
        step = host_builds[key]
        inputs = articulated_states(step.model, 1, dev, seed=1)
        dq, dqd, lanes, bits = compare_articulated_with_twin(step, *inputs)
        host_small[key] = {"build": step.build_name, "max_abs_err": max(dq, dqd), "bit_equal": bits,
                           "events_ms": cuda_ms(lambda: step(*inputs), 50, 5)}
    print(f"host envs' builds vs twins at N=1: {json.dumps(host_small)}", flush=True)
    lap("the host envs' builds at N=1")
    for env_id in REGISTRY_IDS:
        registry[env_id]["bit_equal_to_hand_built"] = compare_registry_with_hand_built(dev, env_id, registry[env_id])
    for env_id in SINGLE_IDS:
        tol = BIPEDAL_CHECK_TOL if env_id.startswith("LunarLander") else SWIMMER_CHECK_TOL
        single[env_id]["device_vs_cpu"] = compare_single_env_with_cpu(env_id, single[env_id], tol)
    device_spaces = run_device_spaces(dev)

    lap("the kernel checks")
    # -- times ----------------------------------------------------------------
    results = {}
    for obs_dtype in (torch.float32, torch.bfloat16):
        rollout = lambda: cr.cartpole_rollout_fused(*args, seed, s, obs_dtype=obs_dtype)  # noqa: E731
        events_ms = cuda_ms(rollout, 20, 3)
        ms = device_ms(rollout, "cartpole_rollout_kernel", 20)
        bound_ms, bound_by = rollout_bound_ms(n, s, obs_dtype)
        results[obs_dtype] = (ms, events_ms, bound_ms, bound_by)
        print(f"cartpole_rollout_fused obs={obs_dtype}: device {ms:.4f} ms/call, events {events_ms:.4f} ms, "
              f"{n * s / ms * 1e3:.4e} env-steps/s, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{bound_ms / ms:.2%} of bound", flush=True)
    plain_ms = cuda_ms(lambda: cr.cartpole_rollout_reference(*args, seed, s), 1, 1)
    print(f"cartpole_rollout_reference (plain twin) on the card: {plain_ms:.2f} ms/call", flush=True)

    ms, events_ms, bound_ms, bound_by = results[torch.float32]
    bf16_ms, bf16_events_ms, bf16_bound, _ = results[torch.bfloat16]
    kernels = [
        {
            "name": "cartpole_rollout_fused",
            "route": "cuda",
            "source": "gymnasium_tpu_torch/csrc/cartpole_rollout.cu",
            "replaces": "gymnasium_tpu/ops/pallas_rollout.py:143",
            "launches": main_launches,
            "max_abs_err": max_err,
            "ms": ms,
            "events_ms": events_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "bf16_obs_ms": bf16_ms,
            "bf16_obs_events_ms": bf16_events_ms,
            "bf16_obs_bound_ms": bf16_bound,
            "sass_instructions": sass["cartpole_rollout"],
            "code_bytes": SASS_BYTES * sass["cartpole_rollout"],
            "nvcc_s": built.get("cartpole_rollout", {}).get("seconds"),
            **ptxas.get("cartpole_rollout", {}),
            "ok": True,
        }
    ]
    art_launches = {name: robot_counts[name][step.build_name] for name, step in steps.items()}
    art_launches.update({"swimmer_fs1": swim_counts[more["swimmer_fs1"].build_name],
                         "mjcf": mjcf_counts[more["mjcf"].build_name]})
    for name, step in (*steps.items(), *more.items()):
        inputs = art_inputs[name]
        art_events_ms = cuda_ms(lambda: step(*inputs), 50, 5)
        art_ms = device_ms(lambda: step(*inputs), "kernel<ArticulatedStep>", 50)
        art_plain_ms = cuda_ms(lambda: step.reference(*inputs), 1, 1)
        art_bound, art_bound_by = articulated_bound_ms(step, NUM_ENVS)
        print(f"articulated_step[{name}] N={NUM_ENVS}: device {art_ms:.4f} ms/call, events {art_events_ms:.4f} ms, "
              f"bound {art_bound:.4f} ms "
              f"({art_bound_by}), {art_bound / art_ms:.2%} of bound; plain twin {art_plain_ms:.2f} ms/call",
              flush=True)
        kernels.append(
            {
                "name": f"articulated_step[{step.name if name == 'mjcf' else name}]",
                "route": "cuda",
                "source": "gymnasium_tpu_torch/csrc/articulated_step.cuh",
                "generator": "gymnasium_tpu_torch/ops/articulated_codegen.py",
                "replaces": "gymnasium_tpu/ops/pallas_articulated.py:119",
                "launches": art_launches[name],
                "on_main_path": art_launches[name] > 0,
                "max_abs_err": max(art_errs[name][:2]),
                "max_abs_err_q": art_errs[name][0],
                "max_abs_err_qd": art_errs[name][1],
                "ms": art_ms,
                "events_ms": art_events_ms,
                "plain_ms": art_plain_ms,
                "bound_ms": art_bound,
                "bound_by": art_bound_by,
                "library_ms": None,
                "bit_equal": art_errs[name][3],
                "frame_skip": step.frame_skip,
                "small_angle_lanes": art_errs[name][2],
                **step.source.layout,
                "ops_per_env": step.source.ops_per_env,
                "sass_instructions": sass[step.build_name],
                "code_bytes": SASS_BYTES * sass[step.build_name],
                "nvcc_s": built.get(step.build_name, {}).get("seconds"),
                **ptxas.get(step.build_name, {}),
                "ok": True,
            }
        )
    planar_events_ms = cuda_ms(lambda: planar(*planar_inputs), 50, 5)
    planar_ms = device_ms(lambda: planar(*planar_inputs), "step_kernel", 50)
    planar_plain_ms = cuda_ms(lambda: planar.reference(*planar_inputs), 1, 1)
    planar_bound, planar_bound_by = planar_bound_ms(planar, NUM_ENVS)
    print(f"planar_step[lunar_lander] N={NUM_ENVS}: device {planar_ms:.4f} ms/call, "
          f"events {planar_events_ms:.4f} ms, bound {planar_bound:.4f} ms "
          f"({planar_bound_by}), {planar_bound / planar_ms:.2%} of bound; "
          f"plain twin {planar_plain_ms:.2f} ms/call", flush=True)
    kernels.append(
        {
            "name": "planar_step[lunar_lander]",
            "route": "cuda",
            "source": "gymnasium_tpu_torch/csrc/planar_step.cuh",
            "generator": "gymnasium_tpu_torch/ops/planar_codegen.py",
            "replaces": "gymnasium_tpu/ops/pallas_planar.py:37",
            "launches": ll_counts[planar.build_name],
            "on_main_path": ll_counts[planar.build_name] > 0,
            "max_abs_err": max(planar_cmp[f"max_abs_err_{k}"] for k in ("bodies", "jimp", "cimp")),
            **planar_cmp,
            "ms": planar_ms,
            "events_ms": planar_events_ms,
            "plain_ms": planar_plain_ms,
            "bound_ms": planar_bound,
            "bound_by": planar_bound_by,
            "library_ms": None,
            "substeps": planar.substeps,
            "ops_per_env": planar.source.ops_per_env,
            "sass_instructions": sass[planar.build_name],
            "code_bytes": SASS_BYTES * sass[planar.build_name],
            "nvcc_s": built.get(planar.build_name, {}).get("seconds"),
            **ptxas.get(planar.build_name, {}),
            "ok": True,
        }
    )
    walker_events_ms = cuda_ms(lambda: walker(*walker_inputs), 50, 5)
    walker_ms = device_ms(lambda: walker(*walker_inputs), "step_kernel", 50)
    walker_plain_ms = cuda_ms(lambda: walker.reference(*walker_inputs), 1, 1)
    walker_bound, walker_bound_by = planar_bound_ms(walker, NUM_ENVS)
    print(f"planar_step[bipedal_walker] N={NUM_ENVS}: device {walker_ms:.4f} ms/call, "
          f"events {walker_events_ms:.4f} ms, bound {walker_bound:.4f} ms ({walker_bound_by}), "
          f"{walker_bound / walker_ms:.2%} of bound; plain twin {walker_plain_ms:.2f} ms/call", flush=True)
    walker_launches = {name: counts[walker.build_name] for name, counts in bipedal_counts.items()}
    kernels.append(
        {
            "name": "planar_step[bipedal_walker]",
            "route": "cuda",
            "source": "gymnasium_tpu_torch/csrc/planar_step.cuh",
            "generator": "gymnasium_tpu_torch/ops/planar_codegen.py",
            "replaces": "gymnasium_tpu/ops/pallas_planar.py:37",
            "held_to": "gymnasium_tpu/physics/planar.py:99 world_step (JAX runs the walker's ticks as plain jnp)",
            "launches": sum(walker_launches.values()),
            "launches_by_path": walker_launches,
            "on_main_path": sum(walker_launches.values()) > 0,
            "max_abs_err": max(walker_cmp[f"max_abs_err_{k}"] for k in ("bodies", "cimp")),
            **walker_cmp,
            "ragged": {"envs": BIPEDAL_RAGGED, **walker_ragged},
            "ms": walker_ms,
            "events_ms": walker_events_ms,
            "plain_ms": walker_plain_ms,
            "bound_ms": walker_bound,
            "bound_by": walker_bound_by,
            "library_ms": None,
            "substeps": walker.substeps,
            "ops_per_env": walker.source.ops_per_env,
            "sass_instructions": sass[walker.build_name],
            "code_bytes": SASS_BYTES * sass[walker.build_name],
            "nvcc_s": built.get(walker.build_name, {}).get("seconds"),
            **ptxas.get(walker.build_name, {}),
            "ok": True,
        }
    )
    u, d = terrain_draws(NUM_ENVS, dev)
    terrain_times = {}
    for mode, draws in (("normal", None), ("hardcore", d)):
        events = cuda_ms(lambda: wt.walker_terrain(u, draws), 50, 5)
        ms = device_ms(lambda: wt.walker_terrain(u, draws), "terrain_kernel", 50)
        plain = cuda_ms(lambda: wt.walker_terrain_reference(u, draws), 1, 1)
        bnd, bnd_by = terrain_bound_ms(NUM_ENVS, draws is not None)
        terrain_times[mode] = {"ms": ms, "events_ms": events, "plain_ms": plain, "bound_ms": bnd, "bound_by": bnd_by}
        print(f"walker_terrain[{mode}] N={NUM_ENVS}: device {ms:.4f} ms/call, events {events:.4f} ms, "
              f"bound {bnd:.5f} ms ({bnd_by}), {bnd / ms:.2%} of bound; plain twin {plain:.2f} ms/call", flush=True)
    terrain_launches = {name: counts["walker_terrain"] for name, counts in bipedal_counts.items()}
    kernels.append(
        {
            "name": "walker_terrain",
            "route": "cuda",
            "source": "gymnasium_tpu_torch/csrc/walker_terrain.cu",
            "replaces": "none: port-only (gymnasium_tpu/envs/box2d/bipedal_walker.py:218 generate_terrain, a lax.scan)",
            "launches": sum(terrain_launches.values()),
            "launches_by_path": terrain_launches,
            "on_main_path": sum(terrain_launches.values()) > 0,
            "max_abs_err": max(c["max_abs_err"] for c in terrain_cmp),
            "bit_equal": all(c["bit_equal"] for c in terrain_cmp),
            "checked_envs": [c["envs"] for c in terrain_cmp],
            **terrain_times["normal"],
            "hardcore": terrain_times["hardcore"],
            "library_ms": None,
            "sass_instructions": sass["walker_terrain"],
            "code_bytes": SASS_BYTES * sass["walker_terrain"],
            "nvcc_s": built.get("walker_terrain", {}).get("seconds"),
            **ptxas.get("walker_terrain", {}),
            "ok": True,
        }
    )
    lap("the kernel times")
    # -- profiled paths: one Ant env step, the PPO trainer --------------------
    # They run after the kernel timings: a device_ms trace taken after other
    # profiled work in the process missed one CartPole launch in every try.
    ant_profile = profile_env_step(dev, articulated_env("ant"), "ant", ART_TIME_LIMIT, "kernel<ArticulatedStep>")
    print(f"ant TorchVectorEnv step under torch.profiler (N={NUM_ENVS}): {json.dumps(ant_profile)}", flush=True)
    next(k for k in kernels if k["name"] == "articulated_step[ant]")["env_step_profile"] = ant_profile
    for name in CLASSIC_BENCH_ROWS:
        classic[name]["env_step_profile"] = profile_env_step(dev, classic_env(name), name,
                                                             step_limit(CLASSIC_ENVS[name][0]))
        print(f"{name} TorchVectorEnv step under torch.profiler (N={NUM_ENVS}): "
              f"{json.dumps(classic[name]['env_step_profile'])}", flush=True)
    car["env_step_profile"] = profile_env_step(
        dev, ranged(car_racing_env(), "observation", "car_racing.observation"), "carracing_v3", CAR_TIME_LIMIT,
        n=CAR_ENVS, ranges=("car_racing.observation",))
    print(f"carracing_v3 TorchVectorEnv step under torch.profiler (N={CAR_ENVS}): "
          f"{json.dumps(car['env_step_profile'])}", flush=True)
    swim["env_step_profile"] = profile_env_step(dev, SwimmerFunctional(), "swimmer", ART_TIME_LIMIT,
                                                "kernel<ArticulatedStep>", launches_a_step=4)
    print(f"swimmer TorchVectorEnv step under torch.profiler (N={NUM_ENVS}): "
          f"{json.dumps(swim['env_step_profile'])}", flush=True)
    for hardcore in (False, True):
        name = "bipedal_walker_hardcore" if hardcore else "bipedal_walker"
        bipedal[name]["env_step_profile"] = profile_env_step(
            dev, walker_env(hardcore), name, step_limit(walker_id(hardcore)), "step_kernel", launches_a_step=2)
        print(f"{name} TorchVectorEnv step under torch.profiler (N={NUM_ENVS}): "
              f"{json.dumps(bipedal[name]['env_step_profile'])}", flush=True)
        bipedal[name]["device_vs_cpu"] = compare_bipedal_with_cpu(dev, hardcore)
        print(f"{name} on the card vs the CPU ({BIPEDAL_CHECK_STEPS} steps from the CPU's carry, N={NUM_ENVS}, "
              f"same draws): {bipedal[name]['device_vs_cpu']}", flush=True)
    lap("the profiled paths and the walkers against the CPU")
    wrapped = compare_wrappers_with_cpu(dev)
    print(f"functional wrappers on the card vs the CPU ({WRAPPER_CHECK_STEPS} steps from the CPU's carry, "
          f"N={WRAPPER_CHECK_ENVS}): {wrapped}", flush=True)
    print(json.dumps({"bipedal": {"card": card_line(), "envs": NUM_ENVS, **bipedal}, "wrappers": wrapped}), flush=True)
    car["device_vs_cpu"] = compare_car_racing_with_cpu(dev)
    print(f"carracing_v3 on the card vs the CPU ({CAR_CHECK_STEPS} steps, N={CAR_CHECK_ENVS}, injected draws): "
          f"{car['device_vs_cpu']}", flush=True)
    swim["device_vs_cpu"] = compare_swimmer_with_cpu(dev)
    print(f"swimmer on the card vs the CPU ({SWIMMER_CHECK_STEPS} steps, N={NUM_ENVS}, injected draws): "
          f"{swim['device_vs_cpu']}", flush=True)
    print(json.dumps({"carracing": {"card": card_line(), "continuous": car, "discrete": car_discrete},
                      "swimmer": {"card": card_line(), "envs": NUM_ENVS, **swim},
                      "mjcf": {"card": card_line(), "envs": NUM_ENVS, **mjcf}}), flush=True)
    lap("the wrappers, CarRacing and Swimmer against the CPU")
    for name in CLASSIC_ENVS:
        classic[name]["device_vs_cpu"] = compare_classic_with_cpu(dev, name)
        print(f"{name} on the card vs the CPU ({CLASSIC_CHECK_STEPS} steps, N={NUM_ENVS}, injected draws): "
              f"{classic[name]['device_vs_cpu']}", flush=True)
    print(json.dumps({"classic": {"card": card_line(), "envs": NUM_ENVS, **classic}}), flush=True)
    lap("the classic envs against the CPU")
    ppo, ppo_counts = {}, {}
    for name in ("cartpole", "half_cheetah"):
        ppo[name], ppo_counts[name] = counted(f"ppo {name}", lambda: run_ppo(dev, name))
    check(not any(ppo_counts["cartpole"].values()), f"the CartPole PPO path launched {ppo_counts['cartpole']}")
    # an untimed, the timed and the profiled train steps, one launch an env step
    train_steps = 1 + PPO_TIMED_STEPS + ppo["half_cheetah"]["profiled_steps"]
    ppo_want = {"cartpole_rollout_fused": 0, **gen_zero, steps["half_cheetah"].build_name: PPO_ROLLOUT * train_steps}
    check(ppo_counts["half_cheetah"] == ppo_want,
          f"half_cheetah PPO path launches {ppo_counts['half_cheetah']}, want {ppo_want}")
    print(f"main path: host-clock env-steps/s through PPO CartPole={ppo['cartpole']['env_steps_per_s']:.0f}, "
          f"HalfCheetah={ppo['half_cheetah']['env_steps_per_s']:.0f}", flush=True)
    ppo["device_vs_cpu"] = compare_ppo_with_cpu(dev)
    print(json.dumps({"ppo": {"card": card_line(), **ppo}}), flush=True)
    lap("the PPO paths and PPO against the CPU")
    for env_id in HOST_IDS:
        host[env_id]["device_vs_cpu"] = compare_host_env_with_cpu(env_id, host[env_id])
        print(f"make({env_id!r}) on the card vs the CPU ({HOST_CHECK_STEPS} steps, each from the card's state): "
              f"{host[env_id]['device_vs_cpu']}", flush=True)
    lap("the host envs against the CPU")
    for env_id in HOST_PROFILED:
        host[env_id]["env_step_profile"] = profile_host_env_step(dev, env_id, "kernel<ArticulatedStep>")
        host[env_id]["frame"] = render_host_frame(env_id)
        print(f"make({env_id!r}) step under torch.profiler: {json.dumps(host[env_id]['env_step_profile'])}; "
              f"rgb_array frame {host[env_id]['frame']}", flush=True)
    lap("the host envs' profiles and frames")
    print(json.dumps({"host_envs": {
        "card": card_line(), "steps": HOST_STEPS,
        "envs": {env_id: {k: v for k, v in r.items() if not k.startswith("_")} for env_id, r in host.items()},
        "builds_at_n1": host_small,
    }}), flush=True)
    # -- the Box2D host env classes: LunarLander and BipedalWalker on the card,
    # CarRacing on the host ---------------------------------------------------
    box2d, box2d_counts = {}, {}
    for label in BOX2D_PATHS:
        box2d[label], box2d_counts[label] = counted(f"make({label!r})", lambda: run_box2d_env(dev, label))
        print(f"make({label!r}) on the card: {box2d[label]['ms_a_step']:.4f} ms a step (host clock, "
              f"{BOX2D_STEPS} steps), reset {box2d[label]['reset_ms']:.2f} ms", flush=True)
    car_host, car_host_counts = counted('make("CarRacing-v3")', run_car_racing_host)
    check(not any(car_host_counts.values()), f'make("CarRacing-v3") launched {car_host_counts}; it runs on the host')
    # a reset is one launch of the path's build (the walker's after one
    # terrain launch), a step one launch of the build
    for label, counts in box2d_counts.items():
        walker_path = box2d_kind(BOX2D_PATHS[label][0]) == "walker"
        build_name = walker.build_name if walker_path else planar.build_name
        reset_want = {build_name: 1, **({"walker_terrain": 1} if walker_path else {})}
        want = {"cartpole_rollout_fused": 0, **gen_zero, **reset_want, build_name: 1 + BOX2D_STEPS}
        check(counts == want, f"make({label!r}) path launches {counts}, want {want}")
        check(box2d[label]["reset_launches"] == reset_want,
              f"make({label!r}): reset launched {box2d[label]['reset_launches']}, want {reset_want}")
        check(box2d[label]["step_launches"] == {build_name: BOX2D_STEPS},
              f"make({label!r}): steps launched {box2d[label]['step_launches']}")
        box2d[label]["launches"] = {k: v for k, v in counts.items() if v}
    for label in BOX2D_PATHS:
        box2d[label]["device_vs_cpu"] = compare_box2d_env_with_cpu(label, box2d[label])
        print(f"make({label!r}) on the card vs the CPU (the reset, {BOX2D_CHECK_STEPS} steps each from the card's "
              f"state): {box2d[label]['device_vs_cpu']}", flush=True)
    landings = run_heuristic_landings()
    box2d_profiles, box2d_frames = {}, {}
    for env_id in BOX2D_PROFILED:
        box2d_profiles[env_id] = profile_host_env_step(dev, env_id, "step_kernel")
        print(f"make({env_id!r}) step under torch.profiler: {json.dumps(box2d_profiles[env_id])}", flush=True)
    for env_id, shape in BOX2D_FRAMES.items():
        box2d_frames[env_id] = render_host_frame(env_id, shape)
    terrain_n1 = compare_terrain_at_n1(dev)
    print(f"rgb_array frames: {json.dumps(box2d_frames)}; walker_terrain kernel vs twin at N=1: {terrain_n1}",
          flush=True)
    next(k for k in kernels if k["name"] == "walker_terrain")["n1"] = terrain_n1
    print(json.dumps({"box2d_host_envs": {
        "card": card_line(), "steps": BOX2D_STEPS,
        "envs": {label: {k: v for k, v in r.items() if not k.startswith("_")} for label, r in box2d.items()},
        "carracing": car_host, "heuristic_landings": landings, "profiles": box2d_profiles, "frames": box2d_frames,
        "walker_terrain_n1": terrain_n1,
    }}), flush=True)
    lap("the Box2D host envs")
    # -- the classic-control, toy-text and CPD host classes: host only --------
    host_classes, host_class_counts = counted("the host classes", run_host_classes)
    check(not any(host_class_counts.values()), f"the host classes launched {host_class_counts}")
    lap("the host classes")
    # -- the utilities over the articulated kernel ------------------------------
    hc_build = steps["half_cheetah"].build_name
    bench_step, bench_step_counts = counted("benchmark_step", run_benchmark_step)
    want = {"cartpole_rollout_fused": 0, **gen_zero, hc_build: bench_step["half_cheetah_launches"]}
    check(bench_step_counts == want, f"benchmark_step path launches {bench_step_counts}, want {want}")
    lap("benchmark_step")
    compiled, compiled_counts = counted(
        "benchmark_compiled_rollout", lambda: run_compiled_rollout(dev, registry["HalfCheetah-v5"]["env_steps_per_s"], early_launch_us))
    want = {"cartpole_rollout_fused": 0, **gen_zero,
            hc_build: COMPILED_ROLLOUT_STEPS * (2 + COMPILED_ROLLOUT_REPEATS)}
    check(compiled_counts == want, f"benchmark_compiled_rollout path launches {compiled_counts}, want {want}")
    lap("benchmark_compiled_rollout")
    scratch = os.path.dirname(xml_path)
    traced, trace_counts = counted("trace", lambda: run_trace(dev, scratch))
    want = {"cartpole_rollout_fused": 0, **gen_zero, hc_build: TRACE_ENV_STEPS * traced["tries"]}
    check(trace_counts == want, f"trace path launches {trace_counts}, want {want}")
    lap("trace")
    resumed, resume_counts = counted("checkpoint", lambda: run_checkpoint(dev, scratch))
    want = {"cartpole_rollout_fused": 0, **gen_zero, hc_build: resumed["train_steps"] * PPO_ROLLOUT}
    check(resume_counts == want, f"checkpoint path launches {resume_counts}, want {want}")
    generator = check_torch_generator(dev)
    print(json.dumps({"host_classes": {"card": card_line(), "steps": HOST_CLASS_STEPS, **host_classes},
                      "utils": {"card": card_line(), "benchmark_step": bench_step,
                                "benchmark_compiled_rollout": compiled, "trace": traced,
                                "checkpoint": resumed, "torch_generator": generator}}), flush=True)
    lap("the checkpoint and torch_generator")
    # -- the host vector envs, the native tabular stepper, the host wrappers ----
    vec, vec_counts = {}, {}
    vec_paths = {"HalfCheetah-v5": (VEC_STEPS, hc_build, "kernel<ArticulatedStep>", 0),
                 "LunarLander-v3": (VEC_LANDER_STEPS, planar.build_name, "step_kernel", 1)}
    for env_id, (n_steps, build_name, kernel, reset_launches) in vec_paths.items():
        vec[env_id], vec_counts[env_id] = counted(f"make_vec({env_id!r}, {VEC_ENVS}, sync)",
                                                  lambda: run_sync_vector(dev, env_id, n_steps))
        # a MuJoCo-class reset launches nothing, the lander's one settle tick
        want = {"cartpole_rollout_fused": 0, **gen_zero, build_name: VEC_ENVS * (reset_launches + n_steps)}
        check(vec_counts[env_id] == want, f"make_vec({env_id!r}, sync) launches {vec_counts[env_id]}, want {want}")
        check(vec[env_id]["reset_launches"] == VEC_ENVS * reset_launches,
              f"make_vec({env_id!r}, sync): the reset launched {vec[env_id]['reset_launches']}")
        print(f"make_vec({env_id!r}, {VEC_ENVS}, sync) on the card: {vec[env_id]['ms_a_step']:.4f} ms a step "
              f"(host clock, {n_steps} steps, {vec[env_id]['episode_ends']} sub-episode ends), "
              f"{VEC_ENVS} launches of {build_name} a step", flush=True)
        vec[env_id]["device_vs_cpu"] = compare_sync_vector_with_cpu(env_id, vec[env_id])
        vec[env_id]["profile"] = profile_sync_vector(env_id, kernel)
        print(f"make_vec({env_id!r}, sync) vs the CPU: {vec[env_id]['device_vs_cpu']}; under torch.profiler: "
              f"{json.dumps(vec[env_id]['profile'])}", flush=True)
        lap(f"the sync {env_id} vector env")
    async_run, async_counts = counted(f"make_vec('HalfCheetah-v5', {VEC_ENVS}, async, spawn)",
                                      lambda: run_async_vector(dev, vec["HalfCheetah-v5"], hc_build))
    # the parent only builds its probe env; the workers launch and report their counts
    check(not any(async_counts.values()), f"the async parent launched {async_counts}")
    print(f"make_vec('HalfCheetah-v5', {VEC_ENVS}, async, spawn): {async_run['ms_a_step']:.4f} ms a step "
          f"(host clock), start-up {async_run['startup_s']:.2f} s, workers' envs made after "
          f"{[round(t, 2) for t in async_run['worker_startup_s']]} s, cloudpickle "
          f"{'present' if async_run['cloudpickle'] else 'absent'}", flush=True)
    lap("the async HalfCheetah vector env")
    async_run["default_context"] = run_async_default_context()
    print(f"make_vec('HalfCheetah-v5', {VEC_ENVS}, async) with the default context: "
          f"{json.dumps(async_run['default_context'])}", flush=True)
    lap("the default-context async env")
    tabular, tabular_counts = counted("the native tabular stepper", run_native_tabular)
    check(not any(tabular_counts.values()), f"the native tabular stepper launched {tabular_counts}")
    lap("the native tabular stepper")
    wrapped, wrapped_counts = counted("the host wrappers over make('HalfCheetah-v5')", lambda: run_host_wrappers(dev))
    want = {"cartpole_rollout_fused": 0, **gen_zero, hc_build: 3 * WRAPPER_HOST_STEPS}  # checked, then timed wrapped and bare
    check(wrapped_counts == want, f"the host wrappers' path launches {wrapped_counts}, want {want}")
    print(f"host wrappers over make('HalfCheetah-v5'): {wrapped['ms_a_step']:.4f} ms a step against the bare "
          f"env's {wrapped['bare_ms_a_step']:.4f} (host clock); vs the CPU {wrapped['max_abs_dev']}", flush=True)
    print(json.dumps({"host_vector": {
        "card": card_line(),
        "sync": {env_id: {k: v for k, v in r.items() if not k.startswith("_")} for env_id, r in vec.items()},
        "async": async_run, "native_tabular": tabular, "host_wrappers": wrapped,
    }}), flush=True)
    lap("the host wrappers")
    # -- the vector wrappers over the articulated kernel, and the rendering ----
    vector_wrappers, vw_counts = counted(f"the vector wrappers over make_vec('HalfCheetah-v5', {NUM_ENVS})",
                                         lambda: run_vector_wrappers(dev, hc_build))
    want = {"cartpole_rollout_fused": 0, **gen_zero, hc_build: VW_STEPS}
    check(vw_counts == want, f"the vector wrappers' path launches {vw_counts}, want {want}")
    layers, layer_counts = counted("each prefix of the vector wrappers' chain", time_chain_layers)
    want = {"cartpole_rollout_fused": 0, **gen_zero, hc_build: (1 + len(VW_LAYERS)) * VW_LAYER_STEPS}
    check(layer_counts == want, f"the chain prefixes launched {layer_counts}, want {want}")
    vector_wrappers["ms_a_step_by_prefix"] = layers
    print(f"vector wrappers over make_vec('HalfCheetah-v5', {NUM_ENVS}): {vector_wrappers['ms_a_step']:.4f} ms a "
          f"step ({VW_STEPS} steps, {vector_wrappers['episodes']} episodes of {VW_LIMIT} steps); under each prefix "
          f"of the chain ({VW_LAYER_STEPS} steps each, the bare env first): {json.dumps(layers)} "
          f"(host clock; {card_line()})", flush=True)
    vector_wrappers["device_vs_cpu"] = compare_vector_wrappers_with_cpu(dev)
    print(f"the vector wrappers' chain on the card vs the CPU: {vector_wrappers['device_vs_cpu']}", flush=True)
    cartpole_stats, cartpole_stats_counts = counted(f"RecordEpisodeStatistics over make_vec('CartPole-v1', {NUM_ENVS})",
                                                    run_cartpole_episode_stats)
    check(not any(cartpole_stats_counts.values()), f"the CartPole statistics path launched {cartpole_stats_counts}")
    print(f"RecordEpisodeStatistics and DictInfoToList over make_vec('CartPole-v1', {NUM_ENVS}): "
          f"{json.dumps(cartpole_stats)}", flush=True)
    lap("the vector wrappers")
    rendering, render_counts = counted("the rendering wrappers",
                                       lambda: run_rendering(dev, os.path.join(scratch, "videos")))
    want = {"cartpole_rollout_fused": 0, **gen_zero, hc_build: 2 * RENDER_STEPS + RECORD_STEPS}
    check(render_counts == want, f"the rendering path launches {render_counts}, want {want}")
    print(f"rendering: RecordVideo took the {rendering['record_video']['encoder']} branch "
          f"({rendering['record_video']['file']}, {rendering['record_video']['bytes']} bytes)", flush=True)
    print(json.dumps({"vector_wrappers": {"card": card_line(), "half_cheetah": vector_wrappers,
                                          "cartpole_episode_statistics": cartpole_stats},
                      "rendering": {"card": card_line(), **rendering}}), flush=True)
    lap("the rendering wrappers")
    checkers, checker_counts = counted("the checkers and conversions",
                                       lambda: run_checkers_and_conversion(dev, hc_build, planar.build_name))
    for build_name in (hc_build, planar.build_name):
        by_part = sum(part[build_name] for part in checkers["launches_by_part"].values())
        check(checker_counts[build_name] == by_part > 0,
              f"the checkers' path launched {checker_counts[build_name]} of {build_name}, its parts {by_part}")
    check(not any(v for k, v in checker_counts.items() if k not in (hc_build, planar.build_name)),
          f"the checkers' path launched {checker_counts}")
    for env_id in CHECKER_IDS:
        result = checkers[f"check_env({env_id})"]
        print(f"check_env(make({env_id!r}).unwrapped) on the card ({result['path']}): passed in "
              f"{result['seconds']:.3f} s, {result.get('launches', 0)} kernel launches, "
              f"{len(result['warnings'])} warnings", flush=True)
    for env_id in CHECKER_MATCH_IDS:
        result = checkers[f"check_environments_match({env_id})"]
        print(f"check_environments_match({env_id}: card vs CPU, {result['steps']} steps, atol {result['atol']}): "
              f"passed; largest deviation {json.dumps(result['max_abs_dev'])}", flush=True)
    conversion = checkers["ArrayConversion"]
    print(f"ArrayConversion(make_vec('HalfCheetah-v5', {conversion['envs']}), 'torch', 'numpy'): "
          f"{conversion['converted_ms_a_step']:.4f} ms a step against the bare env's "
          f"{conversion['bare_ms_a_step']:.4f} (host clock, {conversion['steps']} steps a run, two runs each "
          f"in turns), {conversion['launches_a_step']} launch a step, outputs {conversion['outputs']}", flush=True)
    print(f"play took the branch: {checkers['play']['branch']}", flush=True)
    print("examples: " + ", ".join(f"{name} rc {r['rc']}" for name, r in checkers["examples"].items()
                                   if name != "seconds_all"), flush=True)
    print(json.dumps({"checkers_and_conversion": {"card": card_line(), **checkers}}), flush=True)
    lap("the checkers and conversions")
    parallel = run_parallel(dev)
    one = parallel["one_rank"]
    reacher_build = steps["reacher"].build_name
    # an env step one articulated launch, the lander's two (the transition, the
    # reset tick drawn for every lane) after one at reset; scaling_report: a
    # warm and 5 timed rollouts sharded, the same on the whole batch alone
    parallel_want = {
        "half_cheetah": {hc_build: PARALLEL_CHEETAH_STEPS},
        "lunar_lander": {planar.build_name: 1 + 2 * PARALLEL_LANDER_STEPS},
        "ppo_half_cheetah": {hc_build: PPO_ROLLOUT},
        "scaling_report": {hc_build: 2 * 6 * PARALLEL_SCALING_STEPS},
        "dryrun": {hc_build: 2, reacher_build: 1},
    }
    for part, want in parallel_want.items():
        check(one[part]["launches"] == want, f"parallel {part} launches {one[part]['launches']}, want {want}")
    parallel_launches = collections.Counter()
    for part in parallel_want:
        parallel_launches.update(one[part]["launches"])
    for rank in parallel["multi_rank"] if isinstance(parallel["multi_rank"], list) else ():
        for part in ("half_cheetah", "lunar_lander"):
            parallel_launches.update(rank[part]["launches"])
    parallel["launches"] = dict(parallel_launches)
    print(f"parallel: torch {parallel['torch']}, NCCL available {parallel['nccl_available']}, one NCCL rank in "
          f"{one['seconds']:.1f} s: HalfCheetah {NUM_ENVS} x {PARALLEL_CHEETAH_STEPS} sharded in "
          f"{one['half_cheetah']['seconds']:.2f} s (unsharded {one['half_cheetah']['unsharded_seconds']:.2f} s) and "
          f"LunarLander {NUM_ENVS} x {PARALLEL_LANDER_STEPS} in {one['lunar_lander']['seconds']:.2f} s (unsharded "
          f"{one['lunar_lander']['unsharded_seconds']:.2f} s), each equal to the unsharded env in every bit; PPO step "
          f"{one['ppo_half_cheetah']['seconds']:.2f} s (largest parameter difference "
          f"{one['ppo_half_cheetah']['max_abs_param_diff']:.3e}, in bits: {one['ppo_half_cheetah']['params_in_bits']}); "
          f"scaling_report {json.dumps({k: v for k, v in one['scaling_report'].items() if k != 'launches'})}; "
          f"example {parallel['example']['seconds']:.1f} s; multi-rank: "
          f"{parallel['multi_rank'] if isinstance(parallel['multi_rank'], str) else len(parallel['multi_rank'])}; "
          f"launches {parallel['launches']}", flush=True)
    for line in one["dryrun"]["lines"]:
        print(line, flush=True)
    print(json.dumps({"parallel": {"card": card_line(), **parallel}}), flush=True)
    lap("the sharded paths")
    for entry in kernels:
        if entry["name"] == "articulated_step[half_cheetah]":
            build_name = steps["half_cheetah"].build_name
            entry["launches_by_path"] = {"half_cheetah TorchVectorEnv": entry["launches"],
                                         "ppo half_cheetah": ppo_counts["half_cheetah"][build_name]}
            entry["launches"] += ppo_counts["half_cheetah"][build_name]

    # the registry's paths are part of the main path: their launches join each kernel's count
    kernel_build = {"cartpole_rollout_fused": "cartpole_rollout_fused", "walker_terrain": "walker_terrain",
                    "planar_step[lunar_lander]": planar.build_name, "planar_step[bipedal_walker]": walker.build_name,
                    **{f"articulated_step[{name}]": step.build_name for name, step in steps.items()}}
    kernel_build["articulated_step[swimmer_fs1]"] = more["swimmer_fs1"].build_name
    registry_paths = {**{f"make_vec({env_id!r})": registry_counts[env_id] for env_id in REGISTRY_IDS},
                      'make("phys2d/CartPole-v1")': single_cartpole_counts,
                      **{f"FunctionalTorchEnv({env_id})": single_counts[env_id] for env_id in SINGLE_IDS},
                      **{f"make({env_id!r})": host_counts[env_id] for env_id in HOST_IDS},
                      **{f"make({label!r})": box2d_counts[label] for label in BOX2D_PATHS},
                      "the host classes": host_class_counts,
                      "benchmark_step(make('HalfCheetah-v5'))": bench_step_counts,
                      f"benchmark_compiled_rollout(make_vec('HalfCheetah-v5', {NUM_ENVS}))": compiled_counts,
                      "trace": trace_counts, "checkpoint of the HalfCheetah PPO state": resume_counts,
                      **{f"make_vec({env_id!r}, {VEC_ENVS}, sync)": vec_counts[env_id] for env_id in vec_paths},
                      f"make_vec('HalfCheetah-v5', {VEC_ENVS}, async) workers (reported by call)":
                          sum(map(collections.Counter, async_run["worker_launches"]), collections.Counter()),
                      "host wrappers over make('HalfCheetah-v5')": wrapped_counts,
                      f"vector wrappers over make_vec('HalfCheetah-v5', {NUM_ENVS})": vw_counts,
                      "each prefix of the vector wrappers' chain": layer_counts,
                      "the rendering wrappers over make('HalfCheetah-v5')": render_counts,
                      "the checkers and conversions": checker_counts,
                      "the sharded paths (parallel/, NCCL)": parallel["launches"]}
    for entry in kernels:
        build_name = kernel_build.get(entry["name"])
        by_path = {path: counts[build_name] for path, counts in registry_paths.items() if counts.get(build_name)}
        if by_path:
            earlier = entry.get("launches_by_path", {"direct TorchVectorEnv paths": entry["launches"]})
            entry["launches_by_path"] = {**earlier, **by_path}
            entry["launches"] += sum(by_path.values())
        if entry["name"] in small:
            entry["small_batches"] = small[entry["name"]]
        key = entry["name"][len("articulated_step["):-1] if entry["name"].startswith("articulated_step[") else None
        if key in host_small:
            entry["n1"] = host_small[key]
    print(json.dumps({"registry": {
        "card": card_line(), "envs": NUM_ENVS,
        "make_vec": {env_id: {k: v for k, v in r.items() if not k.startswith("_")} for env_id, r in registry.items()},
        "make": single_cartpole,
        "functional_torch_env": {env_id: {k: v for k, v in r.items() if not k.startswith("_")}
                                 for env_id, r in single.items()},
        "kernels_small_batches": small,
        "device_spaces": device_spaces,
    }}), flush=True)
    lap("all phases")
    print(json.dumps({"kernels": kernels}), flush=True)
    result = {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
