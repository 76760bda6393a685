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
one ``{"ppo": {...}}`` line, one
``{"kernels": [...]}`` line, and last the line ``{"ok": true, "device":
{...}}``. Any failed check
raises, so the exit code is 0 only when every phase passed. Without a CUDA
device it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import copy
import functools
import json
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

# The cheap functionals (gymnasium_tpu_torch.envs.<module>.<class>): bench.py's
# four FAMILY_CASES rows by their names there, then the others. Each entry:
# (class, options, the step limit gymnasium_tpu/envs/__init__.py registers,
# rollout steps). CliffWalking registers none and takes 200, as
# tests/functional/test_tabular.py does; Blackjack and CPD end by
# themselves. CPD plays random opponents, the policy whose step draws.
CLASSIC_ENVS = {
    "frozenlake8x8": ("tabular.FrozenLake8x8Functional", {}, 200, 512),
    "taxi_v3": ("tabular.TaxiFunctional", {}, 200, 512),
    "pendulum_v1": ("phys2d.PendulumFunctional", {}, 200, 512),
    "mountaincar_continuous_v0": ("phys2d.ContinuousMountainCarFunctional", {}, 999, 512),
    "acrobot_v1": ("phys2d.AcrobotFunctional", {}, 500, 100),
    "mountaincar_v0": ("phys2d.MountainCarFunctional", {}, 200, 100),
    "cliffwalking_v1": ("tabular.CliffWalkingFunctional", {}, 200, 100),
    "blackjack_v1": ("tabular.BlackjackFunctional", {}, None, 100),
    "cpd_random": ("blockchain.BlockchainCPDFunctional", {"opponent_policy": "random"}, None, 100),
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


def compare_planar_with_twin(step, inputs) -> dict:
    """One kernel call against the plain twin on the same inputs. Raises on
    any differing value or flag, if two calls differ in a bit, or if a side
    of the solver is reached by no lane. Returns the largest deviations (0),
    whether the bits are equal too, and the branch counts."""
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
    check(not missing, f"{step.name}: no lane reaches {missing}")
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
    env = TorchVectorEnv(func, n, max_episode_steps=func.max_episode_steps, device=dev)
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
    from gymnasium_tpu_torch.wrappers import StickyAction

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
    from gymnasium_tpu_torch import wrappers as w
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


def classic_env(name: str):
    """A new instance of the functional env ``name`` of :data:`CLASSIC_ENVS`."""
    import importlib

    path, options, _, _ = CLASSIC_ENVS[name]
    module, cls = path.rsplit(".", 1)
    return getattr(importlib.import_module(f"gymnasium_tpu_torch.envs.{module}"), cls)(dict(options))


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

    _, _, limit, rollout = CLASSIC_ENVS[name]
    env = TorchVectorEnv(classic_env(name), n, max_episode_steps=limit, device=dev)
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


def cpu_and_card_traces(dev, func, n: int, actions, limit: int | None, extra=lambda env: ()):
    """``len(actions)`` steps of ``func`` at ``n`` envs under ``TorchVectorEnv``
    (step limit ``limit``) on the CPU with its draws recorded, then on
    ``dev`` with the same draws and actions. Returns both traces, on the
    CPU: the reset's ``(obs, state, *extra(env))``, then each step's
    ``(obs, reward, terminated, truncated, steps, state, *extra(env))``.
    Raises if the card took fewer draws than the CPU."""
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
        obs, _ = env.reset(seed=0)
        trace = [(obs, env.carry.state, *extra(env))]
        for action in actions:
            obs, reward, term, trunc, _ = env.step(action.to(device))
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


def ppo_case(name: str, n: int = NUM_ENVS, rollout: int = PPO_ROLLOUT, compute_dtype=torch.bfloat16):
    """``(func_env, config, wrappers)`` of a PPO workload of ``tools/bench_ppo.py``,
    HalfCheetah with the episode statistics of the multichip dry run added."""
    from gymnasium_tpu_torch.train.ppo import PPOConfig
    from gymnasium_tpu_torch.wrappers import EpisodeStatistics, NormalizeObservation, NormalizeReward

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
    sass = {name: sass_instructions(build.library_path(name)) for name in build.KERNELS}
    sass.update({name: sass_instructions(build.library_path(name, text)) for name, text in generated.items()})
    print("SASS instructions a library: " + ", ".join(f"{k} {v}" for k, v in sass.items()), flush=True)

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
        out = fn()
        torch.cuda.synchronize()
        counts = {"cartpole_rollout_fused": cr.launches, **gen_zero, **art.launches, **pl.launches,
                  "walker_terrain": wt.launches}
        print(f"path {label}: launches {counts}", flush=True)
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
    # -- profiled paths: one Ant env step, the PPO trainer --------------------
    # They run after the kernel timings: a device_ms trace taken after other
    # profiled work in the process missed one CartPole launch in every try.
    ant_profile = profile_env_step(dev, articulated_env("ant"), "ant", ART_TIME_LIMIT, "kernel<ArticulatedStep>")
    print(f"ant TorchVectorEnv step under torch.profiler (N={NUM_ENVS}): {json.dumps(ant_profile)}", flush=True)
    next(k for k in kernels if k["name"] == "articulated_step[ant]")["env_step_profile"] = ant_profile
    for name in CLASSIC_BENCH_ROWS:
        classic[name]["env_step_profile"] = profile_env_step(dev, classic_env(name), name, CLASSIC_ENVS[name][2])
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
            dev, walker_env(hardcore), name, walker_env(hardcore).max_episode_steps, "step_kernel", launches_a_step=2)
        print(f"{name} TorchVectorEnv step under torch.profiler (N={NUM_ENVS}): "
              f"{json.dumps(bipedal[name]['env_step_profile'])}", flush=True)
        bipedal[name]["device_vs_cpu"] = compare_bipedal_with_cpu(dev, hardcore)
        print(f"{name} on the card vs the CPU ({BIPEDAL_CHECK_STEPS} steps from the CPU's carry, N={NUM_ENVS}, "
              f"same draws): {bipedal[name]['device_vs_cpu']}", flush=True)
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
    for name in CLASSIC_ENVS:
        classic[name]["device_vs_cpu"] = compare_classic_with_cpu(dev, name)
        print(f"{name} on the card vs the CPU ({CLASSIC_CHECK_STEPS} steps, N={NUM_ENVS}, injected draws): "
              f"{classic[name]['device_vs_cpu']}", flush=True)
    print(json.dumps({"classic": {"card": card_line(), "envs": NUM_ENVS, **classic}}), flush=True)
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
    for entry in kernels:
        if entry["name"] == "articulated_step[half_cheetah]":
            build_name = steps["half_cheetah"].build_name
            entry["launches_by_path"] = {"half_cheetah TorchVectorEnv": entry["launches"],
                                         "ppo half_cheetah": ppo_counts["half_cheetah"][build_name]}
            entry["launches"] += ppo_counts["half_cheetah"][build_name]

    print(json.dumps({"kernels": kernels}), flush=True)
    result = {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
