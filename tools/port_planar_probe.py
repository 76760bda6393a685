#!/usr/bin/env python3
"""Compare the planar kernel's rolled and unrolled forms, and the block shapes of the planar and CartPole kernels, on one CUDA card.

Run from the repository root on a machine with a card::

    python3 tools/port_planar_probe.py

It builds, all at once through ``gymnasium_tpu_torch.ops.build``: the
LunarLander planar step the port runs (solver iterations as C loops, one
``sincosf`` an angle, 32 threads a block) and, as copies of its source text,
the same step unrolled (:func:`unrolled_step`: the program of the kernel's
first port, with ``sinf`` and ``cosf``) and both forms with 64 and 128
threads a block (:func:`block_variant`); and variants of the CartPole
rollout kernel: copies of ``csrc/cartpole_rollout.cu`` with 32 and 128
threads a block instead of 64, and three that each take back one change of
its design (:data:`ABLATIONS`): the draw made at the top of its own step,
``sinf`` and ``cosf`` for ``sincosf``, and a branch between the reset and the
transition; and one that takes back all three. For each library it reports
nvcc's time, registers and spills (``-Xptxas -v``), its SASS instructions
(``cuobjdump``) and, for each kernel, the instructions of each loop body
(from the target of each backward branch to the branch). Then:

- it holds the two planar forms equal, bit for bit, on
  ``chip_smoke.planar_states`` at N=4096, and times them in turns (unrolled,
  rolled, rolled, unrolled) at blocks of 32, 64 and 128 threads with CUDA
  events (``chip_smoke.cuda_ms``), and each once by ``torch.profiler``'s
  kernel durations (``chip_smoke.device_ms``);
- it times the rolled form over N = 1024 ... 65536 at each block shape. A
  time that does not grow with N means each env's dependent chain, not the
  card's instruction rate, sets it;
- it holds each CartPole variant's outputs equal, bit for bit, to the
  shipped kernel's at N=4096, S=2048, and times the shipped kernel and the
  variants in turns, forward then backward, with f32 and bf16 observations,
  by events and by the profiler;
- it runs ``chip_smoke.run_lunar_lander`` (``TorchVectorEnv`` at 4096 envs,
  ``rollout(200)``, host clock) in turns with the rolled kernel at 32 and
  128 threads a block and the unrolled one at 128, and profiles 20 steps of
  each with ``torch.profiler``: the device's busy share of the window (the
  sum of kernel times over the wall time), kernels a step, and the planar
  kernel's share.

It prints one line per measurement, the card's name and power limit, and
last one JSON object of every number.

``python3 tools/port_planar_probe.py lanes`` runs only the lane-group sweep
(:func:`lane_sweep`): each build of the walker and the lander at every lane
count its world fits (``planar_codegen.LANE_CHOICES``, one lane included:
the one-thread text) and at 32, 64 and 128 threads a block; beside them, at
32 threads, the walker's groups with their heightfield in global memory
(the generator stages it in shared memory). Each build's nvcc report
(registers, spills, shared bytes), SASS instructions and loop bodies; each
held to its twin in every bit at N=4096, 333 and 1; each timed by CUDA
events at those N in turns (the list forward, then back), and by
``torch.profiler`` at N=4096. Then the walker's end-to-end paths with the
one-lane build and with the generator's own choice, in turns (one, chosen,
chosen, one): the host step of ``make("BipedalWalker-v3")`` and the
env-steps/s of ``make_vec("BipedalWalker-v3", 4096)``'s ``rollout(200)``.
``lanes PATH`` also writes every number, as JSON, to ``PATH``.

``python3 tools/port_planar_probe.py autoreset [PATH]`` times the Box2D
functionals' two autoreset forms in turns (one-launch, two-launch,
two-launch, one-launch, twice) under ``TorchVectorEnv`` at 4096 envs: LunarLander
and both walkers, the two-launch form being the env with its
``autoreset_transition`` hidden. Each turn gives ``chip_smoke.profile_env_step``'s
numbers after a warm-up (host ms a step, and under ``torch.profiler`` the
device's busy ms, kernels and the planar build's launches and device ms a
step) and the host ms a step of a ``rollout(200)`` (:func:`autoreset_turns`).

``python3 tools/port_planar_probe.py terrain [PATH]`` builds the terrain
kernel as shipped (8 envs a block), copies of its text with 32, 16 and 4
envs a block (:data:`TERRAIN_GROUPS`), each also with ``WT_CLOCKS`` defined (``clock64()``
stamps at each phase's end), and the kernel before its redesign
(``tools/walker_terrain_before.cu``) with and without stamps; holds each to
the twin in every bit at N=4096, 333 and 1, normal and hardcore; reads each
stamped build's phase clocks (staging, walk, overlay, store: the mean and
the largest over blocks) there; and times the unstamped kernels in turns
(the list forward, then back) by CUDA events at each N and by
``torch.profiler`` at 4096 (:func:`terrain_probe`). ``PATH`` takes every
number of either mode as JSON.

``python3 tools/port_planar_probe.py codegen`` needs no card: it times, on
the host's clock, ``planar_codegen.generate_planar_source`` for both worlds
and the ``lane_estimates`` inside it (:func:`codegen_seconds`), the work
the first build of a world does in each process, the kernel's library
cached or not.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import json
import re
import sys
import time
from pathlib import Path
from unittest import mock

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import (  # noqa: E402
    BIPEDAL_RAGGED,
    PLANAR_GRAVITY,
    SASS_BYTES,
    card_line,
    compare_planar_with_twin,
    cuda_ms,
    device_ms,
    planar_bound_ms,
    planar_states,
    ptxas_summary,
    query_gpu,
    run_lunar_lander,
    sass_instructions,
    sass_text,
    walker_states,
)
from gymnasium_tpu_torch.ops import build, planar_codegen  # noqa: E402
from gymnasium_tpu_torch.ops.codegen import SymOps  # noqa: E402

BLOCKS = (32, 64, 128)
BATCHES = (1024, 2048, 4096, 8192, 16384, 65536)
NUM_ENVS = 4096
STEPS = 2048
CARTPOLE_BLOCK_LINE = "constexpr int kBlock = 64;"
PLANAR_BLOCK_LINE = "constexpr int kBlock = 32;"
# the transition and the reset select of csrc/cartpole_rollout.cu, which the
# "branch" variant puts back into if (done) { reset } else { transition }
_TRANSITION = """    const float force = (r.x & 1u) ? p.force_mag : -p.force_mag;
    float sintheta, costheta;
    sincosf(theta, &sintheta, &costheta);
    const float temp =
        (force + p.polemass_length * (theta_dot * theta_dot) * sintheta) / p.total_mass;
    const float thetaacc =
        (p.gravity * sintheta - costheta * temp) /
        (p.length * (4.0f / 3.0f - p.masspole * (costheta * costheta) / p.total_mass));
    const float xacc = temp - p.polemass_length * thetaacc * costheta / p.total_mass;
    const float nx = x + p.tau * x_dot;
    const float nx_dot = x_dot + p.tau * xacc;
    const float ntheta = theta + p.tau * theta_dot;
    const float ntheta_dot = theta_dot + p.tau * thetaacc;
    x = done ? reset_value(r.x, p.reset_bound) : nx;
    x_dot = done ? reset_value(r.y, p.reset_bound) : nx_dot;
    theta = done ? reset_value(r.z, p.reset_bound) : ntheta;
    theta_dot = done ? reset_value(r.w, p.reset_bound) : ntheta_dot;
    t = done ? 0 : t + 1;
"""
#: Each takes back one change of the CartPole kernel's design: (old, new) text edits.
ABLATIONS = {
    "draw_in_step": [
        ("  uint4 r = philox4x32_10(make_uint4(e, 0u, 0u, 0u), seed, 0u);\n", ""),
        ("    const uint4 r_next = philox4x32_10(make_uint4(e, s + 1, 0u, 0u), seed, 0u);",
         "    const uint4 r = philox4x32_10(make_uint4(e, s, 0u, 0u), seed, 0u);"),
        ("    r = r_next;\n", ""),
    ],
    "sinf_cosf": [
        ("float sintheta, costheta;", "const float costheta = cosf(theta);"),
        ("sincosf(theta, &sintheta, &costheta);", "const float sintheta = sinf(theta);"),
    ],
    "branch": [
        (_TRANSITION, """    if (done) {
      x = reset_value(r.x, p.reset_bound);
      x_dot = reset_value(r.y, p.reset_bound);
      theta = reset_value(r.z, p.reset_bound);
      theta_dot = reset_value(r.w, p.reset_bound);
      t = 0;
    } else {
""" + "".join("  " + line + "\n" for line in _TRANSITION.splitlines()[:9]) + """      x = x + p.tau * x_dot;
      x_dot = x_dot + p.tau * xacc;
      theta = theta + p.tau * theta_dot;
      theta_dot = theta_dot + p.tau * thetaacc;
      t = t + 1;
    }
"""),
    ],
}


class UnrolledSymOps(SymOps):
    """The C backend with ``repeat`` as a Python loop, every pass traced
    anew, and ``sincos`` as a ``cos`` and a ``sin`` node: the planar
    generator then emits its solver iterations as straight-line code with
    ``cosf`` and ``sinf``, as the kernel's first port did. Equal nodes are
    still shared, so the program runs the same operations."""

    def repeat(self, n, carried, body, homes=None):
        carried = list(carried)
        for _ in range(n):
            carried = list(body(carried))
        return carried

    def sincos(self, x):
        c = self.cos(x)
        return self.sin(x), c


@contextlib.contextmanager
def unrolled_generator():
    """Within it, ``planar_codegen.generate_planar_source`` emits the unrolled
    form, one thread an env."""
    with mock.patch.object(planar_codegen, "SymOps", UnrolledSymOps), \
            mock.patch.object(planar_codegen, "LANE_CHOICES", (1,)):
        yield


def _with_source(step, suffix: str, source):
    """A copy of a ``FusedPlanarStep`` whose kernel is built from ``source``,
    under its own build name (``<name>_<suffix>``) and launch count."""
    other = copy.copy(step)
    other.name = f"{step.name}_{suffix}"
    other._source, other._launch = source, None
    return other


def unrolled_step(step):
    """``step`` with its kernel emitted unrolled (:class:`UnrolledSymOps`)."""
    with unrolled_generator():
        source = planar_codegen.generate_planar_source(*step._args, f"{step.name}_unrolled")
    return _with_source(step, "unrolled", source)


def block_variant(step, block: int):
    """``step`` built with ``block`` threads a block: its text with
    ``csrc/planar_step.cuh`` pasted in place of the include, at that block."""
    header = (build.SOURCE_DIR / "planar_step.cuh").read_text()
    include = '#include "planar_step.cuh"'
    text = step.source.text
    if header.count(PLANAR_BLOCK_LINE) != 1 or text.count(include) != 1:
        raise RuntimeError("the planar source does not hold, once, the lines a block variant edits")
    text = text.replace(include, header.replace(PLANAR_BLOCK_LINE, f"constexpr int kBlock = {block};"))
    return _with_source(step, f"b{block}", dataclasses.replace(step.source, text=text))


def lane_variant(step, lanes: int, block: int = 32, stage: bool = False):
    """``step`` emitted over ``lanes`` lanes an env, with the heightfield
    staged in shared memory where ``stage``, built with ``block`` threads a
    block."""
    source = planar_codegen.generate_planar_source(*step._args, step.name, lanes=lanes, stage_terrain=stage)
    suffix = f"g{lanes}{'t' if stage else ''}"
    other = _with_source(step, suffix, source)
    return other if block == 32 else block_variant(other, block)


LANE_BATCHES = (NUM_ENVS, BIPEDAL_RAGGED, 1)
E2E_STEPS = 300  # host steps of make("BipedalWalker-v3") a turn
E2E_ROLLOUT = 200


def walker_e2e(dev, solver) -> dict:
    """The walker's two end-to-end paths with ``solver`` as its fused step:
    the host-clock ms a step of ``make("BipedalWalker-v3")`` (after a reset
    and 20 untimed steps; an episode that ends is reset inside the timing)
    and the env-steps/s of ``make_vec(..., 4096).rollout(200)`` after an
    untimed ``rollout(5)``."""
    import numpy as np

    import gymnasium_tpu_torch as gym
    from gymnasium_tpu_torch.envs.box2d import bipedal_walker as bw

    with mock.patch.object(bw, "walker_solver", lambda: solver):
        env = gym.make("BipedalWalker-v3")
        env.reset(seed=0)
        actions = np.random.default_rng(0).uniform(-1, 1, (E2E_STEPS + 20, 4)).astype(np.float32)
        for a in actions[:20]:
            env.step(a)
        start = time.perf_counter()
        for a in actions[20:]:
            _, _, term, trunc, _ = env.step(a)
            if term or trunc:
                env.reset()
        host_ms = (time.perf_counter() - start) * 1e3 / E2E_STEPS
        env.close()
        venv = gym.make_vec("BipedalWalker-v3", NUM_ENVS)
        venv.reset(seed=0)
        venv.rollout(5)
        torch.cuda.synchronize()
        start = time.perf_counter()
        venv.rollout(E2E_ROLLOUT)
        torch.cuda.synchronize()
        rate = NUM_ENVS * E2E_ROLLOUT / (time.perf_counter() - start)
    return {"host_step_ms": host_ms, "rollout_env_steps_per_s": rate}


def lane_sweep(dev, card: str) -> dict:
    """The lane-group sweep of both planar builds (module docstring)."""
    from gymnasium_tpu_torch.envs.box2d.bipedal_walker import walker_solver
    from gymnasium_tpu_torch.envs.dynamics import lunar_lander as dyn

    bases = {"bipedal_walker": walker_solver(), "lunar_lander": dyn.lander_step(PLANAR_GRAVITY)}
    states = {"bipedal_walker": walker_states, "lunar_lander": planar_states}
    variants = {}
    for label, base in bases.items():
        staged = base.source.layout["stage_terrain"]
        for lanes in sorted(base.source.layout["estimates"]):
            for block in BLOCKS:
                variants[(label, lanes, block, staged and lanes > 1)] = lane_variant(base, lanes, block,
                                                                                     staged and lanes > 1)
            if staged and lanes > 1:
                variants[(label, lanes, 32, False)] = lane_variant(base, lanes, 32, False)
    built = build.build([], {step.build_name: step.source.text for step in variants.values()})
    rows = []
    for (label, lanes, block, stage), step in variants.items():
        lib, info = build.library_path(step.build_name, step.source.text), built.get(step.build_name, {})
        count = sass_instructions(lib)
        bodies = loop_bodies(sass_text(lib))
        rows.append({"build": label, "lanes": lanes, "block": block, "stage_terrain": stage,
                     "build_name": step.build_name,
                     "chosen": step.source.text == bases[label].source.text and block == 32,
                     "estimate": bases[label].source.layout["estimates"][lanes],
                     "sass_instructions": count, "code_bytes": SASS_BYTES * count,
                     "loop_bodies": next((v for k, v in bodies.items() if "step_kernel" in k), []),
                     "nvcc_s": info.get("seconds"), **ptxas_summary(info.get("log", ""))})
        print(f"lanes build: {rows[-1]}", flush=True)
    inputs = {(label, n): states[label](n, dev, seed=n) for label in bases for n in LANE_BATCHES}
    for label, base in bases.items():  # the twin's sides and the chosen build's bits, once
        compare_planar_with_twin(base, inputs[(label, NUM_ENVS)])
    twins = {key: bases[key[0]].reference(*x) for key, x in inputs.items()}
    for row, step in zip(rows, variants.values()):
        for n in LANE_BATCHES:
            got = step(*inputs[(row["build"], n)])
            torch.cuda.synchronize()
            row[f"bit_equal_{n}"] = all((a is None and b is None) or bits_equal(a, b)
                                        for a, b in zip(got, twins[(row["build"], n)]))
            if not row[f"bit_equal_{n}"]:
                raise RuntimeError(f"{row['build_name']} differs from its twin at N={n}")
        print(f"lanes {row['build_name']}: equal to the twin in every bit at N={LANE_BATCHES}", flush=True)
    for row in rows:
        row.update({f"events_ms_{n}": [] for n in LANE_BATCHES})
    for label in bases:
        mine = [(row, step) for row, step in zip(rows, variants.values()) if row["build"] == label]
        for n in LANE_BATCHES:
            for row, step in mine + mine[::-1]:
                row[f"events_ms_{n}"].append(cuda_ms(lambda: step(*inputs[(label, n)]), 50, 5))
        for row, step in mine:
            row["device_ms_4096"] = device_ms(lambda: step(*inputs[(label, NUM_ENVS)]), "step_kernel", 50)
            row["bound_ms_4096"] = planar_bound_ms(step, NUM_ENVS)[0]
            print(f"lanes {label} G={row['lanes']} block={row['block']} "
                  f"stage={row['stage_terrain']}: device {row['device_ms_4096']:.4f} ms at N={NUM_ENVS}; "
                  + "; ".join(f"events N={n} {row[f'events_ms_{n}']}" for n in LANE_BATCHES), flush=True)
    one = variants[("bipedal_walker", 1, 32, False)]
    chosen = bases["bipedal_walker"]
    e2e = {"one_lane": [], "chosen": []}
    for name in ("one_lane", "chosen", "chosen", "one_lane"):
        solver = one if name == "one_lane" else chosen
        e2e[name].append(walker_e2e(dev, solver))
        print(f"walker end to end, {name} ({solver.build_name}): {e2e[name][-1]}", flush=True)
    return {"card": card, "rows": rows, "walker_e2e": e2e,
            "layouts": {label: base.source.layout for label, base in bases.items()}}


AUTORESET_PATHS = ("lunar_lander", "bipedal_walker", "bipedal_walker_hardcore")
AUTORESET_LIMITS = {"lunar_lander": 1000, "bipedal_walker": 1600, "bipedal_walker_hardcore": 2000}


def autoreset_turns(dev) -> dict:
    """Each of :data:`AUTORESET_PATHS` under ``TorchVectorEnv`` at 4096 envs in
    both autoreset forms, in turns (module docstring): per turn
    ``profile_env_step``'s numbers and a ``rollout(200)``'s host ms a step."""
    from chip_smoke import autoreset_env, profile_env_step

    from gymnasium_tpu_torch.vector import TorchVectorEnv

    out = {}
    for name in AUTORESET_PATHS:
        rows = out[name] = {"one_launch": [], "two_launch": []}
        for form in ("one_launch", "two_launch", "two_launch", "one_launch") * 2:
            func = autoreset_env(name)
            if form == "two_launch":
                func.autoreset_transition = None
            row = profile_env_step(dev, func, f"{name} {form}", AUTORESET_LIMITS[name], "step_kernel",
                                   launches_a_step=1 if form == "one_launch" else 2)
            env = TorchVectorEnv(func, NUM_ENVS, max_episode_steps=AUTORESET_LIMITS[name], device=dev)
            env.reset(seed=0)
            env.rollout(5)
            torch.cuda.synchronize()
            start = time.perf_counter()
            env.rollout(E2E_ROLLOUT)
            torch.cuda.synchronize()
            row["rollout_host_ms_a_step"] = (time.perf_counter() - start) * 1e3 / E2E_ROLLOUT
            rows[form].append(row)
            print(f"autoreset {name} {form}: host {row['step_ms']:.4f} ms a step (rollout(200) "
                  f"{row['rollout_host_ms_a_step']:.4f}), device {row['device_busy_ms_a_step']:.4f} ms, "
                  f"{row['kernels_a_step']:.1f} kernels, planar {row['kernel_device_ms_a_step']:.4f} ms a step, "
                  f"busy {row['device_busy_share']:.1%}", flush=True)
    return out


TERRAIN_BATCHES = (NUM_ENVS, BIPEDAL_RAGGED, 1)
TERRAIN_BEFORE = Path(__file__).resolve().parent / "walker_terrain_before.cu"
TERRAIN_STAMPS = {"shipped": ("staging", "walk", "store"), "before": ("staging", "walk", "overlay", "store")}
TERRAIN_ENVS_LINE = "constexpr int kEnvs = 8;"
TERRAIN_GROUPS = (32, 16, 4)  # envs a block of the shipped text's variants


def terrain_library(name: str, text: str | None):
    """``(launch, clocks)`` of a terrain build: the library of ``csrc/walker_terrain.cu``
    (``text`` None) or of ``text``, its launcher typed as the wrapper types
    it, and its clock reader (None in a build without ``WT_CLOCKS``)."""
    lib = build.load(name, text)
    launch = lib.walker_terrain_launch
    launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    clocks = getattr(lib, "walker_terrain_clocks", None)
    if clocks is not None:
        clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
        clocks.restype = ctypes.c_int
    return launch, clocks


def terrain_probe(dev, card: str) -> dict:
    """The terrain kernel before and after its redesign (module docstring)."""
    import numpy as np
    from chip_smoke import terrain_bound_ms, terrain_draws

    from gymnasium_tpu_torch.ops import walker_terrain as wt

    shipped = (build.SOURCE_DIR / "walker_terrain.cu").read_text()
    before = TERRAIN_BEFORE.read_text()
    if shipped.count(TERRAIN_ENVS_LINE) != 1:
        raise RuntimeError("csrc/walker_terrain.cu does not hold, once, the line an envs-a-block variant edits")
    texts = {"shipped": None, "shipped_clocks": "#define WT_CLOCKS\n" + shipped,
             "before": before, "before_clocks": "#define WT_CLOCKS\n" + before}
    envs_a_block = {"shipped": 8, "before": 32}
    for envs in TERRAIN_GROUPS:
        text = shipped.replace(TERRAIN_ENVS_LINE, f"constexpr int kEnvs = {envs};")
        texts[f"shipped_e{envs}"], texts[f"shipped_e{envs}_clocks"] = text, "#define WT_CLOCKS\n" + text
        envs_a_block[f"shipped_e{envs}"] = envs
    envs_a_block.update({f"{label}_clocks": envs for label, envs in list(envs_a_block.items())})
    timed = [label for label in texts if not label.endswith("_clocks")]
    names = {label: "walker_terrain" if text is None else f"walker_terrain_{label}" for label, text in texts.items()}
    built = build.build(["walker_terrain"], {names[k]: t for k, t in texts.items() if t is not None})
    libraries, builds = {}, {}
    for label, text in texts.items():
        libraries[label] = terrain_library(names[label], text)
        lib, info = build.library_path(names[label], text), built.get(names[label], {})
        builds[label] = {"sass_instructions": sass_instructions(lib), "nvcc_s": info.get("seconds"),
                         **ptxas_summary(info.get("log", ""))}
        print(f"terrain build {label}: {builds[label]}", flush=True)

    def run(label, u, draws):
        with mock.patch.object(wt, "_launcher", lambda: libraries[label][0]):
            return wt.walker_terrain(u, draws)

    inputs = {n: terrain_draws(n, dev, seed=n) for n in TERRAIN_BATCHES}
    clocks = []
    for n, (u, d) in inputs.items():
        for mode, draws in (("normal", None), ("hardcore", d)):
            want = wt.walker_terrain_reference(u, draws)
            for label in texts:
                got = run(label, u, draws)
                torch.cuda.synchronize()
                if not bits_equal(got, want):
                    raise RuntimeError(f"terrain build {label} differs from the twin at N={n} ({mode})")
                read = libraries[label][1]
                if read is None:
                    continue
                kind = label.split("_")[0]
                stamps = len(TERRAIN_STAMPS[kind]) + 1
                blocks = -(-n // envs_a_block[label])
                buf = np.zeros(blocks * stamps, dtype=np.int64)
                rc = read(buf.ctypes.data, buf.size)
                if rc != 0:
                    raise RuntimeError(f"walker_terrain_clocks failed with cudaError {rc}")
                phases = np.diff(buf.reshape(blocks, stamps), axis=1)
                row = {"build": label[: -len("_clocks")], "n": n, "mode": mode, "blocks": blocks,
                       **{f"{p}_clocks": float(phases[:, i].mean()) for i, p in enumerate(TERRAIN_STAMPS[kind])},
                       **{f"{p}_clocks_max": int(phases[:, i].max()) for i, p in enumerate(TERRAIN_STAMPS[kind])},
                       "total_clocks": float(phases.sum(axis=1).mean()), "total_clocks_max": int(phases.sum(axis=1).max())}
                clocks.append(row)
                print(f"terrain clocks: {row}", flush=True)
    print(f"terrain builds equal to the twin in every bit at N={TERRAIN_BATCHES}, normal and hardcore", flush=True)
    times = {label: {f"{mode}_events_ms_{n}": [] for n in TERRAIN_BATCHES for mode in ("normal", "hardcore")}
             for label in timed}
    for label in timed + timed[::-1]:
        for n, (u, d) in inputs.items():
            for mode, draws in (("normal", None), ("hardcore", d)):
                times[label][f"{mode}_events_ms_{n}"].append(cuda_ms(lambda: run(label, u, draws), 50, 5))
    u, d = inputs[NUM_ENVS]
    for label in timed:
        for mode, draws in (("normal", None), ("hardcore", d)):
            ms = device_ms(lambda: run(label, u, draws), "terrain_kernel", 50)
            bound = terrain_bound_ms(NUM_ENVS, draws is not None)[0]
            times[label][f"{mode}_device_ms_{NUM_ENVS}"] = ms
            times[label][f"{mode}_bound_share_{NUM_ENVS}"] = bound / ms
        print(f"terrain {label}: {times[label]}", flush=True)
    return {"card": card, "sm_clock": query_gpu("clocks.sm"), "builds": builds, "clocks": clocks, "times": times}


def codegen_seconds(repeats: int = 3) -> dict:
    """Host seconds of each of ``repeats`` calls of
    ``generate_planar_source`` for the walker's and the lander's worlds, and
    of the ``lane_estimates`` on the traced program inside each."""
    from gymnasium_tpu_torch.envs.box2d.bipedal_walker import walker_solver
    from gymnasium_tpu_torch.envs.dynamics import lunar_lander as dyn

    out = {}
    for label, step in (("bipedal_walker", walker_solver()), ("lunar_lander", dyn.lander_step(PLANAR_GRAVITY))):
        row = out[label] = {"generate_s": [], "lane_estimates_s": []}
        for _ in range(repeats):
            start = time.perf_counter()
            planar_codegen.generate_planar_source(*step._args, step.name)
            row["generate_s"].append(time.perf_counter() - start)
            prog = planar_codegen._trace(planar_codegen.planar_tables(*step._args))
            start = time.perf_counter()
            planar_codegen.lane_estimates(prog)
            row["lane_estimates_s"].append(time.perf_counter() - start)
    return out


def cartpole_library(name: str, text: str) -> ctypes.CDLL:
    """A CartPole variant's library, its launcher typed as the shipped one's."""
    lib = build.load(name, text)
    fn = lib.cartpole_rollout_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return lib


def cartpole_variants(base: str) -> dict:
    """``{name: source}``: the block shapes other than the shipped one, each
    ablation, and all three ablations at once (``none_of_the_three``: the
    step loop of the kernel before its redesign)."""
    edits = {f"b{b}": [(CARTPOLE_BLOCK_LINE, f"constexpr int kBlock = {b};")] for b in BLOCKS if b != 64}
    edits.update(ABLATIONS)
    edits["none_of_the_three"] = ABLATIONS["branch"] + ABLATIONS["sinf_cosf"] + ABLATIONS["draw_in_step"]
    variants = {}
    for name, pairs in edits.items():
        text = base
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f"csrc/cartpole_rollout.cu does not hold, once, the text variant {name} edits")
            text = text.replace(old, new)
        variants[name] = text
    return variants


def loop_bodies(sass: str) -> dict:
    """``{kernel: [instructions of each loop body]}`` of a ``cuobjdump -sass``
    listing: for each backward branch, the instructions from its target to
    it, innermost loops first as they appear. A branch to itself (the trap
    at a function's end) is no loop."""
    bodies, kernel = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            kernel = head.group(1)
            bodies[kernel] = []
            continue
        inst = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*)", line)
        branch = re.search(r"\bBRA(?:\.\S+)?\s+`?\(?0x([0-9a-f]+)", inst.group(2)) if inst and kernel else None
        if branch and int(branch.group(1), 16) < int(inst.group(1), 16):
            bodies[kernel].append((int(inst.group(1), 16) - int(branch.group(1), 16)) // SASS_BYTES + 1)
    return bodies


def profile_lunar_lander(dev, planar_name: str, steps: int = 20) -> dict:
    """``torch.profiler`` over ``steps`` steps of ``TorchVectorEnv`` LunarLander
    at 4096 envs (after 5 unprofiled ones): the wall time a step with and
    without the profiler, the device's busy share (kernel time over wall
    time, one stream), kernels a step, and the kernels named
    ``planar``'s device time a step."""
    from torch.profiler import ProfilerActivity, profile

    from gymnasium_tpu_torch.envs.box2d.lunar_lander import LunarLanderFunctional
    from gymnasium_tpu_torch.vector import TorchVectorEnv

    env = TorchVectorEnv(LunarLanderFunctional(), NUM_ENVS, max_episode_steps=1000, device=dev)
    env.reset(seed=0)
    env.rollout(5)
    torch.cuda.synchronize()
    start = time.perf_counter()
    env.rollout(steps)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - start) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        env.rollout(steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / steps
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    planar_ms = sum(e.time_range.elapsed_us() for e in kernels if "planar" in e.name) / 1e3 / steps
    return {"planar_build": planar_name, "step_ms": plain_ms, "profiled_step_ms": wall_ms,
            "device_ms_a_step": busy_ms, "busy_share": busy_ms / wall_ms,
            "kernels_a_step": len(kernels) / steps, "planar_device_ms_a_step": planar_ms}


def bits_equal(a, b) -> bool:
    """Equal bits, outputs of any dtype (torch.equal holds -0.0 equal to 0.0)."""
    if a.dtype.is_floating_point:
        return a.dtype == b.dtype and torch.equal(a.view(torch.int16 if a.element_size() == 2 else torch.int32),
                                                  b.view(torch.int16 if b.element_size() == 2 else torch.int32))
    return torch.equal(a, b)


def main() -> int:
    if sys.argv[1:2] == ["codegen"]:
        print(json.dumps(codegen_seconds()))
        return 0
    if not torch.cuda.is_available():
        print("port_planar_probe: no CUDA device is available", file=sys.stderr)
        return 2

    modes = {"lanes": lambda dev, card: lane_sweep(dev, card),
             "autoreset": lambda dev, card: {"card": card, "paths": autoreset_turns(dev)},
             "terrain": terrain_probe}
    if sys.argv[1:2] and sys.argv[1] in modes:
        card = card_line()
        print(card, flush=True)
        result = modes[sys.argv[1]](torch.device("cuda"), card)
        if len(sys.argv) > 2:
            out = Path(sys.argv[2])
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(result, indent=1))
        print(json.dumps({k: v for k, v in result.items() if k != "rows"}))
        return 0

    from gymnasium_tpu_torch.envs.dynamics import lunar_lander as dyn
    from gymnasium_tpu_torch.ops import cartpole_rollout as cr

    rolled = dyn.lander_step(PLANAR_GRAVITY)
    unrolled = unrolled_step(rolled)
    planar = {("rolled", 32): rolled, ("unrolled", 32): unrolled}
    for block in BLOCKS[1:]:
        planar[("rolled", block)] = block_variant(rolled, block)
        planar[("unrolled", block)] = block_variant(unrolled, block)
    cartpole = {name: (f"cartpole_rollout_{name}", text)
                for name, text in cartpole_variants((build.SOURCE_DIR / "cartpole_rollout.cu").read_text()).items()}
    generated = {step.build_name: step.source.text for step in planar.values()}
    generated.update(dict(cartpole.values()))
    built = build.build(build.KERNELS, generated)

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    libraries = {}
    for name, text in [("cartpole_rollout", None), *generated.items()]:
        lib, info = build.library_path(name, text), built.get(name, {})
        count = sass_instructions(lib)
        libraries[name] = {"sass_instructions": count, "code_bytes": SASS_BYTES * count,
                           "loop_bodies": loop_bodies(sass_text(lib)), "nvcc_s": info.get("seconds"),
                           **ptxas_summary(info.get("log", ""))}
        print(f"{name}: {libraries[name]}", flush=True)

    # -- planar: the two forms, equal and in turns ---------------------------
    inputs = planar_states(NUM_ENVS, dev)
    want = rolled(*inputs)
    for (form, block), step in planar.items():
        got = step(*inputs)
        torch.cuda.synchronize()
        if not all(bits_equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"the planar kernel {form} at {block} threads a block differs from the shipped one")
    print(f"planar rolled and unrolled at 32, 64, 128 threads a block, N={NUM_ENVS}: bits equal", flush=True)
    planar_turns = []
    for block in BLOCKS:
        forms = {form: planar[(form, block)] for form in ("unrolled", "rolled")}
        times = {"unrolled": [], "rolled": []}
        for form in ("unrolled", "rolled", "rolled", "unrolled"):
            times[form].append(cuda_ms(lambda: forms[form](*inputs), 50, 5))
        device = {form: device_ms(lambda: step(*inputs), "step_kernel", 50) for form, step in forms.items()}
        planar_turns.append({"block": block, "n": NUM_ENVS, **{f"{k}_ms": v for k, v in times.items()},
                             **{f"{k}_device_ms": v for k, v in device.items()}})
        print(f"planar block {block} N={NUM_ENVS}: events unrolled {times['unrolled']} ms, rolled "
              f"{times['rolled']} ms (in turns: unrolled, rolled, rolled, unrolled); device unrolled "
              f"{device['unrolled']:.4f} ms, rolled {device['rolled']:.4f} ms", flush=True)
    planar_batches = []
    for block in BLOCKS:
        step = planar[("rolled", block)]
        for n in BATCHES:
            states = planar_states(n, dev)
            ms = cuda_ms(lambda: step(*states), 50, 5)
            planar_batches.append({"block": block, "n": n, "ms": ms, "env_calls_per_s": n / ms * 1e3})
            print(f"planar rolled block {block} N={n}: {ms:.4f} ms/call", flush=True)

    # -- CartPole: the shipped kernel and its variants, equal and in turns ----
    args = (
        torch.zeros((4, NUM_ENVS), device=dev),
        torch.zeros(NUM_ENVS, dtype=torch.int32, device=dev),
        torch.zeros(NUM_ENVS, dtype=torch.bool, device=dev),
    )
    shipped = {dt: cr.cartpole_rollout_fused(*args, 0, STEPS, obs_dtype=dt) for dt in (torch.float32, torch.bfloat16)}
    libs = {"shipped_b64": cr._library()}
    libs.update({name: cartpole_library(build_name, text) for name, (build_name, text) in cartpole.items()})
    cartpole_times = {(name, str(dt)): [] for name in libs for dt in shipped}
    cartpole_device = {}
    for name in (*libs, *reversed(libs)):
        with mock.patch.object(cr, "_library", lambda lib=libs[name]: lib):
            for dt, want in shipped.items():
                got = cr.cartpole_rollout_fused(*args, 0, STEPS, obs_dtype=dt)
                torch.cuda.synchronize()
                if not all(bits_equal(x, y) for x, y in zip(got, want)):
                    raise RuntimeError(f"the CartPole variant {name} differs from the shipped kernel ({dt})")
                rollout = lambda: cr.cartpole_rollout_fused(*args, 0, STEPS, obs_dtype=dt)  # noqa: E731
                cartpole_times[(name, str(dt))].append(cuda_ms(rollout, 20, 3))
                if (name, str(dt)) not in cartpole_device:
                    cartpole_device[(name, str(dt))] = device_ms(rollout, "cartpole_rollout_kernel", 20)
    cartpole_rows = [{"variant": name, "obs": dt, "ms": t, "device_ms": cartpole_device[(name, dt)]}
                     for (name, dt), t in cartpole_times.items()]
    for row in cartpole_rows:
        print(f"cartpole {row['variant']} obs={row['obs']} N={NUM_ENVS} S={STEPS}: events {row['ms']} ms/call "
              f"(in turns: {', '.join(libs)}, then back); device {row['device_ms']:.4f} ms", flush=True)

    # -- LunarLander vector env: each planar variant, in turns -----------------
    variants = {"rolled_b32": rolled, "rolled_b128": planar[("rolled", 128)],
                "unrolled_b128": planar[("unrolled", 128)]}
    lunar = {name: {"rates": []} for name in variants}
    for name in (*variants, *reversed(variants)):
        with mock.patch.object(dyn, "lander_step", lambda gravity, step=variants[name]: step):
            lunar[name]["rates"].append(run_lunar_lander(dev))
    for name, step in variants.items():
        with mock.patch.object(dyn, "lander_step", lambda gravity, step=step: step):
            lunar[name].update(profile_lunar_lander(dev, step.build_name))
        print(f"lunar_lander TorchVectorEnv with {name}: {lunar[name]}", flush=True)

    print(json.dumps({"card": card, "kind": torch.cuda.get_device_name(0), "libraries": libraries,
                      "planar_turns": planar_turns, "planar_batches": planar_batches,
                      "cartpole_variants": cartpole_rows, "lunar_lander": lunar}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
