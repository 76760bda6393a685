"""The planar kernel laid over a group of lanes, one env a group, on the CPU.

``ops/planar_codegen.py::generate_planar_source`` emits an env's solver ticks
over ``G`` lanes of a warp (``_LaneEmitter``): body ``b`` and its contact
probes on lane ``b``, each joint on a lane of one of its bodies, phases of
units of one shape, values read across lanes by shuffles. Under a plain C++
compiler the same text runs the lanes in lockstep, statement by statement
(``csrc/planar_step.cuh``'s ``PL_`` macros), so a ``g++`` build shows that
the schedule is a valid reordering of the one-thread program:

- the host build at each lane count equals the one-lane host build in every
  bit, on the walker's and the lander's inputs and on a ragged batch;
- it equals the plain twin run with the host's own ``sincosf`` (glibc, as
  the host build calls it) in every bit of the bodies, joint impulses and
  flags; the contact impulses equal it in value, zeros' signs aside (torch's
  CPU clamp and glibc's ``fmaxf`` may return zeros of opposite sign, which C
  leaves open; on the card ``chip_smoke.py`` holds every bit);
- the schedule places every statement, reads a value of another lane only
  after the phase that made it, and keeps each body's Gauss-Seidel order;
- the generator picks its lane count from the world, refuses one that does
  not give each body a lane, and counts the same operations in every layout.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import planar_states, walker_states
from gymnasium_tpu_torch.envs.box2d import bipedal_walker as walker
from gymnasium_tpu_torch.envs.dynamics import lunar_lander as dyn
from gymnasium_tpu_torch.ops.codegen import TorchOps
from gymnasium_tpu_torch.ops.planar_codegen import (
    LANE_CHOICES,
    _LaneEmitter,
    _trace,
    generate_planar_source,
    lane_map,
    run_twin,
)
from tests.test_torch_planar import _host_run

WALKER_LANES = (8, 16)
LANDER_LANES = (4, 8, 16)
RAGGED = 37  # fills no warp's groups at 8 or 16 lanes an env


def _steps():
    return {"walker": walker.walker_solver(), "lander": dyn.lander_step(-10.0)}


def _inputs(world: str, n: int):
    """Numpy inputs ``(bodies, external, terrain, jimp, cimp, motor_speed,
    motor_torque)``, None for a part the world lacks."""
    if world == "walker":
        xs = walker_states(n, "cpu", seed=2)
    else:
        xs = (*planar_states(n, "cpu", seed=1), None, None)
    return [None if x is None else x.numpy() for x in xs]


@pytest.fixture(scope="module")
def host_sincos(tmp_path_factory):
    """glibc's ``sincosf`` over a float32 array, built with the host ``g++``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs a host g++")
    tmp = tmp_path_factory.mktemp("sincos")
    src, lib = tmp / "sincos.cpp", tmp / "libsincos.so"
    src.write_text('#include <math.h>\nextern "C" void sincos_rows(const float* x, float* s, float* c, int n) '
                   "{ for (int i = 0; i < n; ++i) sincosf(x[i], s + i, c + i); }\n")
    subprocess.run([gxx, "-O1", "-fno-builtin", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).sincos_rows
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    return fn


class _HostTrigOps(TorchOps):
    """The twin's ops with each sine and cosine from glibc's ``sincosf``."""

    def __init__(self, fn):
        super().__init__("cpu")
        self.fn = fn

    def sincos(self, x):
        a = np.ascontiguousarray(self._tensor(x).numpy(), np.float32)
        s, c = np.empty_like(a), np.empty_like(a)
        self.fn(a.ctypes.data, s.ctypes.data, c.ctypes.data, a.size)
        return torch.from_numpy(s), torch.from_numpy(c)


def _host_twin(step, ins, fn):
    t = step.tables
    ops = _HostTrigOps(fn)
    bodies, ext, terrain, jimp, cimp, ms, mt = (None if x is None else torch.from_numpy(x) for x in ins)
    ground = t.terrain.ground(ops, t.terrain.rows(terrain))
    return [None if x is None else x.numpy() for x in run_twin(t, ops, ground, bodies, ext, jimp, cimp, ms, mt)]


def _host(tmp_path, step, lanes, ins):
    text = generate_planar_source(*step._args, step.name, lanes=lanes).text
    return _host_run(tmp_path, text, ins[:5], motors=tuple(ins[5:]))


@pytest.fixture(scope="module")
def references(tmp_path_factory, host_sincos):
    """``(world, n) -> (one-lane host build's outputs, host-trig twin's)``, made once."""
    cache = {}

    def get(world, n):
        if (world, n) not in cache:
            step, ins = _steps()[world], _inputs(world, n)
            cache[(world, n)] = (_host(tmp_path_factory.mktemp("one"), step, 1, ins),
                                 _host_twin(step, ins, host_sincos))
        return cache[(world, n)]

    return get


CASES = [("walker", g) for g in WALKER_LANES] + [("lander", g) for g in LANDER_LANES]


@pytest.mark.parametrize("n", [32, RAGGED])
@pytest.mark.parametrize("world,lanes", CASES)
def test_lane_host_build_equals_one_lane_build_and_twin(tmp_path, references, world, lanes, n):
    step = _steps()[world]
    got = _host(tmp_path, step, lanes, _inputs(world, n))
    one, twin = references(world, n)
    for label, a, b in zip(("bodies", "jimp", "cimp", "flags"), got, one):
        assert (a is None) == (b is None)
        assert a is None or a.tobytes() == b.tobytes(), f"{label}: {lanes} lanes differ from one lane"
    for label, a, b in zip(("bodies", "jimp", "flags"), (got[0], got[1], got[3]), (twin[0], twin[1], twin[3])):
        assert (a is None) == (b is None)
        assert a is None or a.tobytes() == b.tobytes(), f"{label}: the lane build differs from the twin"
    np.testing.assert_array_equal(got[2], twin[2], err_msg="cimp differs from the twin")


@pytest.mark.parametrize("world,lanes", CASES)
def test_lane_schedule_places_every_node_and_reads_only_earlier_phases(world, lanes):
    step = _steps()[world]
    t = step.tables
    prog = _trace(t)
    emitter = _LaneEmitter(prog, lanes, lane_map(t))
    emitter.run_lines("")
    made = {}  # node id -> the phase its own unit made it in
    available = {n.id for n in prog.ops.nodes if n.kind in ("const", "input")}
    available |= {n.id for n in prog.live if not n.varying}
    phases = [e for e in emitter.trace if e[0] == "phase"]
    for event in emitter.trace:
        if event[0] != "phase":
            available |= {n.id for n in event[1]}
            continue
        lanes_of_phase = event[2]
        k = phases.index(event)
        made_now = set()
        for lane, (unit, nodes) in lanes_of_phase.items():
            assert emitter.lane_of[unit[0]] == lane
            mine = set()
            for n in nodes:
                for a in n.args:
                    a_id = a.args[0].id if a.kind == "part" else a.id
                    # a unit's own earlier value, or one that an earlier phase made
                    assert a_id in mine or a_id in available, f"t{n.id} on lane {lane} reads t{a_id} too early"
                mine.add(n.id)
                if n.unit == unit:
                    assert n.id not in made, f"t{n.id} made twice by its own unit"
                    made[n.id] = k
            made_now |= mine
        available |= made_now
    assert set(made) == {n.id for n in prog.live if n.varying and n.kind != "loop"}
    # each body's state is updated as the twin updates it: every update is
    # ``v = v + term`` (or ``-``), so walking back along first operands from
    # each value a loop or the tick hands on gives the chain of one field's
    # updates; along it, the units come in the order the program opened
    # them, and their phases never go back
    opened = {u: i for i, u in enumerate(prog.ops.requests)}
    ends = list(prog.outputs)
    for n in prog.live:
        if n.kind == "loop":
            ends += list(n.args)
    chains = 0
    for end in ends:
        chain = []
        while end.kind in ("add", "sub") and end.varying:
            chain.append(end)
            end = end.args[0]
        chain.reverse()
        units = [n.unit for n in chain]
        assert [opened[u] for u in units] == sorted(opened[u] for u in units)
        assert [made[n.id] for n in chain] == sorted(made[n.id] for n in chain)
        chains += len(chain) > 1
    assert chains > t.nbody


def test_generator_chooses_lanes_from_the_world():
    steps = _steps()
    walker_layout, lander_layout = steps["walker"].source.layout, steps["lander"].source.layout
    # a lane a body: the walker's five bodies fit 8 or 16 lanes, the lander's three 4, 8 or 16
    assert sorted(walker_layout["estimates"]) == [1, 8, 16]
    assert sorted(lander_layout["estimates"]) == [1, 4, 8, 16]
    for layout in (walker_layout, lander_layout):
        best = min(layout["estimates"], key=lambda g: (layout["estimates"][g], g))
        assert layout["lanes"] == best and best in LANE_CHOICES
    for lanes in (2, 4):
        with pytest.raises(ValueError, match="do not fit"):
            generate_planar_source(*steps["walker"]._args, "x", lanes=lanes)


@pytest.mark.parametrize("world", ["walker", "lander"])
def test_every_layout_counts_the_same_operations(world):
    step = _steps()[world]
    sources = {g: generate_planar_source(*step._args, "x", lanes=g) for g in step.source.layout["estimates"]}
    for source in sources.values():
        assert source.prologue_ops == sources[1].prologue_ops and source.substep_ops == sources[1].substep_ops
    many = sources[max(sources)]
    assert "static constexpr int kLanes = 16;" in many.text and "kLanes" not in sources[1].text
    assert many.text.count("PL_SINCOS(") < sources[1].text.count("sincosf(")


def test_only_a_group_stages_a_heightfield_row():
    steps = _steps()
    walker_args, lander_args = steps["walker"]._args, steps["lander"]._args
    assert steps["walker"].source.layout["stage_terrain"] and "kStageTerrain = true;" in steps["walker"].source.text
    assert not steps["lander"].source.layout["stage_terrain"] and "kStageTerrain" not in steps["lander"].source.text
    one = generate_planar_source(*walker_args, "x", lanes=1)
    assert not one.layout["stage_terrain"] and "kStageTerrain" not in one.text
    assert "kStageTerrain" not in generate_planar_source(*walker_args, "x", lanes=8, stage_terrain=False).text
    for args, lanes in ((walker_args, 1), (lander_args, 4)):
        with pytest.raises(ValueError, match="stages a row"):
            generate_planar_source(*args, "x", lanes=lanes, stage_terrain=True)
