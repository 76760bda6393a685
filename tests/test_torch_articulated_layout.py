"""The articulated kernel's layouts, on the CPU.

The generator picks each robot's layout by the layout model
(``articulated_codegen.choose_layout``): one thread an env, or ``G`` warps
a group of 32 envs with ``B`` groups a block. The host form of a layout's
text (``art::parts_host``) runs its partitions phase by phase, so ``g++``
proves the schedule before any card sees it: it must give the one-thread
build's bits on every lane. The schedule is walked phase by phase, each
robot's pick is held to the layout measured fastest on the card, and the
texts of the layouts the card has run stay byte for byte.
"""

import collections
import ctypes
import hashlib
import shutil
import subprocess

import numpy as np
import pytest

from chip_smoke import articulated_states
from gymnasium_tpu_torch.envs.mujoco.mujoco_env import load_model
from gymnasium_tpu_torch.ops.articulated_codegen import generate_source, model_tables, substep_program
from gymnasium_tpu_torch.ops.build import SOURCE_DIR
from gymnasium_tpu_torch.ops.warp_partition import SHARED_BYTES_MAX, partition

CHEAP = {"add", "sub", "mul", "neg", "max", "min", "gt", "lt", "ge", "or", "select"}
# sha256 (first 16 hex digits) of texts the card has run: HalfCheetah's and
# Ant's layouts, and Humanoid's earlier 4 warps in one group
TEXT_DIGESTS = {
    ("half_cheetah", 4, 2): "f907adf40beb4a68",
    ("ant", 8, 1): "26d03c39cc3c6987",
    ("humanoid", 4, 1): "5eef47aa542c1480",
}


def _compile(tmp_path, tag, text):
    """Start ``g++`` on ``text``; returns ``(process, library path)``. At
    ``-O0``: a Humanoid text compiles in seconds, not 15-20 s at ``-O1``,
    and the arithmetic is the same IEEE single precision (no contraction,
    no builtins), so the bits are too."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs a host g++")
    src, lib = tmp_path / f"{tag}.cpp", tmp_path / f"lib{tag}.so"
    src.write_text(text)
    cmd = [gxx, "-O0", "-ffp-contract=off", "-fno-builtin", "-shared", "-fPIC", "-I", str(SOURCE_DIR),
           "-x", "c++", "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib


def _host_steps(tmp_path, texts):
    """Every text built with ``g++`` at once: ``{tag: step(q, qd, ctrl)}``."""
    jobs = {tag: _compile(tmp_path, tag, text) for tag, text in texts.items()}
    steps = {}
    for tag, (proc, lib) in jobs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, out.decode()
        fn = ctypes.CDLL(str(lib)).articulated_step_host
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int]

        def step(q, qd, ctrl, fn=fn):
            cq, cqd = np.empty_like(q), np.empty_like(qd)
            fn(q.ctypes.data, qd.ctypes.data, ctrl.ctypes.data, cq.ctypes.data, cqd.ctypes.data, len(q))
            return cq, cqd

        steps[tag] = step
    return steps


def _states(model, n, seed):
    return tuple(x.numpy() for x in articulated_states(model, n, "cpu", seed=seed))


def _same_bits(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("robot, frame_skip, parts, groups", [("half_cheetah", 5, 16, 2), ("half_cheetah", 5, 4, 3),
                                                              ("walker2d_v5", 4, 8, 2), ("pusher_v5", 5, 4, 2)])
def test_layout_gives_the_one_thread_bits_on_host(tmp_path, robot, frame_skip, parts, groups):
    """Layouts the rule weighs, built with ``g++`` beside the one-thread
    text: the same bits on every lane."""
    model, _ = load_model(robot)
    steps = _host_steps(tmp_path, {
        "one": generate_source(model, frame_skip, robot, parts=1).text,
        "parts": generate_source(model, frame_skip, robot, parts, groups).text,
    })
    q, qd, ctrl = _states(model, 96, seed=7)
    _same_bits(steps["parts"](q, qd, ctrl), steps["one"](q, qd, ctrl))


@pytest.fixture(scope="module")
def humanoid_chosen():
    """Humanoid's source in the layout its kernel ships with (the layout
    model's choice), made once for the file."""
    return generate_source(load_model("humanoid")[0], 5, "humanoid")


def test_humanoid_chosen_layout_gives_the_one_thread_bits_on_host(tmp_path, humanoid_chosen):
    """The chosen layout built with ``g++`` beside the one-thread text:
    equal in every bit, the small-angle lanes of the free root among them."""
    model, _ = load_model("humanoid")
    chosen = humanoid_chosen
    assert chosen.layout["parts"] > 1
    steps = _host_steps(tmp_path, {"one": generate_source(model, 5, "humanoid", parts=1).text,
                                   "chosen": chosen.text})
    q, qd, ctrl = _states(model, 64, seed=9)
    _same_bits(steps["chosen"](q, qd, ctrl), steps["one"](q, qd, ctrl))


@pytest.mark.parametrize("robot, parts, groups", sorted(TEXT_DIGESTS))
def test_layout_text_is_unchanged_byte_for_byte(robot, parts, groups):
    model, _ = load_model(robot)
    text = generate_source(model, 5, robot, parts, groups).text
    assert hashlib.sha256(text.encode()).hexdigest()[:16] == TEXT_DIGESTS[(robot, parts, groups)]


def _walk(body, outputs, wp):
    """Walk the partitions phase by phase as the group's warps do: a
    partition reads only what it computed or loaded before; every load
    finds its value in its slot, stored in an earlier phase; no slot is
    read and written in one phase, nor written twice in one."""
    body_ids = {n.id for n in body}
    held = [set() for _ in range(wp.parts)]
    slots = {}  # slot -> (node id, phase written)
    for k in range(wp.phases):
        reads, writes = collections.Counter(), collections.Counter()
        for p in range(wp.parts):
            for n, s in wp.loads[k][p]:
                assert slots.get(s, (None,))[0] == n.id and slots[s][1] < k, f"t{n.id} not in slot {s}"
                assert s >= wp.carried
                reads[s] += 1
                held[p].add(n.id)
            for n in wp.blocks[k][p]:
                missing = [a.id for a in n.args if a.id in body_ids and a.id not in held[p]]
                assert not missing, f"partition {p} reads {missing} in phase {k} before it has them"
                held[p].add(n.id)
        for p in range(wp.parts):
            for n, s in wp.stores[k][p]:
                assert wp.owner[n.id] == p and n.id in held[p]
                writes[s] += 1
                slots[s] = (n.id, k)
        assert not set(reads) & set(writes), f"phase {k} reads and writes one slot"
        assert all(c == 1 for c in writes.values()), f"two stores into one slot in phase {k}"
    for o in outputs:
        assert o.id not in body_ids or o.id in held[wp.owner[o.id]]


@pytest.mark.parametrize("robot, parts", [("half_cheetah", 8), ("half_cheetah", 16), ("ant", 4), ("ant", 16),
                                          ("pusher_v5", 4)])
def test_schedule_invariants(robot, parts):
    t = model_tables(load_model(robot)[0])
    _, body, outputs = substep_program(t)
    wp = partition(body, parts, t.nq + t.nv)
    # every node is placed once, and elsewhere only as a listed recomputation of a cheap node
    assert set(wp.owner) == {n.id for n in body}
    places = collections.Counter((n.id, p) for phase in wp.blocks for p, block in enumerate(phase) for n in block)
    assert all(c == 1 for c in places.values())
    assert set(places) == set(wp.owner.items()) | {(n.id, p) for n, p, _ in wp.recomputed}
    assert all(p != wp.owner[n.id] and n.kind in CHEAP for n, p, _ in wp.recomputed)
    # the operations computed once are the one-thread program's, kind by kind
    assert collections.Counter(n.kind for n in body) == collections.Counter(
        generate_source(load_model(robot)[0], 1, robot, parts=1).substep_ops)
    _walk(body, outputs, wp)
    # the slots of the most groups a block that fit stay within a block's shared memory
    groups = max(b for b in range(1, 16) if parts * b <= 32 and wp.shared_bytes(b) <= SHARED_BYTES_MAX)
    assert 4 * 32 * wp.slots * groups <= SHARED_BYTES_MAX


def test_humanoid_chosen_schedule_invariants(humanoid_chosen):
    """The Humanoid layout the rule picks, walked phase by phase."""
    model, _ = load_model("humanoid")
    layout = humanoid_chosen.layout
    t = model_tables(model)
    _, body, outputs = substep_program(t)
    wp = partition(body, layout["parts"], t.nq + t.nv)
    _walk(body, outputs, wp)
    assert 4 * 32 * wp.slots * layout["env_groups"] == layout["shared_bytes_per_block"] <= SHARED_BYTES_MAX


#: The layout each robot's kernel ships with, ``(warps a group, groups a
#: block)``, by robot and ``frame_skip``: the fastest the probe's sweeps
#: measured on an H100 at 4096 envs (PERF.md), where the card tells them
#: apart. Hopper's 8 x 2 and 4 x 2 ran within 1 % of each other, and so did
#: Pusher's 4 x 2 and 8 x 2. ``(1, 4)`` is one thread an env.
FASTEST_MEASURED = {
    ("hopper", 4): (8, 2),
    ("walker2d_v5", 4): (4, 2),
    ("walker2d", 4): (4, 2),
    ("inverted_pendulum", 2): (1, 4),
    ("inverted_double_pendulum", 5): (1, 4),
    ("reacher", 2): (1, 4),
    ("pusher_v5", 5): (4, 2),
    ("pusher", 5): (4, 2),
    ("swimmer", 1): (1, 4),
}


@pytest.mark.parametrize("robot, frame_skip", sorted(FASTEST_MEASURED))
def test_rule_picks_the_layout_measured_fastest(robot, frame_skip):
    layout = generate_source(load_model(robot)[0], frame_skip, robot).layout
    assert (layout["parts"], layout["env_groups"]) == FASTEST_MEASURED[(robot, frame_skip)]
    if layout["parts"] > 1:
        assert layout["shared_bytes_per_block"] <= SHARED_BYTES_MAX


def test_layout_choice_is_kept_and_read_back(tmp_path, monkeypatch):
    """The rule's choice is kept on disk, and a later generation reads it
    instead of choosing again: the same layout, estimates and text. Another
    ``frame_skip`` is another key, and chooses."""
    from gymnasium_tpu_torch.ops import articulated_codegen as codegen

    monkeypatch.setattr(codegen, "CHOICE_DIR", tmp_path)
    model, _ = load_model("hopper")
    first = generate_source(model, 4, "hopper")
    assert len(list(tmp_path.glob("*.json"))) == 1

    def no_choice(*args):
        raise AssertionError("chose again")

    monkeypatch.setattr(codegen, "choose_layout", no_choice)
    again = generate_source(model, 4, "hopper")
    assert (again.text, again.layout) == (first.text, first.layout)
    with pytest.raises(AssertionError, match="chose again"):
        generate_source(model, 3, "hopper")
