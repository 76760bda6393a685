"""The shared backends of the port's generators (``ops/codegen.py``), and the
warp partition of the articulated substep (``ops/warp_partition.py``).

The articulated and planar generators emit C through the same symbolic
backend. The articulated sources are pinned by digest, so a change to the
shared backend cannot silently change, and rebuild, the HalfCheetah and Ant
kernels. The operations the planar solver added (``floor``, ``abs``, ``>=``,
a clip with per-env bounds) fold on constants as the others do, emit their C
forms, and compute in the twin what ``jnp`` computes. ``repeat`` is a Python
loop over torch tensors and one C loop, with its invariants hoisted, over
symbolic nodes; ``sincos`` is one ``sincosf``.
"""

import collections
import hashlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu_torch.envs.mujoco.mujoco_env import load_model
from gymnasium_tpu_torch.ops.articulated_codegen import (
    generate_source,
    model_tables,
    substep_program,
)
from gymnasium_tpu_torch.ops.codegen import SymOps, TorchOps, _live, _statement, emit, op_counts
from gymnasium_tpu_torch.ops.warp_partition import SHARED_BYTES_MAX, partition

# sha256 of the emitted text with one thread an env (parts=1), recorded
# before the backends moved out of ops/articulated_codegen.py
ARTICULATED_DIGESTS = {
    ("half_cheetah", 5): "1e02e1201d4d7c684aaa2eb37d8288f51206f31bb13ebd1a8c3b2c4e17efee05",
    ("ant", 1): "65d19f8ae8454a63bccbe3af3bb9e2f88e1a0aa4dc8b1f8288779739cf01f518",
}


@pytest.mark.parametrize("robot, frame_skip", sorted(ARTICULATED_DIGESTS))
def test_articulated_source_is_byte_identical(robot, frame_skip):
    model, _ = load_model(robot)
    text = generate_source(model, frame_skip, robot, parts=1).text
    assert hashlib.sha256(text.encode()).hexdigest() == ARTICULATED_DIGESTS[(robot, frame_skip)]


@pytest.mark.parametrize(
    "kind, args, want",
    [
        ("floor", (2.75,), np.float32(2.0)),
        ("floor", (-0.5,), np.float32(-1.0)),
        ("abs", (-3.5,), np.float32(3.5)),
        ("ge", (2.0, 2.0), np.bool_(True)),
        ("ge", (1.0, 2.0), np.bool_(False)),
    ],
)
def test_new_operations_fold_on_constants(kind, args, want):
    ops = SymOps()
    node = getattr(ops, kind)(*args) if kind != "ge" else ops.op("ge", *args)
    assert node.kind == "const" and node.value == want and type(node.value) is type(want)


def test_new_operations_emit_their_c_forms():
    ops = SymOps()
    x = ops.input("x", varying=True)
    lo, hi = ops.input("lo", varying=True), ops.input("hi", varying=True)
    outs = [ops.floor(x), ops.abs(x), x >= 1, ops.clip(x, lo, hi), ops.clip(x, -lo, lo)]
    text = "\n".join(_statement(n) for n in _live(outs))
    assert "floorf(x)" in text and "fabsf(x)" in text
    assert "const bool" in text and "x >= 1.0f" in text
    assert "fmaxf(x, lo)" in text and "fminf(" in text and "= -lo;" in text
    # the clip with node bounds is minimum(maximum(x, lo), hi), as jnp.clip is
    clip = outs[3]
    assert clip.kind == "min" and clip.args[0].kind == "max" and clip.args[1] is hi


def test_twin_operations_match_jnp():
    rng = np.random.default_rng(0)
    x = rng.uniform(-30, 30, 257).astype(np.float32)
    mu = rng.uniform(0, 1, 257).astype(np.float32)
    na = rng.uniform(0, 5, 257).astype(np.float32)
    ops = TorchOps("cpu")
    tx, tmu, tna = (torch.from_numpy(v) for v in (x, mu, na))
    jx, jmu, jna = (jnp.asarray(v) for v in (x, mu, na))
    np.testing.assert_array_equal(ops.floor(tx).numpy(), np.asarray(jnp.floor(jx)))
    np.testing.assert_array_equal(ops.abs(tx).numpy(), np.asarray(jnp.abs(jx)))
    np.testing.assert_array_equal((tx >= 1).numpy(), np.asarray(jx >= 1))
    # the friction clamp: bounds that are per-env values
    got = ops.clip(tx, -tmu * tna, tmu * tna).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.clip(jx, -jmu * jna, jmu * jna)))
    # and python-float bounds, as before
    np.testing.assert_array_equal(ops.clip(tx, -0.5, 0.5).numpy(), np.asarray(jnp.clip(jx, -0.5, 0.5)))


def _iteration(ops, k):
    """A loop body: ``k`` (an input) is invariant, ``a`` and ``b`` are carried."""

    def body(carried):
        a, b = carried
        scale = ops.sqrt(k * k + 1.0)  # depends on no carried value
        a2 = ops.maximum(a * scale - b, 0.0)
        return [a2, b + a2 / scale]

    return body


def test_repeat_over_torch_ops_is_a_python_loop():
    rng = np.random.default_rng(1)
    a, b, k = (torch.from_numpy(rng.uniform(-2, 2, 65).astype(np.float32)) for _ in range(3))
    ops = TorchOps("cpu")
    got = ops.repeat(5, [a, b], _iteration(ops, k))
    want = [a, b]
    for _ in range(5):
        want = _iteration(ops, k)(want)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.repeat(0, [a, b], _iteration(ops, k)) == [a, b]


def test_repeat_over_sym_ops_emits_one_loop_with_its_invariants_hoisted():
    ops = SymOps()
    k = ops.input("k", varying=False)
    a, b = ops.input("a", varying=True), ops.input("b", varying=True)
    outs = ops.repeat(5, [a, b], _iteration(ops, k))
    live = _live(outs)
    lines = [line.strip() for line in emit([n for n in live if n.scope is None], live, "", "UNROLL_1")]
    loop = lines.index("for (int it = 0; it < 5; ++it) {")
    assert lines.count("for (int it = 0; it < 5; ++it) {") == 1 and lines[loop - 1] == "UNROLL_1"
    # the invariant sqrt(k * k + 1) comes before the loop, the carried work inside it
    sqrt = next(i for i, line in enumerate(lines) if "sqrtf(" in line)
    body = lines[loop + 1 : lines.index("}", loop)]
    assert sqrt < loop and any("fmaxf(" in line for line in body) and not any("sqrtf(" in line for line in body)
    # carried variables start from the inputs and take the new values at the end of a pass
    assert [line for line in lines[:loop] if line.startswith("float c")] == [
        f"float {_ref_name(outs[0])} = a;", f"float {_ref_name(outs[1])} = b;"]
    assert body[-1] == f"{_ref_name(outs[1])} = n{_ref_name(outs[1])};"
    # operations run: the invariant three once, the body's four five times
    assert op_counts(live) == {"mul": 1 + 5, "add": 1 + 5, "sqrt": 1, "sub": 5, "max": 5, "div": 5}
    # the unrolled trace shares the invariant nodes too, so it runs as many
    plain = SymOps()
    pk = plain.input("k", varying=False)
    carried = [plain.input("a", varying=True), plain.input("b", varying=True)]
    for _ in range(5):
        carried = _iteration(plain, pk)(carried)
    assert op_counts(_live(carried)) == op_counts(live)


def _ref_name(loopout):
    return f"c{loopout.args[0].value.carries[loopout.value].id}"


def test_repeat_of_zero_or_one_pass_emits_no_loop():
    ops = SymOps()
    k, a, b = (ops.input(name, varying=True) for name in "kab")
    assert ops.repeat(0, [a, b], _iteration(ops, k)) == [a, b]
    once = ops.repeat(1, [a, b], _iteration(ops, k))
    assert all(n.kind != "loop" for n in _live(once))


def test_a_value_may_leave_a_repeat_body_only_through_its_result():
    ops = SymOps()
    a = ops.input("a", varying=True)
    leaked = []

    def body(carried):
        leaked.append(carried[0])
        leaked.append(carried[0] * 2.0)
        return [carried[0] + 1.0]

    ops.repeat(3, [a], body)
    with pytest.raises(ValueError, match="repeat body"):
        leaked[1] + a
    # the same expression again after the loop finds the body's node in the memo
    with pytest.raises(ValueError, match="repeat body"):
        leaked[0] * 2.0
    with pytest.raises(ValueError, match="one value of each carried type"):
        ops.repeat(3, [a], lambda carried: [carried[0] > 0.0])


def test_sincos_is_one_call_and_the_twin_is_sin_and_cos():
    ops = SymOps()
    x = ops.input("x", varying=True)
    s, c = ops.sincos(x)
    assert ops.sincos(x) == (s, c)  # shared, as equal nodes are
    live = _live([s * c])
    text = "\n".join(emit(live, live, "", "UNROLL_1"))
    assert text.count("sincosf(x, &") == 1 and "sinf(" not in text and " cosf(" not in text
    assert op_counts(live) == {"sin": 1, "cos": 1, "mul": 1}
    v = torch.from_numpy(np.random.default_rng(2).uniform(-40, 40, 129).astype(np.float32))
    ts, tc = TorchOps("cpu").sincos(v)
    assert torch.equal(ts, torch.sin(v)) and torch.equal(tc, torch.cos(v))


# ---------------------------------------------------------------------------
# The warp partition of the articulated substep (ops/warp_partition.py)


def _substep_body(robot):
    """The tables, live body nodes and outputs of one substep."""
    t = model_tables(load_model(robot)[0])
    _, body, outputs = substep_program(t)
    return t, body, outputs


def _run_phases(body, outputs, wp):
    """Walk every partition phase by phase as the warps would, with the group's
    slots as one table: each operand a partition reads must be its own (computed
    or loaded before), each load must find its value in its slot, written in an
    earlier phase, and no slot is written in a phase in which it is read."""
    body_ids = {n.id for n in body}
    held = [set() for _ in range(wp.parts)]
    slots = {}  # slot -> (node id, phase written)
    for k in range(wp.phases):
        read = {s for p in range(wp.parts) for _, s in wp.loads[k][p]}
        written = [s for p in range(wp.parts) for _, s in wp.stores[k][p]]
        assert not read & set(written), f"phase {k} reads and writes one slot"
        assert len(written) == len(set(written)), f"two partitions write one slot in phase {k}"
        for p in range(wp.parts):
            for n, s in wp.loads[k][p]:
                assert wp.owner[n.id] != p and s >= wp.carried
                assert slots.get(s, (None,))[0] == n.id and slots[s][1] < k, f"t{n.id} is not in slot {s}"
                held[p].add(n.id)
            for n in wp.blocks[k][p]:
                missing = [a.id for a in n.args if a.id in body_ids and a.id not in held[p]]
                assert not missing, f"partition {p} reads {missing} in phase {k} before it has them"
                held[p].add(n.id)
        for p in range(wp.parts):
            for n, s in wp.stores[k][p]:
                assert wp.owner[n.id] == p and n.id in held[p]
                slots[s] = (n.id, k)
    for o in outputs:  # each new q, qd is held by the partition that stores it
        assert o.id not in body_ids or o.id in held[wp.owner[o.id]]


# HalfCheetah's and Ant's shipped layouts (4 and 8 warps) among them
PARTITION_CASES = [("half_cheetah", 2), ("half_cheetah", 4), ("ant", 2),
                   ("ant", 8), ("hopper", 2), ("hopper", 4), ("reacher", 2), ("reacher", 4)]


@pytest.mark.parametrize("robot, parts", PARTITION_CASES)
def test_warp_partition_places_every_node_once_and_reads_only_earlier_phases(robot, parts):
    t, body, outputs = _substep_body(robot)
    wp = partition(body, parts, t.nq + t.nv)
    assert wp.parts == parts and wp.phases >= 2
    # every live node has one owner and is computed there once; any other
    # partition computes it only as a listed recomputation of a cheap node
    assert set(wp.owner) == {n.id for n in body} and set(wp.owner.values()) == set(range(parts))
    places = collections.Counter((n.id, p) for phase in wp.blocks for p, block in enumerate(phase) for n in block)
    assert all(c == 1 for c in places.values())
    again = {(n.id, p) for n, p, _ in wp.recomputed}
    assert set(places) == {(i, p) for i, p in wp.owner.items()} | again
    assert all(p != wp.owner[n.id] and n.kind in ("add", "sub", "mul", "neg", "max", "min", "gt", "lt", "ge", "or",
                                                 "select") for n, p, _ in wp.recomputed)
    _run_phases(body, outputs, wp)
    # the operations computed once are the one-thread program's, kind by kind
    model, _ = load_model(robot)
    once = collections.Counter(n.kind for n in body)
    assert once == collections.Counter(generate_source(model, 1, robot, parts=1).substep_ops)
    assert sum(collections.Counter(n.kind for n, _, _ in wp.recomputed).values()) == len(wp.recomputed)
    assert wp.exchanged == len({n.id for phase in wp.stores for s in phase for n, _ in s})


#: The layout each robot's kernel ships with, ``(warps a group, groups a
#: block)``: the fastest the probe's sweeps measured on an H100 at 4096 envs
#: (PERF.md: HalfCheetah 4 x 2 and Ant 8 x 1 as before, Humanoid and
#: HumanoidStandup 8 x 1 in place of 4 x 1).
SHIPPED_LAYOUTS = {"ant": (8, 1), "half_cheetah": (4, 2), "humanoid": (8, 1), "humanoidstandup": (8, 1)}


@pytest.mark.parametrize("robot", sorted(SHIPPED_LAYOUTS))
def test_shipped_layout_fits_the_shared_memory_of_a_block(robot):
    """The layout model picks the layout measured fastest, and it fits a block."""
    model, _ = load_model(robot)
    src = generate_source(model, 5, robot)
    layout = src.layout
    assert (layout["parts"], layout["env_groups"]) == SHIPPED_LAYOUTS[robot]
    assert 0 < layout["shared_bytes_per_block"] <= SHARED_BYTES_MAX
    assert layout["shared_bytes_per_block"] == 4 * 32 * layout["env_groups"] * int(
        src.text.split("kSlots = ")[1].split(";")[0])


def test_a_layout_over_the_shared_memory_of_a_block_raises():
    model, _ = load_model("ant")
    with pytest.raises(ValueError, match="shared memory"):
        generate_source(model, 5, "ant", parts=8, groups=2)
    with pytest.raises(ValueError, match="do not fit a block"):
        generate_source(model, 5, "ant", parts=8, groups=5)


def test_partitioned_text_guards_every_block_and_fuses_sine_and_cosine():
    model, _ = load_model("half_cheetah")
    src = generate_source(model, 5, "half_cheetah", parts=4, groups=1)
    text = src.text
    assert "ART_PARTS_ENTRY_POINTS(ArticulatedStep)" in text and "ART_ENTRY_POINTS(" not in text
    assert "template <int kPart, typename X>" in text and "static constexpr int kParts = 4;" in text
    loop = text.split("for (int s = 0; s < 5; ++s) {")[1]
    assert loop.count("x.sync();") == src.layout["phases"]
    # one sincosf an angle, out of line: HalfCheetah's seven hinges
    assert loop.count("art::sin_cos(") == 7 and not re.search(r"\b(sinf|cosf|sincosf)\(", loop)
    # the one-thread text is untouched by the layout
    assert "x.sync()" not in generate_source(model, 5, "half_cheetah", parts=1).text
