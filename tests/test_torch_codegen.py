"""The shared backends of the port's generators (``ops/codegen.py``).

The articulated and planar generators emit C through the same symbolic
backend. The articulated sources are pinned by digest, so a change to the
shared backend cannot silently change, and rebuild, the HalfCheetah and Ant
kernels. The operations the planar solver added (``floor``, ``abs``, ``>=``,
a clip with per-env bounds) fold on constants as the others do, emit their C
forms, and compute in the twin what ``jnp`` computes. ``repeat`` is a Python
loop over torch tensors and one C loop, with its invariants hoisted, over
symbolic nodes; ``sincos`` is one ``sincosf``.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu_torch.envs.mujoco.mujoco_env import load_model
from gymnasium_tpu_torch.ops.articulated_codegen import generate_source
from gymnasium_tpu_torch.ops.codegen import SymOps, TorchOps, _live, _statement, emit, op_counts

# sha256 of the emitted text, recorded before the backends moved out of
# ops/articulated_codegen.py
ARTICULATED_DIGESTS = {
    ("half_cheetah", 5): "1e02e1201d4d7c684aaa2eb37d8288f51206f31bb13ebd1a8c3b2c4e17efee05",
    ("ant", 1): "65d19f8ae8454a63bccbe3af3bb9e2f88e1a0aa4dc8b1f8288779739cf01f518",
}


@pytest.mark.parametrize("robot, frame_skip", sorted(ARTICULATED_DIGESTS))
def test_articulated_source_is_byte_identical(robot, frame_skip):
    model, _ = load_model(robot)
    text = generate_source(model, frame_skip, robot).text
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
