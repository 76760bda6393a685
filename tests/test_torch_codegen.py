"""The shared backends of the port's generators (``ops/codegen.py``).

The articulated and planar generators emit C through the same symbolic
backend. The articulated sources are pinned by digest, so a change to the
shared backend cannot silently change, and rebuild, the HalfCheetah and Ant
kernels. The operations the planar solver added (``floor``, ``abs``, ``>=``,
a clip with per-env bounds) fold on constants as the others do, emit their C
forms, and compute in the twin what ``jnp`` computes.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu_torch.envs.mujoco.mujoco_env import load_model
from gymnasium_tpu_torch.ops.articulated_codegen import generate_source
from gymnasium_tpu_torch.ops.codegen import SymOps, TorchOps, _live, _statement

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
