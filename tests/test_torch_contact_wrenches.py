"""The contact-wrench kernel of the port: its emitted source, its twin, its
wrapper, and the articulated sources it must leave as they were.

``ops/articulated_codegen.py::wrench_program`` is the forward kinematics and
the substep's own contact forces (``contact_force``), summed into each
body's ``[torque, force]`` about its com. Over torch tensors it is the plain
twin that ``ops/contact_wrenches.py`` runs on a CPU tensor; emitted as C it
is the kernel, whose ``run`` is ``__host__ __device__``, so the same text
built with the host ``g++`` is held here against the twin before any card
sees it. The text calls ``sincosf``, whose glibc bits differ from torch's
CPU ``sin``/``cos`` by an ULP, and ``sqrtf``, which rounds to the nearest
float where torch's CPU ``sqrt`` may not: so the build equals the twin
within a same-program tolerance scaled to the wrenches' size, and in every
bit the twin run with glibc's ``sincosf`` and a correctly rounded square
root (``_HostMathOps``).
On the card the kernel equals the plain twin in every bit
(``tests/test_torch_contact_wrenches_gpu.py``, ``chip_smoke.py``).

States are ``tests/test_torch_mujoco_kinematics.py::states``: perturbed
poses and velocities, every other lane lowered into the ground, so contacts
act in at least a quarter of the lanes.
"""

import ctypes
import hashlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gymnasium_tpu_torch.envs.mujoco.mujoco_env import load_model
from gymnasium_tpu_torch.ops import contact_wrenches as cw
from gymnasium_tpu_torch.ops.articulated_codegen import (
    generate_source,
    generate_wrench_source,
    model_tables,
    wrench_program,
)
from gymnasium_tpu_torch.ops.build import SOURCE_DIR
from gymnasium_tpu_torch.ops.codegen import TorchOps
from gymnasium_tpu_torch.physics import articulated as art

N = 256
# robot: (qpos index of the root's height, how far every other lane is lowered)
ROBOTS = {"ant": (2, 0.3), "humanoid": (2, 0.9), "humanoidstandup": (2, 0.3)}
# the twin against the g++ build: only sin/cos/sqrt ULPs differ, which the
# stiff contact springs amplify (largest seen: 1.4e-7 of the largest |wrench|)
REL = 1e-5

# sha256 of each model's articulated source before the contact section was
# shared with the wrench program: one thread an env at frame_skip 5 for the
# 13 models, and the layout the generator picks at frame_skip 5 for the two
# robots the benchmark runs. The shared code must leave every byte as it was.
ONE_THREAD_DIGESTS = {
    "ant": "efed2094a6815d1e079b95a3a3460479b1db40c83a5cd426e579a4484ec15a0e",
    "half_cheetah": "1e02e1201d4d7c684aaa2eb37d8288f51206f31bb13ebd1a8c3b2c4e17efee05",
    "hopper": "41ece788ab5e9f667fb2b8c1c8398847f2c282a54c2ce0b92afe2d9336bf1b63",
    "humanoid": "694da36a3e080300f0ba6e4db86ac5c778fc3bb8e269b18d4416331c9fccc610",
    "humanoidstandup": "c86d924d7c410076997fe1fbb5cd3f9119a42595da3b4bc6407239bdae2f7696",
    "inverted_double_pendulum": "e95e49a2b0217f09eb19e5f821679a9e6f7d954cb364f8bb3d8d776c323e946f",
    "inverted_pendulum": "a1196cd5567d7ad5bbd3b210eb26794525e28eeb038fc4463c036bf30ddbba9f",
    "pusher": "ff48f6d7d95790cf768f1d7facd7d43fe32feaf58d6ad4d97f8a558507aa2a11",
    "pusher_v5": "d063f8ee8e2694a950af5d427f39621a964b5a0ee67be1882fb74b579e3d6aa2",
    "reacher": "9d0a4d93cd23791622ec4b8473c8739a6cb438a9f333938073835c5ac1bac61b",
    "swimmer": "ddd049a2104103106c2a0422d9286452849a1526c23f00ec793b226039a06760",
    "walker2d": "742363b072a780cb66008efcacf644281abac6eca4572df114a92d80a505aabf",
    "walker2d_v5": "230a20cacdce4a0b510b3afa164c7052492250a4ce86272619c61eed73e91b17",
}
LAYOUT_DIGESTS = {
    "ant": "26d03c39cc3c6987e7b2ea56dfd466e1a3d03946c730254cf9918e451879ec4f",
    "half_cheetah": "f907adf40beb4a688b3c4da6012c2dc3d72887906df218acc56e324823ed3325",
}


def states(model, n=N, seed=0, lower=(None, 0.0)):
    """Perturbed float32 states; every other lane lowered by ``lower``."""
    rng = np.random.default_rng(seed)
    q = np.tile(art.init_qpos(model)[None, :], (n, 1)).astype(np.float32)
    q += rng.uniform(-0.3, 0.3, q.shape).astype(np.float32)
    if model.root_free:
        q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    index, depth = lower
    if index is not None:
        q[1::2, index] -= np.float32(depth)
    qd = rng.uniform(-1.0, 1.0, (n, model.nv)).astype(np.float32)
    return q, qd


@pytest.fixture(scope="module")
def gxx():
    path = shutil.which("g++")
    if path is None:
        pytest.skip("needs a host g++")
    return path


@pytest.fixture(scope="module")
def host_sincos(tmp_path_factory, gxx):
    """glibc's ``sincosf`` over a float32 array, built with the host ``g++``."""
    tmp = tmp_path_factory.mktemp("sincos")
    src, lib = tmp / "sincos.cpp", tmp / "libsincos.so"
    src.write_text('#include <math.h>\nextern "C" void sincos_rows(const float* x, float* s, float* c, int n) '
                   "{ for (int i = 0; i < n; ++i) sincosf(x[i], s + i, c + i); }\n")
    subprocess.run([gxx, "-O1", "-fno-builtin", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).sincos_rows
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    return fn


class _HostMathOps(TorchOps):
    """The twin's ops with each sine and cosine from glibc's ``sincosf`` and
    each square root correctly rounded (numpy's), as the host build takes
    them: torch's CPU ``sqrt`` can miss the nearest float by an ULP (MKL's
    vector square root)."""

    def __init__(self, fn):
        super().__init__("cpu")
        self.fn = fn

    def sincos(self, x):
        a = np.ascontiguousarray(self._tensor(x).numpy(), np.float32)
        s, c = np.empty_like(a), np.empty_like(a)
        self.fn(a.ctypes.data, s.ctypes.data, c.ctypes.data, a.size)
        return torch.from_numpy(s), torch.from_numpy(c)

    def sin(self, x):
        return self.sincos(x)[0]

    def cos(self, x):
        return self.sincos(x)[1]

    def sqrt(self, x):
        return torch.from_numpy(np.sqrt(self._tensor(x).numpy()))


def _host_wrenches(tmp_path, gxx, robot):
    """The emitted source built with the host ``g++``: ``(q, qd) -> (N, nbody, 6)``."""
    model, _ = load_model(robot)
    src, lib = tmp_path / f"{robot}_wrenches.cpp", tmp_path / f"lib{robot}_wrenches.so"
    src.write_text(generate_wrench_source(model, robot).text)
    subprocess.run([gxx, "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-I", str(SOURCE_DIR),
                    "-x", "c++", "-o", str(lib), str(src)], check=True, capture_output=True)
    host = ctypes.CDLL(str(lib)).contact_wrenches_host
    host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    nbody = len(model.bodies.parent)

    def run(q, qd):
        w = np.empty((len(q), nbody, 6), np.float32)
        host(q.ctypes.data, qd.ctypes.data, w.ctypes.data, len(q))
        return w

    return run


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_emitted_source_matches_twin_on_host(request, tmp_path, gxx, host_sincos, robot):
    model, _ = load_model(robot)
    q, qd = states(model, lower=ROBOTS[robot])
    got = _host_wrenches(tmp_path, gxx, robot)(q, qd)
    twin = cw.contact_wrenches_of(model).reference(torch.from_numpy(q), torch.from_numpy(qd)).numpy()
    touching = (np.abs(twin).reshape(N, -1).max(axis=1) > 0).mean()
    assert touching >= 0.25, f"contacts act in {touching:.0%} of the lanes"
    scale = float(np.abs(twin).max())
    err = float(np.abs(got - twin).max())
    request.node.user_properties.append(("max_abs_dw_over_max_w", err / scale))
    assert err <= REL * scale, f"{robot}: max |host - twin| {err:.3e}, max |twin| {scale:.3e}"
    rows = wrench_program(model_tables(model), _HostMathOps(host_sincos),
                          list(torch.from_numpy(q).T.contiguous()), list(torch.from_numpy(qd).T.contiguous()))
    glibc_twin = torch.stack([torch.as_tensor(r, dtype=torch.float32).expand(N) for r in rows], 1).numpy()
    np.testing.assert_array_equal(got.reshape(N, -1).view(np.int32), glibc_twin.view(np.int32))


def test_cpu_path_runs_the_twin_and_launches_nothing():
    model, _ = load_model("ant")
    op = cw.contact_wrenches_of(model)
    q, qd = (torch.from_numpy(x) for x in states(model, n=33, lower=ROBOTS["ant"]))
    before = dict(cw.launches)
    out = op(q, qd)
    assert dict(cw.launches) == before and op._launch is None
    assert torch.equal(out, op.reference(q, qd))
    assert out.shape == (33, len(model.bodies.parent), 6) and out.dtype == torch.float32
    # make_dynamics' helper is the same program, and one object serves every load of the model
    assert torch.equal(art.make_dynamics(load_model("ant")[0])["contact_wrenches"](q, qd), out)
    assert cw.contact_wrenches_of(load_model("ant")[0]) is op


def test_a_model_without_contacts_gives_zeros_and_has_no_kernel():
    model, _ = load_model("reacher")
    q, qd = (torch.from_numpy(x) for x in states(model, n=5))
    out = art.make_dynamics(model)["contact_wrenches"](q, qd)
    assert out.shape == (5, len(model.bodies.parent), 6) and not out.any()
    with pytest.raises(ValueError):
        generate_wrench_source(model, "reacher")


@pytest.mark.parametrize("bad", ["q_width", "qd_batch", "one_dim", "float64", "empty"])
def test_wrenches_reject_bad_inputs(bad):
    model, _ = load_model("ant")
    op = cw.contact_wrenches_of(model)
    q, qd = (torch.from_numpy(x) for x in states(model, n=8))
    if bad == "q_width":
        q = q[:, :-1]
    elif bad == "qd_batch":
        qd = qd[:-1]
    elif bad == "one_dim":
        q = q[0]
    elif bad == "float64":
        q = q.double()
    else:
        q, qd = q[:0], qd[:0]
    with pytest.raises(ValueError):
        op(q, qd)


def test_generated_source_is_stable_and_counted():
    model, _ = load_model("ant")
    a, b = generate_wrench_source(model, "ant"), generate_wrench_source(model, "ant")
    assert a.text == b.text
    lines = [line.strip() for line in a.text.splitlines()]
    statements = sum(line.startswith(("const float t", "const bool t")) for line in lines)
    pairs = sum("sincosf(" in line for line in lines)
    assert statements + 2 * pairs == a.ops_per_env == sum(a.substep_ops.values())
    legs = sum(int(j) == art.HINGE for j in model.joints.jtype[6:])  # the free root's rotations take no angle
    assert a.substep_ops["sin"] == a.substep_ops["cos"] == pairs == legs == 8
    assert sum(line.startswith("w[") for line in lines) == 6 * len(model.bodies.parent) == 78
    # the profiler's roofline of the articulated build counts kernels whose names hold ArticulatedStep
    assert "ArticulatedStep" not in a.text
    assert "struct ContactWrenches {" in a.text and "CW_ENTRY_POINTS(ContactWrenches)" in a.text
    assert "ArticulatedStep" not in (SOURCE_DIR / "contact_wrenches.cuh").read_text()
    assert a.layout["threads_a_block"] * a.layout["row_stride"] * 4 <= 48 * 1024
    assert a.layout["row_stride"] % 2 == 1


@pytest.mark.parametrize("name", sorted(ONE_THREAD_DIGESTS))
def test_articulated_sources_are_byte_for_byte_unchanged(name):
    model, _ = load_model(name)
    text = generate_source(model, 5, name, parts=1).text
    assert hashlib.sha256(text.encode()).hexdigest() == ONE_THREAD_DIGESTS[name]
    if name in LAYOUT_DIGESTS:
        text = generate_source(model, 5, name).text
        assert hashlib.sha256(text.encode()).hexdigest() == LAYOUT_DIGESTS[name]
