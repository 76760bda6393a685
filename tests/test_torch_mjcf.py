"""The port's MJCF compiler and ``.xml`` models against the JAX package's.

- ``compile_mjcf`` on several inline XMLs in both packages: every field of
  the model and of ``meta`` equal (the numpy code is the same, so floats are
  equal too): the minicart of ``tests/envs/test_custom_mujoco_env.py``; a
  model with nested default classes, ``childclass``, margins, ``solref``,
  ``settotalmass``, every orientation attribute, a ball joint, an
  ``inertial``, a site and a camera; a swimmer-like chain in a medium
  (``<option density viscosity>``); a free root; and ``chip_smoke.py``'s
  chain.
- ``load_model`` resolves an ``.xml`` name as JAX's does: absolute, relative
  to the working directory, under ``MJCF_ASSET_DIR``; a missing file raises
  ``OSError``. The kernel's name tells two files apart.
- a ``MujocoFuncEnv`` subclass over the minicart and over the chain, against
  JAX's over the same file (vmapped and jitted), through the articulated
  twin, 10 steps at the engine tolerance of ``tests/test_torch_mujoco.py``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from chip_smoke import MJCF_CHAIN_XML
from gymnasium_tpu.envs.mujoco import mjcf as jax_mjcf
from gymnasium_tpu.envs.mujoco.locomotion import MujocoFuncEnv as JaxMujocoFuncEnv
from gymnasium_tpu.envs.mujoco.mujoco_env import load_model as jax_load_model
from gymnasium_tpu_torch.envs.mujoco import mjcf
from gymnasium_tpu_torch.envs.mujoco.locomotion import MujocoFuncEnv
from gymnasium_tpu_torch.envs.mujoco.mujoco_env import kernel_name, load_model, resolve_xml
from gymnasium_tpu_torch.ops import articulated_step
from tests.envs.test_custom_mujoco_env import CART_XML
from tests.test_torch_mujoco import Q_TOL, QD_TOL
from tests.test_torch_mujoco_kinematics import states

CLASSY_XML = """
<mujoco model="classy">
  <compiler angle="radian" settotalmass="12"/>
  <option timestep="0.005" gravity="0 0 -9.81"/>
  <default>
    <joint damping="0.2" armature="0.01" limited="true"/>
    <geom density="800" margin="0.01" rgba="0.8 0.6 0.4 1"/>
    <motor ctrllimited="true" ctrlrange="-1 1"/>
    <default class="leg">
      <joint range="-1 1" stiffness="2"/>
      <geom type="capsule" size="0.04" solref="0.02 1"/>
      <default class="foot">
        <geom type="sphere" size="0.05" solref="0.01 1" margin="0.002"/>
      </default>
    </default>
  </default>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 .1" margin="0.005"/>
    <body name="torso" pos="0 0 0.8" childclass="leg">
      <joint name="rootx" type="slide" axis="1 0 0" limited="false"/>
      <joint name="rootz" type="slide" axis="0 0 1" limited="false" ref="0.8"/>
      <joint name="rooty" type="hinge" axis="0 1 0" limited="false"/>
      <geom name="torso_geom" type="box" size="0.2 0.1 0.05"/>
      <geom name="head" type="ellipsoid" size="0.05 0.04 0.06" pos="0.2 0 0.1" contype="0"/>
      <site name="tip" pos="0.2 0 0"/>
      <camera name="track" mode="trackcom" pos="0 -3 0.3" xyaxes="1 0 0 0 0 1"/>
      <body name="thigh" pos="0.1 0 -0.05" euler="0 0.3 0">
        <joint name="hip" axis="0 1 0"/>
        <geom fromto="0 0 0 0 0 -0.3"/>
        <body name="shin" pos="0 0 -0.3" quat="1 0 0.1 0">
          <joint name="knee" axis="0 1 0" range="-2 0"/>
          <geom fromto="0 0 0 0 0 -0.25" size="0.03"/>
          <geom class="foot" pos="0 0 -0.25"/>
          <inertial pos="0 0 -0.1" mass="0.3" diaginertia="0.01 0.01 0.002"/>
        </body>
      </body>
      <body name="arm" pos="-0.1 0 0" axisangle="0 0 1 0.5">
        <joint name="shoulder" type="ball" limited="false"/>
        <geom type="cylinder" size="0.03 0.1" pos="0 0 0.1" mass="0.5"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor joint="hip" gear="20"/>
    <motor joint="knee" gear="15" ctrlrange="-0.5 0.5"/>
    <motor joint="rootx" gear="1" ctrllimited="false"/>
  </actuator>
</mujoco>
"""

MEDIUM_XML = """
<mujoco model="eel">
  <option density="4000" viscosity="0.1" timestep="0.01"/>
  <default>
    <geom type="capsule" size="0.1" density="1000" contype="0"/>
    <joint type="hinge" axis="0 0 1" limited="true" range="-100 100" damping="0"/>
  </default>
  <worldbody>
    <body name="head" pos="0 0 0">
      <joint name="slider1" type="slide" axis="1 0 0" limited="false"/>
      <joint name="slider2" type="slide" axis="0 1 0" limited="false"/>
      <joint name="free_body_rot" limited="false"/>
      <geom fromto="1.5 0 0 0.5 0 0"/>
      <body name="mid" pos="0.5 0 0">
        <joint name="motor1_rot"/>
        <geom fromto="0 0 0 -1 0 0"/>
        <body name="tail" pos="-1 0 0">
          <joint name="motor2_rot"/>
          <geom fromto="0 0 0 -1 0 0"/>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor ctrllimited="true" ctrlrange="-1 1" gear="150.0" joint="motor1_rot"/>
    <motor ctrllimited="true" ctrlrange="-1 1" gear="150.0" joint="motor2_rot"/>
  </actuator>
</mujoco>
"""

FREE_XML = """
<mujoco model="floater">
  <compiler angle="degree"/>
  <worldbody>
    <geom name="floor" type="plane" pos="0 0 -0.1" size="5 5 .1"/>
    <body name="torso" pos="0 0 0.75">
      <joint name="root" type="free" limited="false"/>
      <geom type="sphere" size="0.25" density="5"/>
      <body name="leg" pos="0.2 0 0">
        <joint name="hip" type="hinge" axis="0 0 1" range="-30 30" limited="true"/>
        <geom type="capsule" fromto="0 0 0 0.3 0 -0.2" size="0.08"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor joint="hip" gear="150" ctrlrange="-1 1" ctrllimited="true"/>
  </actuator>
</mujoco>
"""

XMLS = {"minicart": CART_XML, "classy": CLASSY_XML, "medium": MEDIUM_XML, "free_root": FREE_XML,
        "chain": MJCF_CHAIN_XML}


@pytest.fixture(scope="module")
def xml_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("mjcf")
    for name, text in XMLS.items():
        (path / f"{name}.xml").write_text(text)
    return path


def assert_same(got, want, label):
    """Equal values, with equal types, through named tuples, dicts and lists."""
    if isinstance(want, tuple) and hasattr(want, "_fields"):
        assert type(got).__name__ == type(want).__name__ and got._fields == want._fields, label
        for field in want._fields:
            assert_same(getattr(got, field), getattr(want, field), f"{label}.{field}")
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), label
        for key in want:
            assert_same(got[key], want[key], f"{label}[{key!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), label
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{label}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape, label
        np.testing.assert_array_equal(got, want, err_msg=label)
    else:
        assert type(got) is type(want) and (got == want or (got != got and want != want)), f"{label}: {got} != {want}"


@pytest.mark.parametrize("name", sorted(XMLS))
def test_compile_mjcf_matches_jax(xml_dir, name):
    path = str(xml_dir / f"{name}.xml")
    model, meta = mjcf.compile_mjcf(path)
    jmodel, jmeta = jax_mjcf.compile_mjcf(path)
    assert_same(model, jmodel, name)
    assert_same(meta, jmeta, f"{name} meta")
    assert model.nv >= 1 and model.nu >= 1
    if name == "free_root":
        assert model.root_free and model.nq == model.nv + 1
    if name == "medium":
        assert model.fluid_density == 4000.0 and model.fluid_viscosity == 0.1


def test_compile_mjcf_stiffness_option_matches_jax(xml_dir):
    path = str(xml_dir / "classy.xml")
    assert_same(mjcf.compile_mjcf(path, 5e4)[0], jax_mjcf.compile_mjcf(path, 5e4)[0], "classy at 5e4")


def test_load_model_resolves_paths_as_jax(xml_dir, tmp_path, monkeypatch):
    absolute = str(xml_dir / "minicart.xml")
    model, meta = load_model(absolute)
    assert_same(model, jax_load_model(absolute)[0], "absolute")
    assert load_model(absolute)[0] is model, "compiled once a path"
    assert resolve_xml(absolute) == absolute

    monkeypatch.chdir(xml_dir)
    assert resolve_xml("chain.xml") == str(xml_dir / "chain.xml")
    assert_same(load_model("chain.xml")[0], jax_load_model("chain.xml")[0], "cwd-relative")

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MJCF_ASSET_DIR", str(xml_dir))
    assert resolve_xml("medium.xml") == os.path.abspath(xml_dir / "medium.xml")
    assert_same(load_model("medium.xml")[0], jax_load_model("medium.xml")[0], "MJCF_ASSET_DIR")

    monkeypatch.delenv("MJCF_ASSET_DIR")
    for missing in ("medium.xml", str(tmp_path / "nowhere.xml")):
        with pytest.raises(OSError):
            load_model(missing)
        with pytest.raises(OSError):
            jax_load_model(missing)


def test_kernel_names_tell_files_apart(xml_dir, tmp_path):
    copy = tmp_path / "chain.xml"
    copy.write_text(MJCF_CHAIN_XML)
    names = {kernel_name(str(xml_dir / "chain.xml")), kernel_name(str(copy)), kernel_name(str(xml_dir / "minicart.xml"))}
    assert len(names) == 3
    for name in names:
        assert name.isidentifier() and name.startswith("xml_") and "/" not in name
    assert kernel_name(str(copy)) == kernel_name(str(copy)) and kernel_name("half_cheetah") == "half_cheetah"
    a = articulated_step.fused_step(str(copy), 2)
    assert a is articulated_step.fused_step(str(copy), 2)
    assert a.name == kernel_name(str(copy)) and a.source.layout["parts"] == 1
    assert a.build_name == f"articulated_{a.name}_fs2"


def _env_pair(path, frame_skip):
    class Port(MujocoFuncEnv):
        model_name = path

        def reward(self, state, action, next_state, rng, params=None):
            return (next_state["qpos"][:, 0] - next_state["prev_x"]) / self.dt - 0.1 * torch.sum(action**2, dim=-1)

    class Jax(JaxMujocoFuncEnv):
        model_name = path

        def reward(self, state, action, next_state, rng, params=None):
            return (next_state["qpos"][0] - next_state["prev_x"]) / self.dt - 0.1 * (action**2).sum()

    Port.frame_skip = Jax.frame_skip = frame_skip
    return Port(), Jax()


@pytest.mark.parametrize("name", ["minicart", "chain"])
def test_xml_func_env_steps_as_jax(request, xml_dir, name):
    func, jfunc = _env_pair(str(xml_dir / f"{name}.xml"), 2)
    q, qd = states(jfunc.model, 16, seed=1)
    action = np.random.default_rng(3).uniform(-1, 1, (10, 16, func.model.nu)).astype(np.float32)

    def hooks(s, a):
        ns = jfunc.transition(s, a, None)
        return ns, jfunc.observation(ns, None), jfunc.reward(s, a, ns, None)

    jstep = jax.jit(jax.vmap(hooks))
    jstate = {"qpos": q, "qvel": qd, "prev_x": q[:, 0]}
    state = {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}
    before = dict(articulated_step.launches)
    worst = 0.0
    for s in range(10):
        jstate, jobs, jrew = jstep(jstate, action[s])
        a = torch.from_numpy(action[s])
        nstate = func.transition(state, a, None)
        obs, rew = func.observation(nstate, None), func.reward(state, a, nstate, None)
        state = nstate
        for key, got, want, tol in (("qpos", state["qpos"], jstate["qpos"], Q_TOL),
                                    ("qvel", state["qvel"], jstate["qvel"], QD_TOL),
                                    ("obs", obs, jobs, QD_TOL), ("reward", rew, jrew, QD_TOL)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol, err_msg=f"step {s} {key}")
            worst = max(worst, float(np.abs(got.numpy() - np.asarray(want)).max()))
    request.node.user_properties.append(("max_abs_dev", worst))
    assert articulated_step.launches == before, "the CPU batch launched a kernel"
    assert func._step.name == kernel_name(str(xml_dir / f"{name}.xml"))
