"""The port's utilities: ``utils/seeding.py::torch_generator`` against the
JAX package's ``jax_key`` (its checks and messages), ``utils/performance.py``
on the CPU, ``utils/checkpoint.py`` (every dtype by its bits, the env carry
round trip of ``tests/test_checkpoint.py``, a PPO state resumed into a fresh
``init_ppo`` bit for bit), and the lazy names of ``utils/__init__.py``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import gymnasium_tpu.utils as jutils
import gymnasium_tpu_torch as gym
import gymnasium_tpu_torch.utils as utils
from gymnasium_tpu.utils import seeding as jseeding
from gymnasium_tpu_torch import error
from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional
from gymnasium_tpu_torch.functional import EnvCarry
from gymnasium_tpu_torch.train.ppo import PPOConfig, init_ppo, make_train_step
from gymnasium_tpu_torch.utils import seeding
from gymnasium_tpu_torch.utils.checkpoint import restore_pytree, save_pytree
from gymnasium_tpu_torch.utils.performance import (
    benchmark_compiled_rollout,
    benchmark_init,
    benchmark_render,
    benchmark_step,
    trace,
)

CPU = {"device": "cpu"}
# utils/performance.py:benchmark_compiled_rollout of the JAX package returns these
ROLLOUT_KEYS = {"steps_per_second", "first_call_seconds", "steady_state_seconds_per_rollout"}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


# --- seeding ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", [-1, -7, 1.5, "3", 2.0], ids=str)
def test_torch_generator_rejects_a_seed_as_jax_key_does(seed):
    with pytest.raises(error.Error) as got:
        seeding.torch_generator(seed, "cpu")
    with pytest.raises(Exception) as want:
        jseeding.jax_key(seed)
    assert type(want.value).__name__ == "Error" and str(got.value) == str(want.value)


def test_torch_generator_draws_as_manual_seed_does():
    for seed in (0, 1, 2**63 - 1):
        got, want = seeding.torch_generator(seed, "cpu"), torch.Generator().manual_seed(seed)
        assert got.device == torch.device("cpu") and got.initial_seed() == seed
        assert same_bits(torch.rand(1000, generator=got), torch.rand(1000, generator=want))
        assert same_bits(torch.randn(1000, generator=got), torch.randn(1000, generator=want))
    first, second = seeding.torch_generator(None, "cpu"), seeding.torch_generator(None, "cpu")
    assert 0 <= first.initial_seed() < 2**63 and first.initial_seed() != second.initial_seed()


def test_torch_generator_without_a_card_raises_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        seeding.torch_generator(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        seeding.torch_generator(0, "cuda")


def test_seeding_exports_match_jax():
    assert seeding.__all__ == [name.replace("jax_key", "torch_generator") for name in jseeding.__all__]
    assert seeding.RandomNumberGenerator is np.random.Generator is jseeding.RandomNumberGenerator
    got, seed = seeding.np_random(3)
    want, jseed = jseeding.np_random(3)
    assert seed == jseed and got.bit_generator.state == want.bit_generator.state


# --- utils/__init__ ------------------------------------------------------------


def test_utils_exports_and_lazy_names():
    assert utils.__all__ == jutils.__all__
    assert utils.seeding is seeding
    for name in ("benchmark_step", "benchmark_init", "benchmark_render", "benchmark_compiled_rollout"):
        assert getattr(utils, name).__module__ == "gymnasium_tpu_torch.utils.performance"
    assert utils.capped_cubic_video_schedule.__module__ == "gymnasium_tpu_torch.utils.save_video"
    assert hasattr(utils, "save_video")
    modules = {"check_env": "env_checker", "check_environments_match": "env_match",
               "data_equivalence": "data_equivalence", "play": "play", "PlayPlot": "play", "PlayableGame": "play",
               "step_api_compatibility": "step_api_compatibility",
               "convert_to_terminated_truncated_step_api": "step_api_compatibility",
               "convert_to_done_step_api": "step_api_compatibility"}
    for name, module in modules.items():
        assert hasattr(jutils, name)
        assert callable(getattr(utils, name)) and getattr(utils, name).__name__ == name
        assert getattr(utils, name).__module__ == f"gymnasium_tpu_torch.utils.{module}"


# --- performance -------------------------------------------------------------------


def test_benchmark_step_reports_rate():
    env = gym.make("CartPole-v1", disable_env_checker=True)
    assert benchmark_step(env, target_duration=0.2, seed=0) > 100
    env.close()


def test_benchmark_init_and_render_report_rates():
    assert benchmark_init(lambda: gym.make("CartPole-v1", disable_env_checker=True), target_duration=0.2) > 0
    env = gym.make("CartPole-v1", render_mode="rgb_array")
    env.reset(seed=0)
    assert benchmark_render(env, target_duration=0.1) > 0


def test_benchmark_compiled_rollout_returns_jax_keys():
    env = gym.make_vec("CartPole-v1", 8, vector_kwargs=CPU)
    out = benchmark_compiled_rollout(env, num_steps=16, repeats=2)
    assert set(out) == ROLLOUT_KEYS and all(v > 0 for v in out.values())
    assert out["steps_per_second"] == pytest.approx(8 * 16 / out["steady_state_seconds_per_rollout"])
    assert int(env.carry.steps.max()) > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)):
        with torch.profiler.record_function("port.traced"):
            torch.ones(64).cumsum(0)
    files = list(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "port.traced" for e in events)
    with trace(str(tmp_path / "host"), device_tracer_level=0):
        torch.ones(3).sum()
    assert len(list((tmp_path / "host").glob("*.pt.trace.json"))) == 1


# --- checkpoint ----------------------------------------------------------------------


DTYPES = ["bfloat16", "float16", "float32", "float64", "bool", "int8", "int16", "int32", "int64", "uint8",
          "complex64", "float8_e4m3fn", "float8_e5m2"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_dtype_round_trips_by_its_bits(tmp_path, dtype):
    dtype = getattr(torch, dtype)
    raw = torch.arange(-40, 40, dtype=torch.int64)
    values = (raw % 2 == 0) if dtype == torch.bool else raw.to(torch.float32).mul(1.37).to(dtype)
    if dtype.is_floating_point:
        values[:3] = torch.tensor([-0.0, float("inf"), float("nan")]).to(dtype)
    tree = {"x": values.reshape(4, 20), "scalar": values[5].clone()}
    path = save_pytree(str(tmp_path / "leaf"), tree)
    got = restore_pytree(path)
    for key in tree:
        assert same_bits(got[key], tree[key]), key
    with np.load(path, allow_pickle=False) as data:
        stored = data["leaf_0"]
    if dtype == torch.bfloat16:
        assert stored.dtype == np.uint16
        assert np.array_equal(stored, tree["x"].view(torch.int16).numpy().view(np.uint16))


def test_a_tree_round_trips_without_a_template(tmp_path):
    gen = torch.Generator().manual_seed(5)
    torch.rand(3, generator=gen)
    carry = EnvCarry(state=(torch.zeros(2, 4), torch.ones(2)), rng=gen, steps=torch.tensor([3, 0], dtype=torch.int32),
                     prev_done=torch.tensor([True, False]))
    tree = {"carry": carry, "same_rng": gen, "numbers": [1, 2.5, -0.0, None, "text", True],
            "numpy": (np.arange(6.0).reshape(2, 3), np.float32(1.5), np.int64(-4)), 7: {"nested": []}}
    path = save_pytree(str(tmp_path / "tree"), tree)
    assert path.endswith(".npz") and save_pytree(path, tree) == path
    got = restore_pytree(str(tmp_path / "tree"))
    assert type(got["carry"]) is EnvCarry and got["same_rng"] is got["carry"].rng
    assert torch.equal(got["carry"].rng.get_state(), gen.get_state())
    for a, b in zip((*got["carry"].state, got["carry"].steps, got["carry"].prev_done),
                    (*carry.state, carry.steps, carry.prev_done)):
        assert same_bits(a, b)
    assert got["numbers"] == [1, 2.5, -0.0, None, "text", True] and str(got["numbers"][2]) == "-0.0"
    assert type(got["numbers"][0]) is int and type(got["numbers"][5]) is bool
    arr, f32, i64 = got["numpy"]
    assert np.array_equal(arr, tree["numpy"][0]) and type(f32) is np.float32 and f32 == 1.5 and type(i64) is np.int64
    assert got[7] == {"nested": []}
    with np.load(path, allow_pickle=False) as data:
        # the structure, then 4 tensors, one generator (saved once), one array and 2 numpy scalars
        assert len(data.files) == 1 + 8
        assert all(data[name].dtype != object for name in data.files)


def test_env_carry_checkpoint_resume(tmp_path):
    """``tests/test_checkpoint.py::test_env_carry_checkpoint_resume`` in the
    port, bit for bit."""
    env = gym.make_vec("CartPole-v1", num_envs=8, vector_kwargs=CPU)
    env.reset(seed=0)
    for _ in range(5):
        env.step(np.zeros(8, dtype=np.int32))
    path = save_pytree(str(tmp_path / "carry"), env.carry)
    obs_a, r_a, *_ = env.step(np.ones(8, dtype=np.int32))

    env2 = gym.make_vec("CartPole-v1", num_envs=8, vector_kwargs=CPU)
    env2.reset(seed=999)  # different seed: state fully replaced by restore
    env2.carry = restore_pytree(path)
    obs_b, r_b, *_ = env2.step(np.ones(8, dtype=np.int32))
    assert same_bits(obs_a, obs_b) and same_bits(r_a, r_b)
    assert torch.equal(env.carry.rng.get_state(), env2.carry.rng.get_state())


def _ppo():
    func = CartPoleFunctional()
    config = PPOConfig(num_envs=8, rollout_steps=4, hidden_sizes=(16, 16))
    return func, config


def test_ppo_state_resumes_bit_for_bit(tmp_path):
    """A CartPole PPO state (bf16 hidden layers, bool ``prev_done``, two
    generators) saved after a train step and restored into a fresh
    ``init_ppo``: its next train step equals the uninterrupted one in every
    bit (parameters, Adam moments and ``step``, carry, obs, generators,
    metrics)."""
    func, config = _ppo()
    state, params = init_ppo(func, config, seed=0, device="cpu")
    step = make_train_step(func, config, params)
    state, _ = step(state)
    extra = state.obs.to(torch.bfloat16)
    path = save_pytree(str(tmp_path / "ppo"), {"state": state, "obs_bf16": extra})
    a, metrics_a = step(state)

    fresh, _ = init_ppo(func, config, seed=1, device="cpu")
    restored = restore_pytree(path, {"state": fresh, "obs_bf16": torch.zeros(())})
    r = restored["state"]
    assert r.policy is fresh.policy and r.optimizer is fresh.optimizer and r.rng is fresh.rng
    assert r.env_carry.rng is fresh.env_carry.rng and same_bits(restored["obs_bf16"], extra)
    assert r.env_carry.prev_done.dtype == torch.bool
    b, metrics_b = step(r)

    for p, q in zip(a.policy.parameters(), b.policy.parameters()):
        assert same_bits(p.detach(), q.detach())
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for k in sa["state"]:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert same_bits(sa["state"][k][key], sb["state"][k][key]), (k, key)
    for x, y in zip((*a.env_carry.state, a.env_carry.steps, a.env_carry.prev_done, a.obs, a.update_count),
                    (*b.env_carry.state, b.env_carry.steps, b.env_carry.prev_done, b.obs, b.update_count)):
        assert same_bits(x, y)
    for g, h in ((a.rng, b.rng), (a.env_carry.rng, b.env_carry.rng)):
        assert torch.equal(g.get_state(), h.get_state())
    for key in metrics_a:
        assert same_bits(metrics_a[key], metrics_b[key]), key


def test_a_module_or_optimizer_needs_a_template(tmp_path):
    func, config = _ppo()
    state, _ = init_ppo(func, config, seed=0, device="cpu")
    path = save_pytree(str(tmp_path / "ppo"), state)
    with pytest.raises(TypeError, match="template"):
        restore_pytree(path)
    other, _ = init_ppo(func, config._replace(hidden_sizes=(8,)), seed=0, device="cpu")
    with pytest.raises(RuntimeError):
        restore_pytree(path, other)
    with pytest.raises(ValueError, match="template"):
        restore_pytree(path, state[:3])
    with pytest.raises(TypeError, match="cannot save"):
        save_pytree(str(tmp_path / "bad"), {"f": lambda: 0})
    assert not Path(tmp_path / "bad.npz").exists()
