"""The fused CartPole rollout's plain twin against the JAX reference.

The JAX kernel (``gymnasium_tpu/ops/pallas_rollout.py``) cannot run on the
CPU: ``pltpu.prng_*`` has no CPU lowering. So the twin's per-step function
is held against ``make_autoreset_step(vectorize_func_env(CartPoleFunctional(),
N))`` of the JAX package with the same action bits and reset values injected
into both. The cases of ``tests/ops/test_pallas_rollout.py`` are then carried
over to the twin, which is what ``cartpole_rollout_fused`` runs on a CPU
tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.dynamics import cartpole as jax_cp
from gymnasium_tpu.envs.phys2d.cartpole import CartPoleFunctional as JaxCartPole
from gymnasium_tpu.functional import EnvCarry as JaxCarry
from gymnasium_tpu.functional import make_autoreset_step as jax_make_step
from gymnasium_tpu.functional import vectorize_func_env as jax_vectorize
from gymnasium_tpu_torch.ops import cartpole_rollout as cr
from gymnasium_tpu_torch.ops.cartpole_rollout import (
    cartpole_draws,
    cartpole_rollout_fused,
    cartpole_step_reference,
)

OBS_ATOL = 2e-5  # tests/ops/test_pallas_rollout.py:61
RESET_BOUND = 0.05


def _injected_draws(seed, num_steps, n):
    """Action bits and U[0,1) reset draws on the kernel's 2**-24 grid, from numpy."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=(num_steps, n))
    u = (rng.integers(0, 2**24, size=(num_steps, 4, n)) * 2.0**-24).astype(np.float32)
    return bits, u


def _jax_injected_step(n, time_limit=500):
    """Jitted JAX autoreset step whose reset draw is an argument."""
    func = JaxCartPole()
    batched = jax_vectorize(func, n)
    step = jax_make_step(batched, func.get_default_params(), time_limit=time_limit)

    def injected(carry, action, reset_state):
        # traced once: the reset hook returns the injected (N, 4) states
        batched.initial = lambda rng, params=None: reset_state
        return step(carry, action)

    return jax.jit(injected)


def test_step_reference_matches_jax_autoreset_step():
    n, num_steps = 64, 300
    rng = np.random.default_rng(0)
    state0 = rng.uniform(-0.05, 0.05, size=(n, 4)).astype(np.float32)
    steps0 = np.where(np.arange(n) % 2 == 0, rng.integers(490, 500, size=n), 0).astype(np.int32)
    bits, u = _injected_draws(1, num_steps, n)
    reset_states = ((u * 2.0 - 1.0) * RESET_BOUND).astype(np.float32)  # (S, 4, N)

    jstep = _jax_injected_step(n)
    jcarry = JaxCarry(
        state=jnp.asarray(state0),
        rng=jax.random.PRNGKey(0),
        steps=jnp.asarray(steps0),
        prev_done=jnp.zeros((n,), bool),
    )
    st = torch.from_numpy(state0.T.copy())
    sp = torch.from_numpy(steps0)
    done = torch.zeros(n, dtype=torch.bool)
    saw_trunc = saw_term = 0
    for s in range(num_steps):
        jcarry, ts = jstep(
            jcarry, jnp.asarray(bits[s], jnp.int32), jnp.asarray(reset_states[s].T)
        )
        st, sp, done, reward, term, trunc = cartpole_step_reference(
            st, sp, done, torch.from_numpy(bits[s]), torch.from_numpy(u[s])
        )
        np.testing.assert_allclose(st.T.numpy(), np.asarray(ts.obs), rtol=0, atol=OBS_ATOL)
        np.testing.assert_array_equal(reward.numpy(), np.asarray(ts.reward))
        np.testing.assert_array_equal(term.numpy(), np.asarray(ts.terminated))
        np.testing.assert_array_equal(trunc.numpy(), np.asarray(ts.truncated))
        np.testing.assert_array_equal(sp.numpy(), np.asarray(jcarry.steps))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jcarry.prev_done))
        saw_trunc += int(trunc.sum())
        saw_term += int(term.sum())
    assert saw_trunc > 0 and saw_term > 0, "both episode ends must be exercised"


def test_philox_known_answers():
    """Philox4x32-10 known-answer vectors of the Random123 library."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ]
    for ctr, key, expected in cases:
        words = cr._philox4x32_10(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
        assert tuple(int(w) for w in words) == expected


def test_draw_statistics():
    bits, u = cartpole_draws(5, 200, 256)
    assert bits.shape == (200, 256) and u.shape == (200, 4, 256)
    m = bits.numel()
    assert abs(bits.float().mean().item() - 0.5) < 4 * 0.5 / np.sqrt(m)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(u.mean().item() - 0.5) < 4 * np.sqrt(1 / 12 / u.numel())
    reset = (u * 2.0 - 1.0) * RESET_BOUND
    assert float(reset.abs().max()) <= RESET_BOUND


@pytest.fixture(scope="module")
def rollout():
    n, num_steps = 128, 600
    out = cartpole_rollout_fused(
        torch.zeros((4, n)), torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.bool), 42, num_steps
    )
    return [x.numpy() for x in out]


def test_shapes_and_dtypes(rollout):
    fstate, fsteps, fdone, obs, rew, term, trunc = rollout
    s, n = rew.shape
    assert obs.shape == (s, 4, n) and obs.dtype == np.float32
    assert fstate.shape == (4, n) and fstate.dtype == np.float32
    assert fsteps.shape == (n,) and fsteps.dtype == np.int32
    assert fdone.shape == (n,) and fdone.dtype == bool
    assert rew.dtype == np.float32 and term.dtype == bool and trunc.dtype == bool


def test_final_outputs_are_the_last_step(rollout):
    fstate, fsteps, fdone, obs, rew, term, trunc = rollout
    np.testing.assert_array_equal(fstate, obs[-1])
    np.testing.assert_array_equal(fdone, term[-1] | trunc[-1])


def test_physics_matches_shared_dynamics(rollout):
    """Each non-reset transition equals the JAX package's integrate() under
    one of the two actions."""
    _, _, _, obs, rew, term, trunc = rollout
    done = term | trunc
    p = jax_cp.CartPoleParams()
    for s in range(64):
        for e in range(0, obs.shape[2], 16):
            if done[s, e]:
                continue  # the next step is a reset, no transition
            st, target = obs[s, :, e], obs[s + 1, :, e]
            cands = [
                jax_cp.integrate(np, st[None, :], f, p, euler=True)[0]
                for f in (-p.force_mag, p.force_mag)
            ]
            assert any(np.allclose(c.astype(np.float32), target, atol=OBS_ATOL) for c in cands)


def test_autoreset_next_step(rollout):
    _, _, _, obs, rew, term, trunc = rollout
    done = term | trunc
    assert done.any(), "random-policy CartPole must terminate within 600 steps"
    for s in range(done.shape[0] - 1):
        idx = np.where(done[s])[0]
        if len(idx) == 0:
            continue
        assert np.all(rew[s + 1, idx] == 0.0)
        assert np.all(np.abs(obs[s + 1, :, idx]) <= RESET_BOUND)
        assert not np.any(done[s + 1, idx])


def test_termination_iff_threshold_crossed(rollout):
    _, _, _, obs, rew, term, trunc = rollout
    p = jax_cp.CartPoleParams()
    exceeded = (np.abs(obs[:, 0, :]) > np.float32(p.x_threshold)) | (
        np.abs(obs[:, 2, :]) > np.float32(p.theta_threshold)
    )
    reset_step = np.zeros_like(term)
    reset_step[1:] = (term | trunc)[:-1]
    np.testing.assert_array_equal(term, exceeded & ~reset_step)


def test_reward_is_one_until_reset(rollout):
    _, _, _, obs, rew, term, trunc = rollout
    done = term | trunc
    reset_mask = np.zeros_like(done)
    reset_mask[1:] = done[:-1]
    assert np.all(rew[reset_mask] == 0.0)
    assert np.all(rew[~reset_mask] == 1.0)


def test_deterministic_given_seed():
    n, num_steps = 64, 100
    args = (torch.zeros((4, n)), torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.bool))
    a = cartpole_rollout_fused(*args, 7, num_steps)
    b = cartpole_rollout_fused(*args, 7, num_steps)
    c = cartpole_rollout_fused(*args, 8, num_steps)
    assert torch.equal(a[3], b[3])
    assert not torch.equal(a[3], c[3])


def test_bf16_obs_variant():
    n, num_steps = 64, 50
    args = (torch.zeros((4, n)), torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.bool), 3, num_steps)
    f32 = cartpole_rollout_fused(*args)
    bf16 = cartpole_rollout_fused(*args, obs_dtype=torch.bfloat16)
    assert bf16[3].dtype == torch.bfloat16
    assert torch.isfinite(bf16[3].float()).all()
    # the state stays float32 inside; only the stored observation is rounded
    assert torch.equal(bf16[3], f32[3].to(torch.bfloat16))
    for i in (0, 1, 2, 4, 5, 6):
        assert torch.equal(bf16[i], f32[i])


@pytest.mark.parametrize(
    "change",
    [
        {"state": torch.zeros((4, 8), dtype=torch.float64)},
        {"state": torch.zeros((8, 4))},
        {"steps": torch.zeros(8, dtype=torch.int64)},
        {"prev_done": torch.zeros(8, dtype=torch.int32)},
        {"prev_done": torch.zeros(7, dtype=torch.bool)},
        {"seed": 2**31},
        {"num_steps": 0},
        {"obs_dtype": torch.float16},
    ],
)
def test_rejects_inputs_the_kernel_does_not_take(change):
    args = {
        "state": torch.zeros((4, 8)),
        "steps": torch.zeros(8, dtype=torch.int32),
        "prev_done": torch.zeros(8, dtype=torch.bool),
        "seed": 0,
        "num_steps": 4,
    }
    args.update(change)
    with pytest.raises(ValueError):
        cartpole_rollout_fused(**args)
