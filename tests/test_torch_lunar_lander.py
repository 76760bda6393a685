"""LunarLander of the port against the JAX package, hook by hook.

The port's dynamics helpers run against the JAX ones on the same numpy
inputs. Whole steps run against JAX ``full_step``, whose two solver ticks are
``world_step`` (the engine the JAX kernel is tested against), compared step
by step from the port's own states: every step of a run is fed to JAX from
the port's state before it, with the same draws, so a contact flag that one
ULP flips cannot spread over a trajectory. Eager JAX pays per operation, not
per lane, so all the steps go to JAX as one batch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gymnasium_tpu.envs.dynamics.lunar_lander as L
from gymnasium_tpu_torch.envs.box2d.lunar_lander import (
    LunarLanderContinuousFunctional,
    LunarLanderFunctional,
)
from gymnasium_tpu_torch.envs.dynamics import lunar_lander as dyn
from gymnasium_tpu_torch.functional import tree_map
from gymnasium_tpu_torch.spaces import Box, Discrete
from gymnasium_tpu_torch.vector import TorchVectorEnv

# tests/ops/test_pallas_planar.py:107-110, the JAX kernel's test against
# world_step (largest seen here: 2.5e-6 in body, 1.9e-6 in the impulses)
BODY_TOL = {"rtol": 0.0, "atol": 2e-4}
IMPULSE_TOL = {"rtol": 0.0, "atol": 1e-4}
# the shaping potential is about -100 to -300 and moves 100x the
# observation's error; the reward is a difference of two of them (largest
# seen: 1.5e-5). The sleep timer adds dt the same way on both sides.
SHAPING_TOL = {"rtol": 1e-6, "atol": 1e-4}
TIMER_TOL = {"rtol": 1e-6, "atol": 0.0}
# the dynamics helpers: the same float32 operations in the same order; sin,
# cos and sqrt may differ by an ULP between the two libraries
HELPER_TOL = {"rtol": 2e-7, "atol": 1e-6}
FLOAT_LEAVES = ("sleep_timer", "prev_shaping", "r")
BOOL_LEAVES = ("leg1", "leg2", "done")


def _np(state):
    return {k: v.numpy() for k, v in state.items()}


def _assert_step_close(got, want):
    """A port state against a JAX state: solver leaves at the engine's
    tolerances, flags exact, the rest relative to their size."""
    want = {k: np.asarray(v) for k, v in want.items()}
    np.testing.assert_allclose(got["body"], want["body"], **BODY_TOL, err_msg="body")
    np.testing.assert_allclose(got["jimp"], want["jimp"], **IMPULSE_TOL, err_msg="jimp")
    np.testing.assert_allclose(got["cimp"], want["cimp"], **IMPULSE_TOL, err_msg="cimp")
    np.testing.assert_array_equal(got["terrain"], want["terrain"], err_msg="terrain")
    for key in BOOL_LEAVES:
        assert got[key].dtype == np.bool_
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["sleep_timer"], want["sleep_timer"], **TIMER_TOL)
    np.testing.assert_allclose(got["prev_shaping"], want["prev_shaping"], **SHAPING_TOL)
    np.testing.assert_allclose(got["r"], want["r"], **SHAPING_TOL)


def _draws(n, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.uniform(0, 1, (n, dyn.CHUNKS + 1)).astype(np.float32),
        rng.uniform(-1, 1, (n, 2)).astype(np.float32),
    )


def _near_ground(func, n, seed):
    """Reset states dropped, legs first, to 1-15 cm above the helipad; one
    lane in four falls at 7 m/s, the others at 0.1-1 m/s."""
    rng = np.random.default_rng(seed)
    tu, fu = _draws(n, seed)
    state = func.reset_values(torch.from_numpy(tu), torch.from_numpy(fu))
    body = state["body"].clone()
    ang = body[:, 1:, 2]
    corners = [
        body[:, 1:, 1] + sx * torch.sin(ang) - dyn.LEG_H / dyn.SCALE * torch.cos(ang)
        for sx in (-dyn.LEG_W / dyn.SCALE, dyn.LEG_W / dyn.SCALE)
    ]
    lowest = torch.stack(corners, dim=-1).amin(dim=(1, 2))
    gap = torch.from_numpy(rng.uniform(0.01, 0.15, n).astype(np.float32))
    body[:, :, 1] += (0.99 * dyn.HELIPAD_Y + gap - lowest)[:, None]
    vy = torch.from_numpy(rng.uniform(-1.0, -0.1, n).astype(np.float32))
    vy[::4] = -7.0
    body[:, :, 3], body[:, :, 4], body[:, :, 5] = 0.0, vy[:, None], 0.0
    shaping = dyn.shaping(dyn.observe(body, state["leg1"], state["leg2"]))
    return dict(state, body=body, prev_shaping=shaping)


def test_dynamics_helpers_match_jax():
    rng = np.random.default_rng(0)
    n = 64
    tu, fu = _draws(n, 1)
    np.testing.assert_allclose(
        dyn.generate_terrain(torch.from_numpy(tu)).numpy(),
        np.asarray(L.generate_terrain(jnp, jnp.asarray(tu))), **HELPER_TOL,
    )
    bodies = rng.uniform(-1, 1, (n, 3, 6)).astype(np.float32)
    bodies[:, :, :2] += np.float32(8.0)
    legs = rng.uniform(size=(2, n)) < 0.5
    obs = dyn.observe(torch.from_numpy(bodies), *map(torch.from_numpy, legs))
    jobs = L.observe(jnp, jnp.asarray(bodies), *map(jnp.asarray, legs))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), **HELPER_TOL)
    np.testing.assert_allclose(
        dyn.shaping(obs).numpy(), np.asarray(L.shaping(jnp, jobs)), rtol=2e-7, atol=1e-4
    )

    discrete = rng.integers(0, 4, n).astype(np.int32)
    continuous = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    for action, cont in ((discrete, False), (continuous, True)):
        got = dyn.engine_activation(torch.from_numpy(action), cont)
        want = L.engine_activation(jnp, jnp.asarray(action), cont)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

        disp = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        wind = rng.uniform(-15, 15, (n, 2)).astype(np.float32)
        p = dyn.LunarParams()
        ext, m, s = dyn.engine_external(
            {"body": torch.from_numpy(bodies)}, torch.from_numpy(action), torch.from_numpy(disp),
            torch.from_numpy(wind), p, cont,
        )
        jext, jm, js = L.engine_external(
            jnp, {"body": jnp.asarray(bodies)}, jnp.asarray(action), jnp.asarray(disp),
            jnp.asarray(wind), L.LunarParams(), cont,
        )
        np.testing.assert_allclose(ext.numpy(), np.asarray(jext), rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_finish_step_matches_jax():
    rng = np.random.default_rng(2)
    n = 64
    bodies = rng.uniform(-0.04, 0.04, (n, 3, 6)).astype(np.float32)
    bodies[:, :, 0] += np.float32(10.0)
    bodies[:, :, 1] += np.float32(4.0)
    bodies[::3, 0, 0] = np.float32(19.9)  # beyond |obs x| >= 1
    state = {
        "terrain": rng.uniform(0, 6, (n, dyn.CHUNKS)).astype(np.float32),
        "sleep_timer": (rng.integers(0, 30, n) * np.float32(0.02)).astype(np.float32),
        "prev_shaping": rng.uniform(-200, -50, n).astype(np.float32),
    }
    jimp = rng.uniform(-1, 1, (n, 2, 5)).astype(np.float32)
    cimp = rng.uniform(0, 1, (n, 10, 2)).astype(np.float32)
    flags = rng.uniform(size=(n, 10)) < 0.2
    flags[:, 4:] &= rng.uniform(size=(n, 1)) < 0.3
    m_power = rng.uniform(0, 1, n).astype(np.float32)
    s_power = rng.uniform(0, 1, n).astype(np.float32)
    got = dyn.finish_step(
        {k: torch.from_numpy(v) for k, v in state.items()}, torch.from_numpy(bodies),
        (torch.from_numpy(jimp), torch.from_numpy(cimp)), torch.from_numpy(flags),
        torch.from_numpy(m_power), torch.from_numpy(s_power), dyn.LunarParams(),
    )
    want = L.finish_step(
        jnp, {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(bodies),
        (jnp.asarray(jimp), jnp.asarray(cimp)), jnp.asarray(flags),
        jnp.asarray(m_power), jnp.asarray(s_power), L.LunarParams(),
    )
    got = _np(got)
    for key in ("body", "terrain", "jimp", "cimp", "leg1", "leg2", "done"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    for key in FLOAT_LEAVES:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=2e-7, atol=1e-4, err_msg=key)
    done = got["done"]
    assert done.any() and (~done).any()
    assert set(np.unique(got["r"][done])) <= {-100.0, 100.0}
    assert (got["r"][done] == 100.0).any() and (got["r"][done] == -100.0).any()


# Eager JAX compiles each operation once per shape, so every JAX step call
# of this file takes the same batch: the near-ground run (14 steps of 16
# lanes), four wind lanes and twelve reset lanes.
RUN_LANES, RUN_STEPS, WIND_LANES, RESET_LANES = 16, 14, 4, 12
BATCH = RUN_LANES * RUN_STEPS + WIND_LANES + RESET_LANES


def _jax_full_step(states, actions, disps, winds, continuous):
    """JAX ``full_step`` over the concatenated per-step inputs (numpy)."""
    cat = lambda parts: np.concatenate(parts, axis=0)  # noqa: E731
    jstate = {k: jnp.asarray(cat([s[k] for s in states])) for k in states[0]}
    assert jstate["body"].shape[0] == BATCH
    want = L.full_step(jnp, jstate, jnp.asarray(cat(actions)), jnp.asarray(cat(disps)),
                       jnp.asarray(cat(winds)), L.LunarParams(), continuous)
    return {k: np.asarray(v) for k, v in want.items()}


def _split(tree, sizes):
    out, start = [], 0
    for size in sizes:
        out.append({k: v[start : start + size] for k, v in tree.items()})
        start += size
    return out


@pytest.fixture(scope="module")
def discrete_steps():
    """Port steps and JAX ``full_step`` from the port's state before each, in
    one JAX call: ``{"run": ..., "wind": ..., "reset": ...}``, each
    ``(port states after, JAX states after, port trace)``."""
    rng = np.random.default_rng(5)
    func = LunarLanderFunctional()
    before, after, actions, disps, winds = [], [], [], [], []

    # the near-ground run: touchdown, leg flags, crashes, the sleep timer,
    # with the engines firing on a quarter of the lanes
    state = _near_ground(func, RUN_LANES, seed=4)
    for _ in range(RUN_STEPS):
        action = np.zeros(RUN_LANES, np.int32)
        action[1::4] = rng.integers(0, 4, RUN_LANES // 4)
        disp = rng.uniform(-1, 1, (RUN_LANES, 2)).astype(np.float32)
        nxt = func.transition_values(state, torch.from_numpy(action), torch.from_numpy(disp))
        before.append(_np(state))
        after.append(_np(nxt))
        actions.append(action)
        disps.append(disp)
        winds.append(np.zeros((RUN_LANES, 2), np.float32))
        state = nxt

    # one step with wind, one lane for each action
    windy = LunarLanderFunctional({"enable_wind": True})
    tu, fu = _draws(WIND_LANES, 6)
    wstate = windy.reset_values(torch.from_numpy(tu), torch.from_numpy(fu))
    waction = np.arange(WIND_LANES, dtype=np.int32) % 4
    wdisp = rng.uniform(-1, 1, (WIND_LANES, 2)).astype(np.float32)
    wdraw = rng.uniform(-1, 1, (WIND_LANES, 2)).astype(np.float32)
    wnext = windy.transition_values(wstate, torch.from_numpy(waction), torch.from_numpy(wdisp),
                                    torch.from_numpy(wdraw))
    calm = windy.transition_values(wstate, torch.from_numpy(waction), torch.from_numpy(wdisp),
                                   torch.zeros((WIND_LANES, 2)))
    assert not torch.equal(wnext["body"], calm["body"]), "the wind draw did not move the hull"
    before.append(_np(wstate))
    after.append(_np(wnext))
    actions.append(waction)
    disps.append(wdisp)
    # the functional's wind stand-in: U[-1, 1) draws times the two powers
    winds.append(np.asarray(jnp.asarray(wdraw) * jnp.asarray([15.0, 1.5])))

    # the reset: JAX initial_state is full_step from the creation pose with
    # no action and no draws
    tu, fu = _draws(RESET_LANES, 3)
    pre = L.initial_state_pre(jnp, jnp.asarray(tu), jnp.asarray(fu), L.LunarParams())
    before.append({k: np.asarray(v) for k, v in pre.items()})
    after.append(_np(func.reset_values(torch.from_numpy(tu), torch.from_numpy(fu))))
    actions.append(np.zeros(RESET_LANES, np.int32))
    disps.append(np.zeros((RESET_LANES, 2), np.float32))
    winds.append(np.zeros((RESET_LANES, 2), np.float32))

    want = _jax_full_step(before, actions, disps, winds, continuous=False)
    got = {k: np.concatenate([a[k] for a in after]) for k in after[0]}
    sizes = [RUN_LANES * RUN_STEPS, WIND_LANES, RESET_LANES]
    trace = {k: np.stack([a[k] for a in after[:RUN_STEPS]]) for k in after[0]}
    return {
        name: (g, w) for name, g, w in zip(("run", "wind", "reset"), _split(got, sizes), _split(want, sizes))
    } | {"trace": trace}


def test_reset_values_match_jax_initial_state(discrete_steps):
    got, want = discrete_steps["reset"]
    _assert_step_close(got, want)
    assert not got["done"].any() and got["body"].dtype == np.float32


def test_near_ground_run_matches_jax_step_by_step(discrete_steps):
    """Each port step of the run against JAX ``full_step`` from the port's
    own state before it."""
    got, want = discrete_steps["run"]
    _assert_step_close(got, want)
    trace = discrete_steps["trace"]
    assert (trace["leg1"] | trace["leg2"]).any(axis=0).all(), "a lane never touched down"
    crashed = trace["done"] & (trace["r"] == -100.0)
    assert crashed.any(axis=0).sum() >= RUN_LANES // 2
    assert (trace["sleep_timer"] > 0).any(), "no lane came to rest on its legs"
    assert trace["cimp"][..., 0].max() > 0, "no normal impulse built up"


def test_wind_step_matches_jax(discrete_steps):
    got, want = discrete_steps["wind"]
    _assert_step_close(got, want)


def test_continuous_step_matches_jax():
    func = LunarLanderContinuousFunctional()
    rng = np.random.default_rng(7)
    state = _near_ground(func, BATCH, seed=8)
    action = rng.uniform(-1.5, 1.5, (BATCH, 2)).astype(np.float32)  # beyond the box: clipped
    disp = rng.uniform(-1, 1, (BATCH, 2)).astype(np.float32)
    got = _np(func.transition_values(state, torch.from_numpy(action), torch.from_numpy(disp)))
    want = _jax_full_step([_np(state)], [np.clip(action, -1.0, 1.0)], [disp],
                          [np.zeros((BATCH, 2), np.float32)], continuous=True)
    _assert_step_close(got, want)


def test_masked_reset_keeps_every_leaf_of_kept_lanes():
    n = 8
    env = TorchVectorEnv(LunarLanderFunctional(), n, max_episode_steps=1000, device="cpu")
    env.reset(seed=0)
    gen = torch.Generator().manual_seed(2)
    for _ in range(2):
        obs, *_ = env.step(env.action_space.sample_torch(gen))
    before = tree_map(torch.clone, env.carry.state)
    mask = np.zeros(n, np.bool_)
    mask[::2] = True
    mobs, _ = env.reset(options={"reset_mask": mask})
    keep = torch.from_numpy(~mask)
    for key, leaf in env.carry.state.items():
        assert leaf.dtype == before[key].dtype, key
        assert torch.equal(leaf[keep], before[key][keep]), key
    for key in BOOL_LEAVES:
        assert env.carry.state[key].dtype == torch.bool
    assert not torch.equal(env.carry.state["terrain"][~keep], before["terrain"][~keep])
    assert torch.equal(mobs[keep], obs[keep])


def test_spaces_options_and_initial_draws():
    func = LunarLanderFunctional()
    assert isinstance(func.action_space, Discrete) and func.action_space.n == 4
    assert func.observation_space.shape == (8,) and func.observation_space.dtype == np.float32
    cont = LunarLanderFunctional({"continuous": True, "gravity": -3.7, "enable_wind": True})
    assert isinstance(cont.action_space, Box) and cont.action_space.shape == (2,)
    assert cont.continuous and cont.enable_wind and cont.get_default_params().gravity == -3.7
    assert isinstance(LunarLanderContinuousFunctional().action_space, Box)
    state = func.initial_batched(torch.Generator().manual_seed(0), 6)
    assert state["body"].shape == (6, 3, 6) and state["terrain"].shape == (6, dyn.CHUNKS)
    assert state["jimp"].shape == (6, 2, 5) and state["cimp"].shape == (6, dyn.N_CONTACTS, 2)
    assert all(state[k].dtype == torch.bool for k in BOOL_LEAVES)
    one = func.initial(torch.Generator().manual_seed(0))
    assert one["body"].shape == (3, 6) and one["done"].shape == ()
    assert func.observation(state, None).shape == (6, 8)


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchVectorEnv(LunarLanderFunctional(), num_envs=4, max_episode_steps=1000)
