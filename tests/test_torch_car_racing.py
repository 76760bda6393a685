"""CarRacing of the port against the JAX package's ``CarRacingFunctional``.

The JAX hooks run vmapped and jitted on the CPU, the port batch-first with
``device="cpu"``, on the same numpy states:

- the constants, equal;
- the reset: JAX's own ``initial`` on a batch of keys against the port's
  ``reset_values`` fed the uniforms that ``initial`` draws from those keys
  (recomputed from the same key splits): tile centres within 1e-4 m
  (JAX's own jitted and eager resets differ by 9.2e-5 m), headings (taken
  modulo 2 pi) within what two centres' tolerance subtends over the gap to
  the next tile, 2e-4 m / gap (the spline packs tiles 0.08-5 m apart;
  JAX's jitted and eager headings differ by 4.8e-5 rad);
- the transition in both action modes, on seeded states on the track, off
  the road and at the playfield's edge, braking at 0.9 and above and below:
  hull, wheels and steering within ``1e-5 * max |JAX| + 1e-6``
  (``tests/test_torch_mujoco_kinematics.py::assert_close``), visits, rewards
  and ``done`` equal;
- the observation: equal to JAX's but at pixels within ``EDGE_MARGIN`` of a
  road edge or a checker line, where the CPU's ``sin``/``cos`` of two
  libraries may flip a pixel (their share is recorded and must stay under
  1 %), and the road mask equal to a sweep of all 300 tiles;
- no reachable pose holds more in-view tiles than the rasterizer's slots.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.box2d import car_dynamics as jax_car
from gymnasium_tpu.envs.box2d import car_racing as jax_host
from gymnasium_tpu.envs.box2d import car_racing_functional as jax_cr
from gymnasium_tpu_torch.envs.box2d import car_dynamics, car_racing_functional
from gymnasium_tpu_torch.envs.box2d.car_racing_functional import (
    NUM_TILES,
    PALETTE,
    PLAYFIELD,
    RASTER_TILES,
    TRACK_WIDTH,
    CarRacingFunctional,
)
from tests.test_torch_mujoco_kinematics import assert_close

N = 16
FLOAT_KEYS = ("hull", "steer_angle", "wheel_omega")


def jax_reset_draws(keys):
    """The U[0, 1) draws JAX's ``initial`` takes from each key, (K, 2, 12)."""

    def draws(key):
        k_alpha, k_rad = jax.random.split(key)
        return jnp.stack([jax.random.uniform(k_alpha, (12,)), jax.random.uniform(k_rad, (12,))])

    return np.asarray(jax.vmap(draws)(keys))


def reset_states(n, seed=0):
    """``n`` port reset states from numpy draws, as numpy."""
    u = np.random.default_rng(seed).uniform(0.0, 1.0, (n, 2, 12)).astype(np.float32)
    return {k: v.numpy() for k, v in CarRacingFunctional().reset_values(torch.from_numpy(u)).items()}


def seeded_states(n=N, seed=1):
    """Reset tracks with the car moved along them: a quarter of the lanes on
    the road, a quarter 8-15 m off it, a quarter on the road at speed, and
    the rest at the playfield's edge heading out. Random speeds, spins,
    wheel speeds, steering and visits; lane 1 one tile short of a lap."""
    rng = np.random.default_rng(seed)
    s = reset_states(n, seed)
    tile = rng.integers(0, NUM_TILES, n)
    lanes = np.arange(n)
    beta = s["betas"][lanes, tile]
    side = np.stack([np.cos(beta), np.sin(beta)], axis=-1)  # across the road
    offset = np.where(lanes % 4 == 1, rng.uniform(8.0, 15.0, n), rng.uniform(-2.0, 2.0, n))
    xy = s["centers"][lanes, tile] + offset[:, None] * side
    edge = lanes % 4 == 3
    xy[edge, 0] = np.sign(xy[edge, 0] + 1e-3) * (PLAYFIELD - rng.uniform(0.0, 0.4, edge.sum()))
    hull = np.zeros((n, 6), np.float32)
    hull[:, :2] = xy
    hull[:, 2] = beta + rng.uniform(-0.5, 0.5, n)
    hull[:, 3:5] = rng.uniform(-10.0, 10.0, (n, 2)) * np.where(lanes % 4 == 2, 4.0, 1.0)[:, None]
    hull[edge, 3] = np.sign(xy[edge, 0]) * 30.0
    hull[:, 5] = rng.uniform(-1.0, 1.0, n)
    s["hull"] = hull.astype(np.float32)
    s["steer_angle"] = rng.uniform(-0.4, 0.4, (n, 2)).astype(np.float32)
    s["wheel_omega"] = rng.uniform(-60.0, 60.0, (n, 4)).astype(np.float32)
    s["visited"] = rng.uniform(0.0, 1.0, (n, NUM_TILES)) < 0.3
    s["visited"][1] = np.arange(NUM_TILES) >= 16  # 284 visited: a new tile ends the lap
    s["hull"][1, :2] = s["centers"][1, 5]
    return s


def actions(mode, n=N, seed=2):
    rng = np.random.default_rng(seed)
    if mode == "discrete":
        return np.arange(n) % 5
    a = np.stack([rng.uniform(-1, 1, n), rng.uniform(0, 1, n), rng.uniform(0, 1, n)], axis=1).astype(np.float32)
    a[::3, 2] = rng.uniform(0.9, 1.0, len(a[::3]))  # a hard brake lock in a third of the lanes
    a[1::3, 2] = 0.0
    return a


def as_torch(s):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in s.items()}


def jax_hooks(mode):
    jfunc = jax_cr.CarRacingFunctional({"continuous": mode == "continuous"})

    def hooks(s, a):
        ns = jfunc.transition(s, a, None)
        return ns, jfunc.reward(s, a, ns, None), jfunc.terminal(ns, None)

    return jfunc, jax.jit(jax.vmap(hooks)), jax.jit(jax.vmap(lambda s: jfunc.observation(s, None)))


def test_constants_match_jax():
    for name in ("SIZE", "ENGINE_POWER", "WHEEL_MOMENT_OF_INERTIA", "FRICTION_LIMIT", "WHEEL_R", "WHEELPOS",
                 "CAR_MASS", "CAR_COM", "CAR_INERTIA"):
        assert getattr(car_dynamics, name) == getattr(jax_car, name), name
    for name in ("STATE_W", "STATE_H", "SCALE", "TRACK_RAD", "PLAYFIELD", "FPS", "TRACK_WIDTH", "GRASS_DIM"):
        assert getattr(car_racing_functional, name) == getattr(jax_host, name), name
    np.testing.assert_array_equal(car_racing_functional.ROAD_COLOR, jax_host.ROAD_COLOR)
    for name in ("NUM_TILES", "CHECKPOINTS", "RASTER_TILES", "WHEEL_RAD"):
        assert getattr(car_racing_functional, name) == getattr(jax_cr, name), name


def test_spaces_match_jax():
    for continuous in (True, False):
        func, jfunc = (cls({"continuous": continuous}) for cls in (CarRacingFunctional, jax_cr.CarRacingFunctional))
        assert func.observation_space.shape == jfunc.observation_space.shape == (96, 96, 3)
        assert func.observation_space.dtype == jfunc.observation_space.dtype == np.uint8
        if continuous:
            np.testing.assert_array_equal(func.action_space.low, jfunc.action_space.low)
            np.testing.assert_array_equal(func.action_space.high, jfunc.action_space.high)
        else:
            assert func.action_space.n == jfunc.action_space.n == 5
    assert CarRacingFunctional({"lap_complete_percent": 0.5}).lap_complete_percent == 0.5


def test_reset_matches_jax_initial():
    keys = jax.random.split(jax.random.PRNGKey(7), 32)
    jfunc = jax_cr.CarRacingFunctional()
    want = {k: np.asarray(v) for k, v in jax.jit(jax.vmap(jfunc.initial))(keys).items()}
    u = torch.from_numpy(jax_reset_draws(keys).copy())
    got = {k: v.numpy() for k, v in CarRacingFunctional().reset_values(u).items()}
    assert got.keys() == want.keys()
    for key, value in got.items():
        assert value.shape == want[key].shape and value.dtype == want[key].dtype, key
    np.testing.assert_allclose(got["centers"], want["centers"], rtol=0, atol=1e-4)
    wrap = lambda d: np.abs(np.angle(np.exp(1j * d.astype(np.float64))))  # noqa: E731
    gap = np.linalg.norm(np.roll(want["centers"], -1, axis=1) - want["centers"], axis=-1)
    heading_tol = 2e-4 / gap
    assert (wrap(got["betas"] - want["betas"]) <= heading_tol).all()
    np.testing.assert_allclose(got["hull"][:, :2], want["hull"][:, :2], rtol=0, atol=1e-4)
    assert (wrap(got["hull"][:, 2] - want["hull"][:, 2]) <= heading_tol[:, 0]).all()
    for key in ("visited", "steer_angle", "wheel_omega", "r", "done"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert np.all(np.linalg.norm(got["centers"] - np.roll(got["centers"], -1, axis=1), axis=-1) < 10.0)


@pytest.mark.parametrize("mode", ["continuous", "discrete"])
def test_transition_reward_terminal_match_jax(request, mode):
    state, action = seeded_states(), actions(mode)
    _, hooks, _ = jax_hooks(mode)
    want_state, want_r, want_done = (jax.tree_util.tree_map(np.asarray, x) for x in hooks(state, action))
    func = CarRacingFunctional({"continuous": mode == "continuous"})
    got_state = func.transition(as_torch(state), torch.from_numpy(action), None)
    got_r = func.reward(as_torch(state), torch.from_numpy(action), got_state, None)
    got_done = func.terminal(got_state, None)
    for key in FLOAT_KEYS:
        assert_close(got_state[key].numpy(), want_state[key], f"{mode} {key}")
        request.node.user_properties.append((f"max_abs_d{key}", float(np.abs(got_state[key].numpy() - want_state[key]).max())))
    for key in ("visited", "centers", "betas", "done"):
        np.testing.assert_array_equal(got_state[key].numpy(), want_state[key], err_msg=key)
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    np.testing.assert_array_equal(got_done.numpy(), want_done)
    assert got_r.dtype == torch.float32 and got_done.dtype == torch.bool
    # the seeded states cover what they are meant to
    lanes = np.arange(N)
    assert want_done[lanes % 4 == 3].all() and (want_r[lanes % 4 == 3] == -100.0).all(), "edge lanes left the field"
    assert want_done[1] and not want_done[(lanes % 4 != 3) & (lanes != 1)].any(), "only lane 1 and the edge lanes end"
    assert (want_r > 0).any(), "no lane visited a new tile"
    if mode == "continuous":
        brake = action[:, 2]
        assert (brake >= 0.9).any() and ((brake > 0) & (brake < 0.9)).any() and (brake == 0).any()


def test_visits_take_the_first_of_equally_near_tiles():
    """A wheel equally near two tiles marks the first, on both sides
    (``jnp.argmin`` and ``torch.min`` both take the first minimum)."""
    state = seeded_states(4)
    for lane in range(4):
        state["centers"][lane, 11] = state["centers"][lane, 10]  # two tiles in one place
        state["hull"][lane] = [*state["centers"][lane, 10], state["betas"][lane, 10], 0.0, 0.0, 0.0]
    state["visited"][:] = False
    act = np.zeros((4, 3), np.float32)
    _, hooks, _ = jax_hooks("continuous")
    want = np.asarray(hooks(state, act)[0]["visited"])
    got = CarRacingFunctional().transition(as_torch(state), torch.from_numpy(act), None)["visited"].numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[:, 11].any()


def brute_road(func, state):
    """The road mask from every one of the 300 tiles, no culling, no slots."""
    tx, ty, _ = func.view_tiles(state)
    a2, bt = func._road_terms(tx, ty)
    return torch.any(a2[:, :, None, :] <= bt[:, :, :, None], dim=1)


def test_observation_matches_jax_outside_edge_pixels(request):
    state = seeded_states(8)
    state["hull"][:, 3:5] *= np.float32(0.5)  # speed bars of several lengths
    _, _, observe = jax_hooks("continuous")
    want = np.asarray(observe(state))
    func = CarRacingFunctional()
    got = func.observation(as_torch(state))
    assert got.shape == (8, 96, 96, 3) and got.dtype == torch.uint8
    got = got.numpy()
    edge = func.edge_pixels(as_torch(state)).numpy()
    differ = (got != want).any(-1)
    request.node.user_properties.append(("edge_pixel_share", float(edge.mean())))
    request.node.user_properties.append(("differing_pixels", int(differ.sum())))
    assert not (differ & ~edge).any(), f"{int((differ & ~edge).sum())} pixels differ away from an edge"
    assert edge.mean() < 0.01
    palette = (got[..., None, :] == PALETTE).all(-1)
    assert palette.any(-1).all(), "a pixel is not one of the palette's colours"
    road = (got == PALETTE[car_racing_functional.ROAD]).all(-1)
    assert road[0::4].mean() > 0.05, "the lanes on the track see road"


def test_road_mask_equals_a_sweep_of_all_tiles():
    func = CarRacingFunctional()
    state = as_torch(seeded_states(8, seed=3))
    road = func.road_mask(state)
    assert road.any() and not road.all()
    assert torch.equal(road, brute_road(func, state))


def test_raster_slots_never_overflow():
    """Across 16 tracks and every along-track pose with the track's heading
    there, and the midpoints between distant tiles (a heading-free disc
    bound), no pose holds more than ``RASTER_TILES`` tiles in view."""
    func = CarRacingFunctional()
    worst = 0
    for seed in range(16):
        s = reset_states(1, seed)
        centers, betas = torch.from_numpy(s["centers"][0]), torch.from_numpy(s["betas"][0])
        poses = {"centers": centers.expand(NUM_TILES, -1, -1),
                 "hull": torch.cat([centers, betas[:, None], torch.zeros(NUM_TILES, 3)], dim=1)}
        worst = max(worst, int(func.view_tiles(poses)[2].sum(dim=1).max()))
        mid = ((centers[::8, None, :] + centers[None, ::8, :]) / 2.0).reshape(-1, 2)
        d2 = ((centers[None, :, :] - mid[:, None, :]) ** 2).sum(-1)
        margin = TRACK_WIDTH * 1.001
        r_disc = math.hypot(15.0 + margin, 22.5 + margin)
        worst = max(worst, int((d2 <= r_disc**2).sum(dim=1).max()))
    assert worst <= RASTER_TILES, f"{worst} tiles in view, more than {RASTER_TILES} slots"


def test_uint8_frames_through_the_vector_env():
    """The spaces batch and hold uint8 frames; a masked reset selects whole
    (96, 96, 3) frames lane by lane; sampled Box actions step the env."""
    from gymnasium_tpu_torch.vector import TorchVectorEnv

    env = TorchVectorEnv(CarRacingFunctional(), 4, max_episode_steps=50, device="cpu")
    assert env.observation_space.shape == (4, 96, 96, 3) and env.observation_space.dtype == np.uint8
    obs, _ = env.reset(seed=0)
    assert obs.dtype == torch.uint8 and bool(env.single_observation_space.contains_torch(obs[0]))
    gen = torch.Generator().manual_seed(1)
    for _ in range(3):
        obs, reward, term, trunc, _ = env.step(env.single_action_space.sample_torch(gen, (4,)))
    assert bool(env.observation_space.contains_torch(obs)) and reward.dtype == torch.float32
    mask = np.array([True, False, True, False])
    kept = {k: v[1::2].clone() for k, v in env.carry.state.items()}
    mobs, _ = env.reset(options={"reset_mask": mask})
    assert torch.equal(mobs[1::2], obs[1::2]) and not torch.equal(mobs[0], obs[0])
    for key, value in kept.items():
        assert torch.equal(env.carry.state[key][1::2], value), key
    assert not env.carry.state["visited"][0::2].any() and mobs.dtype == torch.uint8
