"""The one-launch autoreset of the Box2D-class functionals against the
two-launch form, on the CPU twin.

``make_autoreset_step`` calls an env's ``autoreset_transition`` when it has
one: LunarLander (discrete, continuous, wind) and BipedalWalker (normal,
hardcore) make the transition and the reset's settle tick in one call of
their planar build, on inputs chosen lane by lane. Hiding the hook (an
instance attribute ``None``) gives the transition, the reset and a select of
the outputs. Both forms run from one seed with one action stream, and every
state leaf, observation, reward, flag and step counter must be the same
bits, and the generators' states equal after the run (the same draws in the
same order); both start from one initial carry. A quarter of the lanes start in ``chip_smoke.crash_pose``, so natural
terminations occur beside the time limit's, and every lane autoresets more
than once. The twin costs about 0.09 s a lander call and 0.5 s a walker
call on the CPU, so the walker runs fewer steps at a shorter limit.

The sharded lander rollout on 2 gloo ranks (``tests/torch_parallel_scenarios.py``,
started when the module's first test runs, so the ranks work beside it)
holds the hook's rows to the unsharded rollout and that to the hidden form.
"""

import numpy as np
import pytest
import torch

from chip_smoke import crash_pose
from gymnasium_tpu_torch.envs.box2d import BipedalWalkerFunctional
from gymnasium_tpu_torch.envs.box2d.lunar_lander import LunarLanderFunctional
from gymnasium_tpu_torch.functional import make_autoreset_step, make_initial_carry, tree_map, vectorize_func_env
from gymnasium_tpu_torch.parallel import launch
from tests import torch_parallel_scenarios as sc

N = 64
# (class, options, steps, time limit): every lane resets twice
CASES = {
    "lander": (LunarLanderFunctional, {}, 8, 2),
    "lander_continuous": (LunarLanderFunctional, {"continuous": True}, 8, 2),
    "lander_wind": (LunarLanderFunctional, {"enable_wind": True}, 8, 2),
    "walker": (BipedalWalkerFunctional, {}, 4, 1),
    "walker_hardcore": (BipedalWalkerFunctional, {"hardcore": True}, 4, 1),
}
RANKS = 2
RANKS_TIMEOUT_S = 120


@pytest.fixture(scope="module", autouse=True)
def lander_ranks():
    """The gloo group of the sharded lander case, started first; none outlives the module."""
    ranks = launch.start(sc.lander_rollouts, RANKS, device="cpu", timeout=RANKS_TIMEOUT_S)
    yield ranks
    ranks.kill()


def leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def actions(func, rng: np.random.Generator) -> torch.Tensor:
    if isinstance(func, BipedalWalkerFunctional):
        return torch.from_numpy(rng.uniform(-1, 1, (N, 4)).astype(np.float32))
    if func.continuous:
        return torch.from_numpy(rng.uniform(-1, 1, (N, 2)).astype(np.float32))
    return torch.from_numpy(rng.integers(0, 4, N))


def run(func, start, steps: int, limit: int, hidden: bool):
    """``steps`` autoreset steps of ``func`` at ``N`` envs from ``start``
    (a carry and its generator's state); each step's leaves."""
    batched = vectorize_func_env(func, N)
    if hidden:
        batched.autoreset_transition = None
    carry, rng_state = start
    rng = torch.Generator()
    rng.set_state(rng_state)
    carry = carry._replace(rng=rng)
    step = make_autoreset_step(batched, None, time_limit=limit)
    draws = np.random.default_rng(8)
    out = []
    for _ in range(steps):
        carry, ts = step(carry, actions(func, draws))
        out.append(leaves((carry.state, carry.steps, carry.prev_done, tuple(ts[:4]))))
    return out, rng.get_state()


@pytest.mark.parametrize("case", list(CASES))
def test_one_launch_autoreset_equals_two_launches_in_every_bit(case):
    cls, options, steps, limit = CASES[case]
    func = cls(options)
    rng = torch.Generator().manual_seed(7)
    carry, _ = make_initial_carry(vectorize_func_env(func, N), rng)
    start = (carry._replace(state=crash_pose(carry.state)), rng.get_state())
    fused, fused_rng = run(func, start, steps, limit, hidden=False)
    plain, plain_rng = run(func, start, steps, limit, hidden=True)
    for s, (got, want) in enumerate(zip(fused, plain)):
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert same_bits(a, b), f"{case}: step {s}, leaf {i} differs"
    assert torch.equal(fused_rng, plain_rng), f"{case}: the generators drew differently"
    # every lane reset more than once, and some ended on their own
    terminated = torch.stack([step[-2] for step in fused])
    resets = torch.stack([step[-5] for step in fused[:-1]]).sum(dim=0)  # a done before the last step
    assert bool((resets >= 2).all()), f"{case}: a lane reset fewer than twice"
    assert int(terminated.sum()) >= N // 4, f"{case}: too few natural terminations"


def test_sharded_lander_rollout_equals_unsharded_in_every_bit(lander_ranks):
    """Two gloo ranks: each rank's rows of the sharded rollout (the hook
    drawing the whole batch's draws and keeping its rows) are the unsharded
    rollout's, and that equals the hidden hook's, in every bit."""
    results = lander_ranks.join()
    per = sc.LANDER_ENVS // RANKS
    for out in results:
        rows = slice(out["sharded"]["shard"] * per, (out["sharded"]["shard"] + 1) * per)
        for key, want in out["unsharded"]["traj"].items():
            np.testing.assert_array_equal(out["sharded"]["traj"][key].view(np.uint8), want[:, rows].view(np.uint8))
            np.testing.assert_array_equal(out["hidden"]["traj"][key].view(np.uint8), want.view(np.uint8))
        for key, want in out["unsharded"]["state"].items():
            np.testing.assert_array_equal(out["sharded"]["state"][key].view(np.uint8), want[rows].view(np.uint8))
            np.testing.assert_array_equal(out["hidden"]["state"][key].view(np.uint8), want.view(np.uint8))
        assert out["unsharded"]["traj"]["truncated"].any() and out["unsharded"]["traj"]["terminated"].dtype == bool
    assert sorted(out["sharded"]["shard"] for out in results) == list(range(RANKS))
