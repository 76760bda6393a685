#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``gymnasium_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds every kernel of the port from ``gymnasium_tpu_torch/csrc/`` with
``nvcc``, drives the port's main path once with every kernel launch count
set to 0 just before and read just after (the CartPole-v1 headline of
``bench.py``: chained ``cartpole_rollout_fused`` blocks of 4096 envs x 2048
steps with bf16 and f32 observations; ``TorchVectorEnv`` at 4096 envs;
``entry()`` at 256 envs), then holds each kernel against its plain PyTorch
version on the card and times both. It prints the card's name and power
limit, one ``{"kernels": [...]}`` line, and last the line
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit code
is 0 only when every phase passed. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

NUM_ENVS = 4096
STEPS_PER_BLOCK = 2048
HEADLINE_BLOCKS = 4
TIME_LIMIT = 500
OBS_ATOL = 2e-5  # the TPU kernel's own test tolerance (tests/ops/test_pallas_rollout.py)
THRESHOLD_BAND = 1e-5  # flags may differ from the twin's only this close to a threshold
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
# Per env-step: 32 float operations of the ODE, reset select and thresholds,
# plus 100 integer operations of the 10 Philox rounds, counted at the float32
# rate (sinf and cosf counted as one operation each).
OPS_PER_ENV_STEP = 32 + 2 + 100


def check(cond, message: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rollout_bytes(n: int, s: int, obs_dtype: torch.dtype) -> int:
    """Bytes the fused rollout must move: each input read once, each output written once."""
    obs_elem = torch.finfo(obs_dtype).bits // 8
    per_step = n * (4 * obs_elem + 4 + 1 + 1)
    inputs = n * (16 + 4 + 1)
    finals = n * (16 + 4 + 1)
    return s * per_step + inputs + finals


def rollout_bound_ms(n: int, s: int, obs_dtype: torch.dtype) -> tuple[float, str]:
    bytes_ms = rollout_bytes(n, s, obs_dtype) / HBM_BYTES_PER_S * 1e3
    ops_ms = n * s * OPS_PER_ENV_STEP / FP32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def compare_rollout_with_twin(state, steps, prev_done, seed, out, time_limit=TIME_LIMIT):
    """Hold a float32-obs kernel rollout against the plain step function, step by step.

    Every step s of the twin starts from the kernel's own state before it
    (``obs[s-1]``, or the input state) and its done flags, with the shared
    draws, so one ULP of ``sinf`` cannot grow over a chaotic trajectory.
    Returns ``(max_abs_err, near_threshold_lanes, flag_mismatches)``; raises
    if obs differ by more than ``OBS_ATOL``, rewards differ at all, or flags
    differ away from a threshold.
    """
    from gymnasium_tpu_torch.envs.dynamics.cartpole import CartPoleParams
    from gymnasium_tpu_torch.ops.cartpole_rollout import cartpole_draws, cartpole_step_reference

    p = CartPoleParams()
    fstate, fsteps, fdone, obs, reward, term, trunc = out
    s_len, n = reward.shape
    check(obs.dtype == torch.float32, "step comparison needs float32 obs")
    done = term | trunc
    prev_state = torch.cat([state[None], obs[:-1]])  # (S, 4, N)
    prev_dn = torch.cat([prev_done.reshape(1, n), done[:-1]])  # (S, N)
    # step counters follow from the done flags alone
    prev_sp = torch.empty((s_len, n), dtype=torch.int32, device=obs.device)
    sp = steps.reshape(n)
    for s in range(s_len):
        prev_sp[s] = sp
        sp = torch.where(prev_dn[s], 0, sp + 1).to(torch.int32)

    bits, u = cartpole_draws(seed, s_len, n, obs.device)
    flat = lambda x: x.reshape(s_len * n)  # noqa: E731
    t_state, t_steps, t_done, t_reward, t_term, t_trunc = cartpole_step_reference(
        prev_state.permute(1, 0, 2).reshape(4, s_len * n),
        flat(prev_sp),
        flat(prev_dn),
        flat(bits),
        u.permute(1, 0, 2).reshape(4, s_len * n),
        time_limit,
        p,
    )
    t_obs = t_state.reshape(4, s_len, n).permute(1, 0, 2)
    max_err = float((t_obs - obs).abs().max())
    check(max_err <= OBS_ATOL, f"obs differ from the twin by {max_err} > {OBS_ATOL}")
    check(torch.equal(t_reward.reshape(s_len, n), reward), "reward differs from the twin")

    x, th = obs[:, 0, :], obs[:, 2, :]
    near = ((x.abs() - np.float32(p.x_threshold)).abs() < THRESHOLD_BAND) | (
        (th.abs() - np.float32(p.theta_threshold)).abs() < THRESHOLD_BAND
    )
    mismatch = (t_term.reshape(s_len, n) != term) | (t_trunc.reshape(s_len, n) != trunc)
    check(not (mismatch & ~near).any(), "flags differ from the twin away from a threshold")
    # the kernel's flags follow from its own obs exactly, near a threshold too
    crossed = (x.abs() > np.float32(p.x_threshold)) | (th.abs() > np.float32(p.theta_threshold))
    check(torch.equal(term, crossed & ~prev_dn), "terminated is not the threshold test of obs")
    want_trunc = ~term & (t_steps.reshape(s_len, n) >= time_limit) & ~prev_dn
    check(torch.equal(trunc, want_trunc), "truncated is not steps >= time_limit")
    check(torch.equal(fstate, obs[-1]), "final state is not the last obs")
    check(torch.equal(fsteps, sp), "final steps disagree with the step counters")
    check(torch.equal(fdone, done[-1]), "final done is not the last step's done")
    return max_err, int(near.sum()), int(mismatch.sum())


def run_headline(dev) -> tuple[dict, dict]:
    """bench.py's headline: chained fused-rollout blocks, bf16 then f32 obs.

    Returns env-steps/s over all blocks and each block's milliseconds, both
    on the host clock, by obs type. Each block ends in a synchronise, so a
    first-use cost shows in the block that pays it.
    """
    from gymnasium_tpu_torch.ops import cartpole_rollout_fused

    rates, block_ms = {}, {}
    for obs_dtype in (torch.bfloat16, torch.float32):
        carry = (
            torch.zeros((4, NUM_ENVS), device=dev),
            torch.zeros(NUM_ENVS, dtype=torch.int32, device=dev),
            torch.zeros(NUM_ENVS, dtype=torch.bool, device=dev),
        )
        torch.cuda.synchronize()
        times = []
        for block in range(HEADLINE_BLOCKS):
            start = time.perf_counter()
            out = cartpole_rollout_fused(*carry, block, STEPS_PER_BLOCK, obs_dtype=obs_dtype)
            carry = out[:3]
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
        obs, reward, term, trunc = out[3:]
        check(obs.shape == (STEPS_PER_BLOCK, 4, NUM_ENVS) and obs.dtype == obs_dtype, "obs shape")
        check(bool(torch.isfinite(obs.float()).all()), "headline obs not finite")
        check(bool(((reward == 0) | (reward == 1)).all()), "headline reward not in {0, 1}")
        check(bool((term | trunc).any()), "no episode ended in a headline block")
        rates[str(obs_dtype)] = NUM_ENVS * STEPS_PER_BLOCK * HEADLINE_BLOCKS / (sum(times) / 1e3)
        block_ms[str(obs_dtype)] = times
    return rates, block_ms


def run_vector_env(dev) -> float:
    from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional
    from gymnasium_tpu_torch.vector import TorchVectorEnv

    env = TorchVectorEnv(CartPoleFunctional(), NUM_ENVS, max_episode_steps=TIME_LIMIT, device=dev)
    obs, _ = env.reset(seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(4):
        actions = env.single_action_space.sample_torch(gen, (NUM_ENVS,))
        obs, reward, term, trunc, _ = env.step(actions)
    check(bool(torch.isfinite(obs).all()), "vector env obs not finite")

    mask = np.zeros(NUM_ENVS, np.bool_)
    mask[::2] = True
    keep = torch.from_numpy(~mask).to(dev)
    state_before = env.carry.state.clone()
    mobs, _ = env.reset(options={"reset_mask": mask})
    check(torch.equal(env.carry.state[keep], state_before[keep]), "partial reset moved kept lanes")
    check(torch.equal(mobs[keep], obs[keep]), "partial reset changed kept lanes' obs")
    check(not bool(env.carry.steps[~keep].any()), "partial reset left step counters")

    torch.cuda.synchronize()
    start = time.perf_counter()
    carry, traj = env.rollout(256)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    done = traj.terminated | traj.truncated
    check(bool(torch.isfinite(traj.obs).all()), "rollout obs not finite")
    check(torch.equal(traj.reward[1:] == 0, done[:-1]), "reward is not 0 exactly after a done")
    check(int(carry.steps.max()) <= TIME_LIMIT, "a step counter passed the time limit")
    return NUM_ENVS * 256 / seconds


def run_entry() -> None:
    from gymnasium_tpu_torch.entry import entry

    forward_step, (policy, carry, rng) = entry()
    for _ in range(4):
        carry, obs, reward, logits, actions = forward_step(policy, carry, rng)
    torch.cuda.synchronize()
    check(logits.shape == (256, 2) and bool(torch.isfinite(logits).all()), "entry logits")
    check(bool(((actions == 0) | (actions == 1)).all()), "entry actions not in {0, 1}")
    check(bool(torch.isfinite(obs).all()), "entry obs not finite")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from gymnasium_tpu_torch.ops import build
    from gymnasium_tpu_torch.ops import cartpole_rollout as cr

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}", flush=True)
    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")

    start = time.perf_counter()
    built = build.build(build.KERNELS)
    print(f"build: {time.perf_counter() - start:.2f} s for {sorted(built)}", flush=True)
    for name, info in built.items():
        print(f"nvcc {name} ({info['seconds']:.2f} s):\n{info['log'].strip()}", flush=True)

    # -- main path, with every launch count at 0 just before -----------------
    cr.launches = 0
    headline, block_ms = run_headline(dev)
    vec_rate = run_vector_env(dev)
    run_entry()
    torch.cuda.synchronize()
    main_launches = cr.launches
    check(main_launches == 2 * HEADLINE_BLOCKS, f"cartpole_rollout_fused launched {main_launches} times")
    print(f"main path: cartpole_rollout_fused launches={main_launches}; host-clock env-steps/s "
          f"headline bf16={headline['torch.bfloat16']:.0f} f32={headline['torch.float32']:.0f}, "
          f"TorchVectorEnv.rollout(256)={vec_rate:.0f}", flush=True)
    for name, times in block_ms.items():
        print(f"headline host-clock ms per block, obs={name}: "
              + " ".join(f"{t:.4f}" for t in times), flush=True)

    # -- the kernel against its plain version --------------------------------
    n, s, seed = NUM_ENVS, STEPS_PER_BLOCK, 0
    args = (
        torch.zeros((4, n), device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev),
        torch.zeros(n, dtype=torch.bool, device=dev),
    )
    f32 = cr.cartpole_rollout_fused(*args, seed, s)
    torch.cuda.synchronize()
    max_err, near, mismatch = compare_rollout_with_twin(*args, seed, f32)
    print(f"kernel vs twin (f32 obs, N={n}, S={s}): max_abs_err={max_err:.3e} "
          f"near-threshold lanes={near} flag mismatches there={mismatch}", flush=True)

    bf16 = cr.cartpole_rollout_fused(*args, seed, s, obs_dtype=torch.bfloat16)
    check(torch.equal(bf16[3], f32[3].to(torch.bfloat16)), "bf16 obs are not the f32 obs rounded")
    for i in (0, 1, 2, 4, 5, 6):
        check(torch.equal(bf16[i], f32[i]), f"bf16 run output {i} differs from the f32 run")
    again = cr.cartpole_rollout_fused(*args, seed, s)
    other = cr.cartpole_rollout_fused(*args, seed + 1, s)
    check(all(torch.equal(a, b) for a, b in zip(again, f32)), "same seed, different bits")
    check(not torch.equal(other[3], f32[3]), "seed + 1 gave the same trajectory")
    print("kernel: bf16 obs equal the f32 obs rounded; deterministic per seed", flush=True)

    # -- times ----------------------------------------------------------------
    results = {}
    for obs_dtype in (torch.float32, torch.bfloat16):
        ms = cuda_ms(lambda: cr.cartpole_rollout_fused(*args, seed, s, obs_dtype=obs_dtype), 20, 3)
        bound, bound_by = rollout_bound_ms(n, s, obs_dtype)
        results[obs_dtype] = (ms, bound, bound_by)
        print(f"cartpole_rollout_fused obs={obs_dtype}: {ms:.4f} ms/call, "
              f"{n * s / ms * 1e3:.4e} env-steps/s, bound {bound:.4f} ms ({bound_by}), "
              f"{bound / ms:.2%} of bound", flush=True)
    plain_ms = cuda_ms(lambda: cr.cartpole_rollout_reference(*args, seed, s), 1, 1)
    print(f"cartpole_rollout_reference (plain twin) on the card: {plain_ms:.2f} ms/call", flush=True)

    ms, bound, bound_by = results[torch.float32]
    bf16_ms, bf16_bound, _ = results[torch.bfloat16]
    kernels = [
        {
            "name": "cartpole_rollout_fused",
            "route": "cuda",
            "source": "gymnasium_tpu_torch/csrc/cartpole_rollout.cu",
            "replaces": "gymnasium_tpu/ops/pallas_rollout.py:143",
            "launches": main_launches,
            "max_abs_err": max_err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": None,
            "bf16_obs_ms": bf16_ms,
            "bf16_obs_bound_ms": bf16_bound,
            "ok": True,
        }
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    result = {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
