"""Fused CartPole rollout: the CUDA kernel's wrapper and its plain PyTorch twin.

Counterpart of the JAX package's ``ops/pallas_rollout.py::cartpole_rollout_fused``
with the same signature, the same ``(4, N)`` struct-of-arrays layout and the
same outputs. On a CUDA tensor :func:`cartpole_rollout_fused` launches the
hand-written kernel of ``csrc/cartpole_rollout.cu`` (one thread per env, the
step loop inside the kernel, state in registers; see the source for its
design and bound). On a CPU tensor it runs :func:`cartpole_rollout_reference`,
a torch loop over :func:`cartpole_step_reference` that draws the same
Philox4x32-10 numbers, bit for bit, in int64 tensor arithmetic.
"""

from __future__ import annotations

import ctypes

import torch

from gymnasium_tpu_torch.envs.dynamics.cartpole import CartPoleParams, integrate, is_terminated
from gymnasium_tpu_torch.envs.phys2d.cartpole import reset_values
from gymnasium_tpu_torch.ops import build

__all__ = [
    "cartpole_rollout_fused",
    "cartpole_rollout_reference",
    "cartpole_step_reference",
    "cartpole_draws",
    "launches",
]

#: Number of kernel launches made by :func:`cartpole_rollout_fused`.
launches = 0

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_OBS_DTYPES = (torch.float32, torch.bfloat16)


def _philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding uint32 values.

    A product of two uint32 values can pass 2**63 and wrap in int64, but the
    wrapped 64-bit pattern still holds the true product's high and low words.
    """
    for _ in range(10):
        p0 = c0 * _PHILOX_M[0]
        p1 = c2 * _PHILOX_M[1]
        c0, c1, c2, c3 = (
            ((p1 >> 32) & _MASK32) ^ c1 ^ k0,
            p1 & _MASK32,
            ((p0 >> 32) & _MASK32) ^ c3 ^ k1,
            p0 & _MASK32,
        )
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def cartpole_draws(seed: int, num_steps: int, n: int, device=None):
    """The kernel's random numbers for steps ``0..num_steps-1`` of ``n`` envs.

    Returns ``(action_bits, reset_u)``: ``(S, N)`` int64 in {0, 1} and
    ``(S, 4, N)`` float32 U[0, 1) on a 2**-24 grid. Block ``(env, step, 0, 0)``
    under key ``(seed, 0)``; the action is bit 0 of word 0, reset component i
    the top 24 bits of word i.
    """
    env = torch.arange(n, dtype=torch.int64, device=device).expand(num_steps, n)
    step = torch.arange(num_steps, dtype=torch.int64, device=device)[:, None].expand(num_steps, n)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = _philox4x32_10(env, step, zero, zero, int(seed) & _MASK32, 0)
    action_bits = words[0] & 1
    reset_u = torch.stack([(w >> 8).to(torch.float32) * 2.0**-24 for w in words], dim=1)
    return action_bits, reset_u


def cartpole_step_reference(
    state: torch.Tensor,
    steps: torch.Tensor,
    prev_done: torch.Tensor,
    action_bits: torch.Tensor,
    reset_u: torch.Tensor,
    time_limit: int = 500,
    params: CartPoleParams | None = None,
):
    """One step of the fused rollout on ``(4, N)`` state, from given draws.

    Returns ``(state, steps, done, reward, terminated, truncated)``.
    """
    params = params or CartPoleParams()
    force = torch.where((action_bits & 1) == 1, params.force_mag, -params.force_mag)
    next_state = integrate(torch, state.T, force.to(torch.float32), params, euler=True).T
    new_state = torch.where(prev_done, reset_values(reset_u, params), next_state)
    new_steps = torch.where(prev_done, 0, steps + 1).to(torch.int32)
    terminated = is_terminated(torch, new_state.T, params) & ~prev_done
    truncated = ~terminated & (new_steps >= time_limit) & ~prev_done
    reward = torch.where(prev_done, 0.0, 1.0).to(torch.float32)
    return new_state, new_steps, terminated | truncated, reward, terminated, truncated


def _check_inputs(state, steps, prev_done, seed, num_steps, obs_dtype):
    if not isinstance(state, torch.Tensor) or state.dim() != 2 or state.shape[0] != 4:
        raise ValueError(f"state must be a (4, N) tensor, got {getattr(state, 'shape', type(state))}")
    n = state.shape[1]
    if n < 1:
        raise ValueError("state must hold at least one env")
    if state.dtype != torch.float32 or not state.is_contiguous():
        raise ValueError(f"state must be contiguous float32, got {state.dtype}")
    for name, x, dtype in (("steps", steps, torch.int32), ("prev_done", prev_done, torch.bool)):
        if not isinstance(x, torch.Tensor) or x.numel() != n or x.shape not in ((n,), (1, n)):
            raise ValueError(f"{name} must have shape ({n},) or (1, {n}), got {getattr(x, 'shape', type(x))}")
        if x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}, got {x.dtype}")
        if x.device != state.device:
            raise ValueError(f"{name} is on {x.device}, state on {state.device}")
    if not isinstance(seed, int) or not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed must be a python int in the int32 range, got {seed!r}")
    if not isinstance(num_steps, int) or num_steps < 1:
        raise ValueError(f"num_steps must be a positive int, got {num_steps!r}")
    if obs_dtype not in _OBS_DTYPES:
        raise ValueError(f"obs_dtype must be one of {_OBS_DTYPES}, got {obs_dtype}")


def cartpole_rollout_reference(
    state: torch.Tensor,
    steps: torch.Tensor,
    prev_done: torch.Tensor,
    seed: int,
    num_steps: int,
    time_limit: int = 500,
    params: CartPoleParams | None = None,
    obs_dtype: torch.dtype = torch.float32,
):
    """Plain PyTorch version of :func:`cartpole_rollout_fused` (same outputs)."""
    _check_inputs(state, steps, prev_done, seed, num_steps, obs_dtype)
    n = state.shape[1]
    action_bits, reset_u = cartpole_draws(seed, num_steps, n, state.device)
    st, sp, done = state, steps.reshape(n), prev_done.reshape(n)
    obs, reward, term, trunc = [], [], [], []
    for s in range(num_steps):
        st, sp, done, r, te, tr = cartpole_step_reference(
            st, sp, done, action_bits[s], reset_u[s], time_limit, params
        )
        obs.append(st.to(obs_dtype))
        reward.append(r)
        term.append(te)
        trunc.append(tr)
    return (
        st,
        sp,
        done,
        torch.stack(obs),
        torch.stack(reward),
        torch.stack(term),
        torch.stack(trunc),
    )


def _library() -> ctypes.CDLL:
    lib = build.load("cartpole_rollout")
    fn = lib.cartpole_rollout_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 10 + [i32] * 5 + [ptr, ptr]
        fn.restype = i32
    return lib


def cartpole_rollout_fused(
    state: torch.Tensor,
    steps: torch.Tensor,
    prev_done: torch.Tensor,
    seed: int,
    num_steps: int,
    time_limit: int = 500,
    params: CartPoleParams | None = None,
    obs_dtype: torch.dtype = torch.float32,
):
    """Run ``num_steps`` autoresetting CartPole steps under a uniform random
    policy as one kernel launch.

    Args:
        state: ``(4, N)`` float32, struct-of-arrays env states.
        steps: ``(N,)`` or ``(1, N)`` int32 step counters.
        prev_done: ``(N,)`` or ``(1, N)`` bool done mask.
        seed: python int in the int32 range; distinct seeds give distinct streams.
        num_steps: trajectory length ``S``.
        time_limit: truncation horizon (CartPole-v1: 500).
        params: dynamics constants.
        obs_dtype: ``torch.float32`` or ``torch.bfloat16`` observations.

    Returns:
        ``(final_state, final_steps, final_done, obs, reward, terminated,
        truncated)`` with ``obs`` of shape ``(S, 4, N)`` and the per-step
        outputs ``(S, N)``.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    on the current stream without synchronising, or raises.
    """
    if state.device.type == "cpu":
        return cartpole_rollout_reference(
            state, steps, prev_done, seed, num_steps, time_limit, params, obs_dtype
        )
    _check_inputs(state, steps, prev_done, seed, num_steps, obs_dtype)
    if state.device.type != "cuda":
        raise ValueError(f"cartpole_rollout_fused runs on cuda or cpu tensors, got {state.device}")
    params = params or CartPoleParams()
    n, s, dev = state.shape[1], num_steps, state.device

    final_state = torch.empty((4, n), dtype=torch.float32, device=dev)
    final_steps = torch.empty((n,), dtype=torch.int32, device=dev)
    final_done = torch.empty((n,), dtype=torch.bool, device=dev)
    obs = torch.empty((s, 4, n), dtype=obs_dtype, device=dev)
    reward = torch.empty((s, n), dtype=torch.float32, device=dev)
    term = torch.empty((s, n), dtype=torch.bool, device=dev)
    trunc = torch.empty((s, n), dtype=torch.bool, device=dev)

    # Derived constants are formed in double, as the plain version's python
    # floats are, and rounded to float32 once.
    constants = (ctypes.c_float * 10)(
        params.gravity,
        params.masspole,
        params.masspole + params.masscart,
        params.masspole * params.length,
        params.length,
        params.force_mag,
        params.tau,
        params.theta_threshold,
        params.x_threshold,
        params.reset_bound,
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().cartpole_rollout_launch(
            state.data_ptr(), steps.data_ptr(), prev_done.data_ptr(),
            final_state.data_ptr(), final_steps.data_ptr(), final_done.data_ptr(),
            obs.data_ptr(), reward.data_ptr(), term.data_ptr(), trunc.data_ptr(),
            n, s, seed, time_limit, int(obs_dtype == torch.bfloat16),
            constants, stream,
        )
    if rc != 0:
        raise RuntimeError(f"cartpole_rollout kernel launch failed with cudaError {rc}")
    global launches
    launches += 1
    return final_state, final_steps, final_done, obs, reward, term, trunc
