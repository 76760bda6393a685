"""Native (C++) host-side runtime components (own copy of the JAX package's
``native/``).

A batched tabular-MDP stepper for
:class:`~gymnasium_tpu_torch.vector.native_tabular.NativeTabularVectorEnv`:
host code that replaces a numpy loop, not a device kernel. It builds with
``g++`` on first use into the package's ``build/`` directory
(:mod:`~gymnasium_tpu_torch.native.build`) and falls back to numpy when no
compiler is present.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

__all__ = ["tabular_library", "TabularBatchStepper"]


@functools.lru_cache(maxsize=1)
def tabular_library() -> ctypes.CDLL | None:
    """The compiled tabular stepper, or None when unavailable."""
    from gymnasium_tpu_torch.native.build import build_library

    lib = build_library("gymtpu_tabular", ["tabular.cpp"])
    if lib is None:
        return None
    f64 = ctypes.POINTER(ctypes.c_double)
    i32 = ctypes.POINTER(ctypes.c_int32)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.tabular_step_batch.argtypes = [
        f64, i32, f64, u8,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32, i32, f64, f64, u8, ctypes.c_int32,
    ]
    lib.tabular_rollout_batch.argtypes = [
        f64, i32, f64, u8,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32, u8, i32, f64, i32, f64, u8,
        ctypes.c_int32, ctypes.c_int32,
    ]
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class TabularBatchStepper:
    """Steps N tabular envs through the native kernel (Python fallback)."""

    def __init__(self, model):
        # densify + keep C-contiguous copies pinned for the library
        self.probs = np.ascontiguousarray(model.probs, dtype=np.float64)
        self.next_state = np.ascontiguousarray(model.next_state, dtype=np.int32)
        self.reward = np.ascontiguousarray(model.reward, dtype=np.float64)
        self.term = np.ascontiguousarray(model.terminated, dtype=np.uint8)
        self.S, self.A, self.K = self.probs.shape
        self.lib = tabular_library()

    @property
    def is_native(self) -> bool:
        """Whether the compiled kernel is in use."""
        return self.lib is not None

    def step(self, states: np.ndarray, actions: np.ndarray, uniforms: np.ndarray):
        """Advance all envs one step; ``states`` is updated in place."""
        n = len(states)
        out_reward = np.empty(n, dtype=np.float64)
        out_term = np.empty(n, dtype=np.uint8)
        if self.lib is not None:
            self.lib.tabular_step_batch(
                _ptr(self.probs, ctypes.c_double),
                _ptr(self.next_state, ctypes.c_int32),
                _ptr(self.reward, ctypes.c_double),
                _ptr(self.term, ctypes.c_uint8),
                self.S, self.A, self.K,
                _ptr(states, ctypes.c_int32),
                _ptr(np.ascontiguousarray(actions, dtype=np.int32), ctypes.c_int32),
                _ptr(np.ascontiguousarray(uniforms, dtype=np.float64), ctypes.c_double),
                _ptr(out_reward, ctypes.c_double),
                _ptr(out_term, ctypes.c_uint8),
                n,
            )
            return out_reward, out_term
        # vectorized numpy fallback with identical sampling semantics
        p = self.probs[states, actions]  # (n, K)
        k = np.argmax(np.cumsum(p, axis=-1) > uniforms[:, None], axis=-1)
        idx = (states.copy(), actions, k)  # snapshot before the in-place update
        states[:] = self.next_state[idx]
        return self.reward[idx], self.term[idx]
