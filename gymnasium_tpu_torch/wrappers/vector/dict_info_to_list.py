"""DictInfoToList: convert the batched dict-info format to a list of dicts
(copy of the JAX package's ``wrappers/vector/dict_info_to_list.py``).

Parity surface: reference gymnasium/wrappers/vector/dict_info_to_list.py:15.
A tensor in the info is read back to the host before it is split by env.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from gymnasium_tpu_torch.utils.device import batch_to_host
from gymnasium_tpu_torch.vector.vector_env import VectorEnv, VectorWrapper

__all__ = ["DictInfoToList"]


class DictInfoToList(VectorWrapper):
    """Turn ``{"k": array, "_k": mask}`` infos into per-env dicts."""

    def __init__(self, env: VectorEnv):
        super().__init__(env)

    def step(self, actions):
        observation, reward, terminated, truncated, infos = self.env.step(actions)
        list_info = self._convert_info_to_list(infos)
        return observation, reward, terminated, truncated, list_info

    def reset(self, *, seed: int | list[int] | None = None, options: dict[str, Any] | None = None):
        obs, infos = self.env.reset(seed=seed, options=options)
        list_info = self._convert_info_to_list(infos)
        return obs, list_info

    def _check_lengths(self, infos: dict, key: str, value) -> None:
        """Malformed vector infos fail loudly (reference
        dict_info_to_list.py:122-148): values and their ``_key`` masks must
        span the whole batch."""
        if not isinstance(value, (dict, list)):
            assert isinstance(value, np.ndarray)
        assert len(value) == self.num_envs, (
            f"Expects {value} to have length equal to the num-envs ({self.num_envs}), actual length is {len(value)}"
        )
        binary_key = f"_{key}"
        if binary_key in infos:
            assert len(infos[binary_key]) == self.num_envs, (
                f"Expects {infos[binary_key]} to have length equal to the num-envs ({self.num_envs}), actual length is {len(infos[binary_key])}"
            )

    def _convert_info_to_list(self, vector_infos: dict) -> list[dict[str, Any]]:
        vector_infos = batch_to_host(vector_infos)
        list_info = [{} for _ in range(self.num_envs)]
        for key, value in vector_infos.items():
            if key.startswith("_"):
                continue
            mask = vector_infos.get(f"_{key}", np.ones(self.num_envs, dtype=bool))
            if isinstance(value, dict):
                # nested dict: recurse per sub-key
                nested = self._convert_nested(value, mask)
                self._check_lengths(vector_infos, key, nested)
                for i, has in enumerate(mask):
                    if has:
                        list_info[i][key] = nested[i]
            else:
                self._check_lengths(vector_infos, key, value)
                for i, has in enumerate(mask):
                    if has:
                        list_info[i][key] = value[i]
        return list_info

    def _convert_nested(self, nested_info: dict, mask) -> list[dict[str, Any]]:
        out = [{} for _ in range(self.num_envs)]
        for key, value in nested_info.items():
            if key.startswith("_"):
                continue
            submask = nested_info.get(f"_{key}", mask)
            if isinstance(value, dict):
                sub = self._convert_nested(value, submask)
                self._check_lengths(nested_info, key, sub)
                for i, has in enumerate(submask):
                    if has:
                        out[i][key] = sub[i]
            else:
                self._check_lengths(nested_info, key, value)
                for i, has in enumerate(submask):
                    if has:
                        out[i][key] = value[i]
        return out
