"""Vector-level NormalizeObservation (copy of the JAX package's
``wrappers/vector/stateful_observation.py``).

Parity surface: reference gymnasium/wrappers/vector/stateful_observation.py:27.
The batch is read on the host and normalised there, so the observations
come back as numpy float32, as JAX's do over its device env.
"""

from __future__ import annotations

import numpy as np

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.utils.device import to_host
from gymnasium_tpu_torch.vector.vector_env import VectorEnv, VectorObservationWrapper
from gymnasium_tpu_torch.wrappers.utils import RunningMeanStd

__all__ = ["NormalizeObservation"]


class NormalizeObservation(VectorObservationWrapper):
    """Running mean/std normalization over the batched observations."""

    def __init__(self, env: VectorEnv, epsilon: float = 1e-8):
        super().__init__(env)

        from gymnasium_tpu_torch import logger
        from gymnasium_tpu_torch.vector.vector_env import AutoresetMode

        if "autoreset_mode" not in self.env.metadata:
            logger.warn(
                f"{self} is missing `autoreset_mode` data. Assuming that the vector environment it follows the `NextStep` autoreset api or autoreset is disabled. Read https://farama.org/Vector-Autoreset-Mode for more details."
            )
        else:
            assert self.env.metadata["autoreset_mode"] in {AutoresetMode.NEXT_STEP}

        assert env.single_observation_space.shape is not None
        # float32, unlike the float64 single-env wrapper — the reference's
        # own asymmetry (reference wrappers/vector/stateful_observation.py:82)
        self.single_observation_space = spaces.Box(
            low=-np.inf,
            high=np.inf,
            shape=env.single_observation_space.shape,
            dtype=np.float32,
        )
        from gymnasium_tpu_torch.vector.utils import batch_space

        self.observation_space = batch_space(self.single_observation_space, self.num_envs)

        self.obs_rms = RunningMeanStd(
            shape=self.single_observation_space.shape,
            dtype=self.single_observation_space.dtype,
        )
        self.epsilon = epsilon
        self._update_running_mean = True

    @property
    def update_running_mean(self) -> bool:
        """Freeze/continue updating the running statistics."""
        return self._update_running_mean

    @update_running_mean.setter
    def update_running_mean(self, setting: bool):
        self._update_running_mean = setting

    def reset(self, *, seed=None, options=None):
        """Partial resets would corrupt the running statistics; refuse them
        (reference wrappers/vector/stateful_observation.py:115-121)."""
        assert (
            options is None
            or "reset_mask" not in options
            or np.all(options["reset_mask"])
        )
        return super().reset(seed=seed, options=options)

    def observations(self, observations):
        """Normalize the batch with the current statistics."""
        observations = to_host(observations)
        if self._update_running_mean:
            self.obs_rms.update(observations)
        return (
            (observations - self.obs_rms.mean) / np.sqrt(self.obs_rms.var + self.epsilon)
        ).astype(np.float32)
