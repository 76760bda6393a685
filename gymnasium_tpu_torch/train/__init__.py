"""Training components of the torch port (the policy network so far)."""

from gymnasium_tpu_torch.train.policy import MLP, categorical, mlp_from_jax_params

__all__ = ["MLP", "categorical", "mlp_from_jax_params"]
