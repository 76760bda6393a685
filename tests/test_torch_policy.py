"""The port's policy network against ``_mlp_apply`` with weights carried from JAX,
and the port's ``entry()``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu.train.ppo import _mlp_apply, _mlp_init
from gymnasium_tpu_torch.entry import entry
from gymnasium_tpu_torch.train.policy import MLP, categorical, mlp_from_jax_params

SIZES = (4, 64, 64, 2)
# bf16 keeps 8 significant bits, and the two frameworks round hidden
# activations at different places, so logits agree to about 1e-2
BF16_TOL = 2e-2


def _carried(seed):
    jparams = _mlp_init(jax.random.PRNGKey(seed), SIZES)
    host = [{"w": np.asarray(p["w"]), "b": np.asarray(p["b"])} for p in jparams]
    x = np.random.default_rng(seed).normal(size=(256, 4)).astype(np.float32)
    return jparams, host, x


@pytest.mark.parametrize(
    "jax_dtype, torch_dtype, tol",
    [(jnp.float32, torch.float32, 1e-5), (jnp.bfloat16, torch.bfloat16, BF16_TOL)],
)
def test_logits_match_mlp_apply(jax_dtype, torch_dtype, tol):
    jparams, host, x = _carried(0)
    # nonzero biases so the bias path is compared too
    for i, p in enumerate(host):
        p["b"] = np.linspace(-0.5, 0.5, p["b"].shape[0], dtype=np.float32) * (i + 1)
    jparams = [{"w": jnp.asarray(p["w"]), "b": jnp.asarray(p["b"])} for p in host]
    want = np.asarray(_mlp_apply(jparams, jnp.asarray(x), jax_dtype))
    with torch.no_grad():
        got = mlp_from_jax_params(host, torch_dtype)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_layout_is_transposed():
    _, host, _ = _carried(1)
    mlp = mlp_from_jax_params(host)
    assert [tuple(layer.weight.shape) for layer in mlp.layers] == [(64, 4), (64, 64), (2, 64)]
    np.testing.assert_array_equal(mlp.layers[0].weight.detach().numpy(), host[0]["w"].T)


def test_init_is_orthogonal_and_seeded():
    a = MLP(SIZES, generator=torch.Generator().manual_seed(0))
    b = MLP(SIZES, generator=torch.Generator().manual_seed(0))
    w = a.layers[1].weight.detach()
    torch.testing.assert_close(w @ w.T, 2.0 * torch.eye(64), rtol=0, atol=1e-4)
    assert torch.equal(w, b.layers[1].weight) and not a.layers[0].bias.any()


def test_categorical_frequencies():
    logits = torch.log(torch.tensor([[0.2, 0.8]])).expand(20000, 2)
    actions = categorical(torch.Generator().manual_seed(0), logits)
    share = actions.double().mean().item()
    assert abs(share - 0.8) < 4 * np.sqrt(0.8 * 0.2 / 20000)


def test_entry_runs_one_step_on_cpu():
    forward_step, (policy, carry, rng) = entry(device="cpu")
    carry, obs, reward, logits, actions = forward_step(policy, carry, rng)
    assert obs.shape == (256, 4) and torch.isfinite(obs).all()
    assert logits.shape == (256, 2) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
    assert set(actions.unique().tolist()) <= {0, 1}
    assert reward.shape == (256,) and torch.equal(reward, torch.ones(256))
    assert int(carry.steps.max()) == 1


def test_entry_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
