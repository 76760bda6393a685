"""PPO over any fixed-shape batch-first FuncEnv: the port's training path.

Counterpart of the JAX package's ``train/ppo.py``. One train step runs
``rollout_steps`` auto-resetting env steps under the current policy, one
value pass over the whole trajectory, GAE, and ``update_epochs`` epochs of
``num_minibatches`` clipped-surrogate updates. Where JAX compiles the step
into one program, the port runs it eagerly on the batch's device: the
rollout is a Python loop over the env step (each HalfCheetah step is one
launch of the fused articulated kernel on a CUDA batch), and nothing in the
step reads a value back to the host; the metrics stay device tensors until
the caller reads them.

Policy matmuls run in ``compute_dtype`` (bf16 by default) with float32 heads
(:class:`~gymnasium_tpu_torch.train.policy.MLP`). The trainer draws its
action noise and minibatch permutations from its own ``torch.Generator``;
the env carry keeps its own generator for the reset draws.

A state placed by :func:`~gymnasium_tpu_torch.parallel.mesh.shard_ppo_state`
trains data-parallel: every rank runs the rollout and GAE on its rows of the
env batch (its rows of the whole batch's action noise), and the advantage
normalisation, the gradient (averaged before the global-norm clip), the
loss and the metrics are reduced over the env axes, so every rank applies
the same update. The time permutations come from the replicated generator,
as in JAX, and no trajectory is gathered.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.functional import (
    EnvCarry,
    FuncEnv,
    make_autoreset_step,
    make_initial_carry,
    vectorize_func_env,
)
from gymnasium_tpu_torch.parallel.shard import active as active_shard
from gymnasium_tpu_torch.train.policy import ActorCritic
from gymnasium_tpu_torch.utils.device import resolve_device
from gymnasium_tpu_torch.utils.draws import gumbel
from gymnasium_tpu_torch.utils.tracing import span
from gymnasium_tpu_torch.wrappers.func import (
    WrappedEnvCarry,
    batch_moments,
    wrap_autoreset_step,
    wrap_initial,
    wrapped_spaces,
)

__all__ = ["PPOConfig", "PPODraws", "PPOState", "init_ppo", "make_train_step", "train"]

LOG_2PI = math.log(2 * math.pi)


class PPOConfig(NamedTuple):
    """Hyperparameters of the PPO loop (the JAX defaults)."""

    num_envs: int = 1024
    rollout_steps: int = 64
    hidden_sizes: tuple[int, ...] = (128, 128)
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    num_minibatches: int = 4
    update_epochs: int = 2
    max_grad_norm: float = 0.5
    max_episode_steps: int | None = 500
    compute_dtype: torch.dtype = torch.bfloat16


class PPOState(NamedTuple):
    """Carried training state.

    ``env_carry`` is an :class:`EnvCarry`, or a :class:`WrappedEnvCarry`
    when the trainer has functional wrappers. ``obs`` is the current
    (post-wrapper) batched observation, ``rng`` the trainer's generator (action
    noise and minibatch permutations). ``policy`` and ``optimizer`` are
    updated in place by a train step.
    """

    policy: ActorCritic
    optimizer: torch.optim.Optimizer
    env_carry: EnvCarry | WrappedEnvCarry
    obs: torch.Tensor
    rng: torch.Generator
    update_count: torch.Tensor


class PPODraws(NamedTuple):
    """Random draws of one train step, injected in place of the trainer's own.

    ``actions``: (T, N, A) action noise, standard Gumbel for Discrete actions
    (A = n) and N(0, 1) for Box actions. ``perms``: (update_epochs, T) time
    permutations, one an epoch. Tests feed the JAX trainer's draws here.
    """

    actions: torch.Tensor
    perms: torch.Tensor


def _obs_size(space: spaces.Space) -> int:
    if not isinstance(space, spaces.Box):
        raise TypeError(f"PPO supports Box observations, got {space}")
    return int(np.prod(space.shape))


def _action_head(space: spaces.Space) -> tuple[int, bool]:
    """``(logits or means, continuous)`` of an action space."""
    if isinstance(space, spaces.Discrete):
        return int(space.n), False
    if isinstance(space, spaces.Box):
        return int(np.prod(space.shape)), True
    raise TypeError(f"PPO supports Discrete or Box actions, got {space}")


def init_ppo(
    func_env: FuncEnv,
    config: PPOConfig,
    seed: int = 0,
    wrappers=(),
    device: str | torch.device | None = None,
) -> tuple[PPOState, Any]:
    """Initialise the policy, the optimizer and the env batch on ``device``
    (CUDA unless the caller asks for the CPU). Returns ``(state, env_params)``.

    ``wrappers`` is a stack of functional wrappers (innermost first), the
    same stack given to :func:`make_train_step`. ``seed`` gives three
    independent streams: the weights (drawn on the CPU, so a seed gives the
    same policy on any device), the trainer's generator and the env carry's.
    """
    device = resolve_device(device)
    obs_space, act_space = wrapped_spaces(func_env, wrappers)
    act_out, continuous = _action_head(act_space)
    init_seed, train_seed, env_seed = np.random.SeedSequence(seed).generate_state(3, np.uint64)

    policy = ActorCritic(
        _obs_size(obs_space),
        config.hidden_sizes,
        act_out,
        continuous,
        config.compute_dtype,
        generator=torch.Generator().manual_seed(int(init_seed)),
    ).to(device)
    optimizer = torch.optim.Adam(policy.parameters(), lr=config.lr)

    batched = vectorize_func_env(func_env, config.num_envs)
    env_params = func_env.get_default_params()
    env_rng = torch.Generator(device=device).manual_seed(int(env_seed))
    env_carry, obs = make_initial_carry(batched, env_rng, env_params)
    if wrappers:
        env_carry, obs = wrap_initial(wrappers, env_rng, env_carry, obs, env_params)

    state = PPOState(
        policy=policy,
        optimizer=optimizer,
        env_carry=env_carry,
        obs=obs.reshape(config.num_envs, -1),
        rng=torch.Generator(device=device).manual_seed(int(train_seed)),
        update_count=torch.zeros((), dtype=torch.int32, device=device),
    )
    return state, env_params


def _sample_action(logits, log_std, noise, continuous: bool):
    """Action and its log-probability from the noise: Gaussian
    ``logits + exp(log_std) * noise``, or the Gumbel-max index of
    ``logits + noise``."""
    if continuous:
        action = logits + torch.exp(log_std) * noise
        return action, _log_prob(logits, log_std, action, continuous)
    action = torch.argmax(logits + noise, dim=-1)
    return action, _log_prob(logits, log_std, action, continuous)


def _log_prob(logits, log_std, action, continuous: bool):
    if continuous:
        return -0.5 * torch.sum(
            torch.square((action - logits) / torch.exp(log_std)) + 2 * log_std + LOG_2PI, dim=-1
        )
    return torch.gather(F.log_softmax(logits, dim=-1), -1, action[..., None]).squeeze(-1)


def _entropy(logits, log_std, continuous: bool):
    if continuous:
        return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))
    probs = F.softmax(logits, dim=-1)
    return -torch.sum(probs * F.log_softmax(logits, dim=-1), dim=-1).mean()


def _loss(policy: ActorCritic, mb, config: PPOConfig):
    """The clipped surrogate, plus ``value_coef`` times the value loss, minus
    ``entropy_coef`` times the entropy, of one minibatch."""
    obs, action, old_logp, _, adv, ret = mb
    logits = policy.pi(obs)
    logp = _log_prob(logits, policy.log_std, action, policy.continuous)
    ratio = torch.exp(logp - old_logp)
    pg1 = ratio * adv
    pg2 = torch.clamp(ratio, 1 - config.clip_eps, 1 + config.clip_eps) * adv
    pg_loss = -torch.minimum(pg1, pg2).mean()
    value = policy.v(obs).squeeze(-1)
    v_loss = 0.5 * torch.square(value - ret).mean()
    ent = _entropy(logits, policy.log_std, policy.continuous)
    return pg_loss + config.value_coef * v_loss - config.entropy_coef * ent


def _clip_by_global_norm(params, max_norm: float) -> None:
    """optax's ``clip_by_global_norm``: gradients scaled by ``max_norm / norm``
    when ``norm >= max_norm``, with no epsilon (``clip_grad_norm_`` divides
    by ``norm + 1e-6``), and no host sync."""
    grads = [p.grad for p in params]
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def _average_gradients(params, shard) -> None:
    """Every gradient replaced by its mean over the env axes' ranks: one
    all-reduce of all of them, flattened."""
    grads = [p.grad for p in params]
    flat = shard.all_reduce(torch.cat([g.reshape(-1) for g in grads])) / shard.count
    offset = 0
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()


def _normalized(adv: torch.Tensor) -> torch.Tensor:
    """``(adv - mean) / (std + 1e-8)`` over every element, the population
    std the root of the variance as ``jnp.std`` takes it; on a sharded
    state, the whole batch's (:func:`~gymnasium_tpu_torch.wrappers.func.batch_moments`)."""
    mean, var, _ = batch_moments(adv.reshape(-1))
    return (adv - mean) / (torch.sqrt(var) + 1e-8)


def _rollout(state: PPOState, env_step, num_steps: int, continuous: bool, noise=None):
    """``num_steps`` env steps under the policy, from ``state``'s carry and
    obs. The action noise comes from ``noise[t]`` when given, else from the
    trainer's generator (inside a sharded step, this rank's rows of either). The value is not computed here: one pass over the
    whole trajectory follows. Returns ``(env_carry, last_obs, traj)``, the
    trajectory a dict of time-major tensors."""
    policy, rng = state.policy, state.rng
    env_carry, obs = state.env_carry, state.obs
    shard = active_shard()
    traj = {"obs": [], "action": [], "logp": [], "reward": [], "done": []}
    for t in range(num_steps):
        with span("ppo.policy"):
            logits = policy.pi(obs)
            # on a shard, this rank's rows of the whole batch's noise
            shape = logits.shape if shard is None else (logits.shape[0] * shard.count, *logits.shape[1:])
            if noise is not None:
                draw = noise[t]
            elif continuous:
                draw = torch.randn(shape, generator=rng, device=logits.device)
            else:
                draw = gumbel(rng, shape, logits.device)
            if shard is not None and draw.shape[0] != logits.shape[0]:
                draw = shard.take(draw)
            action, logp = _sample_action(logits, policy.log_std, draw, continuous)
        with span("ppo.env_step"):
            env_carry, ts = env_step(env_carry, action)
        for key, value in (
            ("obs", obs),
            ("action", action),
            ("logp", logp),
            ("reward", ts.reward),
            ("done", ts.terminated | ts.truncated),
        ):
            traj[key].append(value)
        obs = ts.obs.reshape(obs.shape[0], -1)
    return env_carry, obs, {key: torch.stack(values) for key, values in traj.items()}


def _advantages(policy: ActorCritic, traj, last_obs, config: PPOConfig):
    """One value pass over the T+1 stacked observations, then GAE in a
    reverse loop over time. Returns ``(values, advantages, returns)``."""
    all_values = policy.v(torch.cat([traj["obs"], last_obs[None]])).squeeze(-1)
    values, next_value = all_values[:-1], all_values[-1]
    not_done = (~traj["done"]).to(torch.float32)
    adv = torch.empty_like(values)
    gae = torch.zeros_like(next_value)
    for t in range(values.shape[0] - 1, -1, -1):
        delta = traj["reward"][t] + config.gamma * next_value * not_done[t] - values[t]
        gae = delta + config.gamma * config.gae_lambda * not_done[t] * gae
        adv[t] = gae
        next_value = values[t]
    return values, adv, adv + values


def make_train_step(
    func_env: FuncEnv,
    config: PPOConfig,
    env_params: Any = None,
    wrappers=(),
) -> Callable[..., tuple[PPOState, dict[str, torch.Tensor]]]:
    """Build ``train_step(state, draws=None) -> (state, metrics)``.

    One call is one rollout of ``rollout_steps x num_envs`` env steps plus
    ``update_epochs`` epochs of ``num_minibatches`` PPO updates. The policy
    and the optimizer are updated in place. ``wrappers`` (innermost first)
    must be the stack given to :func:`init_ppo`. ``metrics`` holds
    ``loss``, ``reward_per_step``, ``episodes_finished`` and
    ``mean_value`` as device tensors. ``draws`` (:class:`PPODraws`) replaces
    the trainer's own draws; only tests pass it.
    """
    _, act_space = wrapped_spaces(func_env, wrappers)
    _, continuous = _action_head(act_space)
    batched = vectorize_func_env(func_env, config.num_envs)
    if env_params is None:
        env_params = func_env.get_default_params()

    def make_env_step(batched):
        step = make_autoreset_step(batched, env_params, time_limit=config.max_episode_steps, autoreset=True)
        return wrap_autoreset_step(step, wrappers) if wrappers else step

    env_step = make_env_step(batched)
    sharded_steps: dict = {}  # a shard's env step, over its rows
    t_len = config.rollout_steps
    mb_steps = t_len // config.num_minibatches
    assert mb_steps > 0, "rollout_steps must be >= num_minibatches (minibatches are time slices)"

    def update(state: PPOState, batch, draws: PPODraws | None, shard):
        """``update_epochs`` epochs; each permutes the time axis and takes
        ``num_minibatches`` contiguous time slices of all envs, shaped
        ``(mb_steps, N, ...)``, as the JAX trainer does to keep the env axis
        whole."""
        policy, optimizer = state.policy, state.optimizer
        params = list(policy.parameters())
        losses = []
        for epoch in range(config.update_epochs):
            if draws is not None:
                perm = draws.perms[epoch]
            else:
                perm = torch.randperm(t_len, generator=state.rng, device=state.obs.device)
            shuffled = [x[perm] for x in batch]
            for i in range(config.num_minibatches):
                mb = [x[i * mb_steps : (i + 1) * mb_steps] for x in shuffled]
                optimizer.zero_grad()
                loss = _loss(policy, mb, config)
                with span("ppo.backward"):
                    loss.backward()
                if shard is not None:
                    _average_gradients(params, shard)
                _clip_by_global_norm(params, config.max_grad_norm)
                optimizer.step()
                losses.append(loss.detach())
        return torch.stack(losses).mean()

    def train_step(state: PPOState, draws: PPODraws | None = None):
        # the state's carry says whether it is sharded: one type check of a leaf
        steps = (state.env_carry.env if wrappers else state.env_carry).steps
        shard = None
        if type(steps) is not torch.Tensor:
            from gymnasium_tpu_torch.parallel.mesh import on_shard, shard_of

            shard = shard_of(steps)
        step = env_step
        if shard is not None:
            step = sharded_steps.get(shard)
            if step is None:
                step = sharded_steps[shard] = make_env_step(
                    vectorize_func_env(func_env, config.num_envs, sharding=shard))

        def collect(env_carry, obs):
            """The rollout and GAE from ``(env_carry, obs)``."""
            with torch.no_grad():
                with span("ppo.rollout"):
                    env_carry, last_obs, traj = _rollout(
                        state._replace(env_carry=env_carry, obs=obs), step, t_len, continuous,
                        None if draws is None else draws.actions,
                    )
                with span("ppo.advantages"):
                    values, adv, returns = _advantages(state.policy, traj, last_obs, config)
                    adv_n = _normalized(adv)
            return env_carry, last_obs, (traj, values, adv_n, returns)

        if shard is None:
            env_carry, last_obs, (traj, values, adv_n, returns) = collect(state.env_carry, state.obs)
        else:
            env_carry, last_obs, (traj, values, adv_n, returns) = on_shard(
                collect, shard, state.env_carry, state.obs, dims=(0, None))
        batch = (traj["obs"], traj["action"], traj["logp"], values, adv_n, returns)
        with span("ppo.update"):
            loss = update(state, batch, draws, shard)
        metrics = {
            "loss": loss,
            "reward_per_step": traj["reward"].mean(),
            "episodes_finished": traj["done"].sum(),
            "mean_value": values.mean(),
        }
        if shard is not None:
            # means of equal shards average; the episode count adds up
            summed = shard.all_reduce(torch.stack([metrics[k].to(torch.float32) for k in metrics]))
            metrics = {
                "loss": summed[0] / shard.count,
                "reward_per_step": summed[1] / shard.count,
                "episodes_finished": summed[2].round().to(metrics["episodes_finished"].dtype),
                "mean_value": summed[3] / shard.count,
            }
        new_state = state._replace(env_carry=env_carry, obs=last_obs, update_count=state.update_count + 1)
        return new_state, metrics

    return train_step


def train(
    func_env: FuncEnv,
    config: PPOConfig | None = None,
    num_updates: int = 50,
    seed: int = 0,
    verbose: bool = False,
    wrappers=(),
    device: str | torch.device | None = None,
) -> PPOState:
    """PPO training loop on one device (CUDA unless ``device="cpu"``)."""
    config = config or PPOConfig()
    state, env_params = init_ppo(func_env, config, seed, wrappers, device)
    step = make_train_step(func_env, config, env_params, wrappers)
    for i in range(num_updates):
        state, metrics = step(state)
        if verbose and (i % 10 == 0 or i == num_updates - 1):
            print(
                f"update {i}: loss={float(metrics['loss']):.4f} "
                f"reward/step={float(metrics['reward_per_step']):.4f} "
                f"episodes={int(metrics['episodes_finished'])}"
            )
    return state
