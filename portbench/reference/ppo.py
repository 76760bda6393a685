"""Plain PyTorch reference of the PPO train step the ``ppo`` traffic drives.

The published algorithm as the traffic file states it: a Gaussian tanh-MLP
policy and value net (hidden layers in the stated compute dtype, float32
heads), ``rollout_steps`` auto-resetting env steps with next-step
autoreset and a time limit, the running normalisation of observations and
of rewards by the discounted return's std, one value pass, GAE, the
advantages normalised over the batch, ``update_epochs`` epochs of
``num_minibatches`` clipped-surrogate updates over time slices, a global
gradient-norm clip and Adam.

Its trajectory's env states are the program's, handed in step by step
(each is judged against the float64 engine by :mod:`portbench.check`);
from them it works out again the observations, rewards and flags of the
task (:mod:`portbench.reference.physics`), the wrappers' statistics, the
policy's actions from the trainer generator's draws, the advantages, the
losses and the updates.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LOG_2PI = math.log(2 * math.pi)
OBS_EPS, REWARD_GAMMA, REWARD_EPS, RMS_COUNT0 = 1e-8, 0.99, 1e-8, 1e-4
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8
WRAPPERS = {"NormalizeObservation", "NormalizeReward", "EpisodeStatistics"}


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` saturated to float8 e4m3's range, rounded to it and widened to
    bfloat16: the control's operands, one precision below bfloat16."""
    return x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(torch.bfloat16)


def mlp(layers, x, dtype, control: bool = False):
    """Hidden layers in ``dtype``, the last layer's product of ``dtype``
    operands in float32."""
    cast = (lambda t: fp8(t)) if control else (lambda t: t.to(dtype))
    h = cast(x)
    for i, (w, b) in enumerate(layers):
        if i == len(layers) - 1:
            return F.linear(h.float(), cast(w).float(), b)
        h = torch.tanh(F.linear(h, cast(w)) + b.to(dtype))
        if control:
            h = fp8(h)
    raise ValueError("an MLP needs a layer")


class Rms:
    """Running mean and population variance, merged batch by batch (Chan)."""

    def __init__(self, mean, var, count):
        self.mean, self.var, self.count = mean, var, count

    @classmethod
    def fresh(cls, shape, device):
        return cls(torch.zeros(shape, device=device), torch.ones(shape, device=device),
                   torch.tensor(RMS_COUNT0, device=device))

    def update(self, batch):
        mean, var, n = batch.mean(0), batch.var(0, correction=0), batch.shape[0]
        delta = mean - self.mean
        tot = self.count + n
        self.mean = self.mean + delta * n / tot
        self.var = (self.var * self.count + var * n + delta * delta * self.count * n / tot) / tot
        self.count = tot


class Reference:
    """The trainer and its wrappers from a ``start``: ``params`` (by leaf),
    ``adam`` (each leaf's moments, or ``None`` before the first update) and
    ``adam_steps``, the env state ``q``, ``qd``, ``steps``, ``prev_done``,
    the wrappers' ``obs_rms`` and ``ret_rms`` (each ``(mean, var, count)``)
    and return accumulator ``acc``, and ``train_rng``, the trainer
    generator's state."""

    def __init__(self, task, config: dict, settings: dict, start: dict, device, control: bool = False):
        unknown = set(settings["wrappers"]) - WRAPPERS
        if unknown:
            raise ValueError(f"the reference trainer has no wrappers {sorted(unknown)}")
        self.task, self.s, self.control = task, settings, control
        self.limit = config["max_episode_steps"]
        self.norm_obs = "NormalizeObservation" in settings["wrappers"]
        self.norm_reward = "NormalizeReward" in settings["wrappers"]
        self.dtype = getattr(torch, settings["compute_dtype"])
        self.params = {k: v.detach().clone().float().requires_grad_(True) for k, v in start["params"].items()}
        adam = start["adam"] or {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in self.params.items()}
        self.adam = {k: (m.clone(), v.clone()) for k, (m, v) in adam.items()}
        self.adam_steps = int(start["adam_steps"])
        self.rng = torch.Generator(device=device)
        self.rng.set_state(start["train_rng"])
        self.q, self.qd = start["q"], start["qd"]
        self.steps, self.prev_done = start["steps"].long(), start["prev_done"]
        self.obs_rms, self.ret_rms = Rms(*start["obs_rms"]), Rms(*start["ret_rms"])
        self.acc = start["acc"]
        self.obs = self.normalized(self.raw_obs(self.q, self.qd))

    @classmethod
    def from_seeds(cls, task, config: dict, settings: dict, weights: dict, seeds: tuple[int, int], device,
                   control: bool = False):
        """The trainer's start from the benchmark's weights and the seeds of
        the program's trainer and env generators: the initial reset drawn
        from the env seed, the observation statistics of its observation."""
        n = config["num_envs"]
        env_rng = torch.Generator(device=device).manual_seed(seeds[1])
        q, qd = task.reset(task.reset_draws(env_rng, n, device))
        obs_rms = Rms.fresh(task.observation(q[:1], qd[:1]).shape[1:], device)
        obs_rms.update(task.observation(q.double(), qd.double()).float())
        ret_rms = Rms.fresh((), device)
        start = {"params": weights, "adam": None, "adam_steps": 0, "q": q, "qd": qd,
                 "steps": torch.zeros(n, dtype=torch.int64, device=device),
                 "prev_done": torch.zeros(n, dtype=torch.bool, device=device),
                 "obs_rms": (obs_rms.mean, obs_rms.var, obs_rms.count),
                 "ret_rms": (ret_rms.mean, ret_rms.var, ret_rms.count),
                 "acc": torch.zeros(n, device=device),
                 "train_rng": torch.Generator(device=device).manual_seed(seeds[0]).get_state()}
        return cls(task, config, settings, start, device, control)

    def layers(self, head: str):
        p, count = self.params, 0
        while f"{head}.layers.{count}.weight" in p:
            count += 1
        return [(p[f"{head}.layers.{i}.weight"], p[f"{head}.layers.{i}.bias"]) for i in range(count)]

    def raw_obs(self, q, qd):
        return self.task.observation(q.double(), qd.double()).float()

    def normalized(self, raw):
        if not self.norm_obs:
            return raw
        return (raw - self.obs_rms.mean) / torch.sqrt(self.obs_rms.var + OBS_EPS)

    def env_step(self, action, q1, qd1):
        """One auto-resetting step of the batch to the program's next state
        ``(q1, qd1)``: the task's reward and flags, the wrappers."""
        task = self.task
        reward = task.reward(self.q.double(), q1.double(), qd1.double(), action.double()).float()
        reward = torch.where(self.prev_done, 0.0, reward)
        steps = torch.where(self.prev_done, 0, self.steps + 1)
        term = task.terminated(q1, qd1) & ~self.prev_done
        trunc = ~term & (steps >= self.limit) & ~self.prev_done
        self.q, self.qd, self.steps, self.prev_done = q1, qd1, steps, term | trunc
        raw = self.raw_obs(q1, qd1)
        if self.norm_obs:
            self.obs_rms.update(raw)
        if self.norm_reward:
            self.acc = self.acc * REWARD_GAMMA * (1.0 - term.float()) + reward
            self.ret_rms.update(self.acc)
            reward = reward / torch.sqrt(self.ret_rms.var + REWARD_EPS)
        return self.normalized(raw), reward, term | trunc

    def train_step(self, q_next, qd_next):
        """One train step over the program's next env states ``q_next[t]``,
        ``qd_next[t]``; returns its loss, each leaf's first gradient as the
        optimizer took it (after the clip), the flags ``(T, N)``, and the
        loss's scale: the mean over minibatches of the sum of its terms'
        magnitudes, which stays away from 0 where the loss crosses it."""
        s, p = self.s, self.params
        pi, v, log_std = self.layers("pi"), self.layers("v"), p["log_std"]
        traj = {"obs": [], "action": [], "logp": [], "reward": [], "done": []}
        with torch.no_grad():
            for t in range(s["rollout_steps"]):
                mean = mlp(pi, self.obs, self.dtype, self.control)
                noise = torch.randn(mean.shape, generator=self.rng, device=mean.device)
                action = mean + torch.exp(log_std) * noise
                logp = -0.5 * torch.sum(torch.square((action - mean) / torch.exp(log_std)) + 2 * log_std + LOG_2PI, -1)
                obs, reward, done = self.env_step(action, q_next[t], qd_next[t])
                for key, value in (("obs", self.obs), ("action", action), ("logp", logp), ("reward", reward),
                                   ("done", done)):
                    traj[key].append(value)
                self.obs = obs
            traj = {k: torch.stack(vals) for k, vals in traj.items()}
            values_all = mlp(v, torch.cat([traj["obs"], self.obs[None]]), self.dtype, self.control).squeeze(-1)
            values, next_value = values_all[:-1], values_all[-1]
            not_done = (~traj["done"]).float()
            adv = torch.empty_like(values)
            gae = torch.zeros_like(next_value)
            for t in range(values.shape[0] - 1, -1, -1):
                delta = traj["reward"][t] + s["gamma"] * next_value * not_done[t] - values[t]
                gae = delta + s["gamma"] * s["gae_lambda"] * not_done[t] * gae
                adv[t] = gae
                next_value = values[t]
            returns = adv + values
            flat = adv.reshape(-1)
            adv_n = (adv - flat.mean()) / (torch.sqrt(flat.var(correction=0)) + 1e-8)
        batch = (traj["obs"], traj["action"], traj["logp"], adv_n, returns)
        t_len = s["rollout_steps"]
        mb = t_len // s["num_minibatches"]
        losses, scales, first_grad = [], [], None
        for _ in range(s["update_epochs"]):
            perm = torch.randperm(t_len, generator=self.rng, device=adv.device)
            shuffled = [x[perm] for x in batch]
            for i in range(s["num_minibatches"]):
                obs, action, old_logp, adv_mb, ret = (x[i * mb:(i + 1) * mb] for x in shuffled)
                mean = mlp(pi, obs, self.dtype, self.control)
                logp = -0.5 * torch.sum(torch.square((action - mean) / torch.exp(log_std)) + 2 * log_std + LOG_2PI, -1)
                ratio = torch.exp(logp - old_logp)
                clipped = torch.clamp(ratio, 1 - s["clip_eps"], 1 + s["clip_eps"])
                pg = -torch.minimum(ratio * adv_mb, clipped * adv_mb).mean()
                value = mlp(v, obs, self.dtype, self.control).squeeze(-1)
                v_loss = 0.5 * torch.square(value - ret).mean()
                entropy = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))
                loss = pg + s["value_coef"] * v_loss - s["entropy_coef"] * entropy
                scales.append((pg.abs() + s["value_coef"] * v_loss + s["entropy_coef"] * entropy.abs()).detach())
                grads = torch.autograd.grad(loss, list(p.values()))
                norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
                scale = torch.where(norm < s["max_grad_norm"], 1.0, s["max_grad_norm"] / norm)
                grads = [g * scale for g in grads]
                if first_grad is None:
                    first_grad = {k: g.detach().clone() for k, g in zip(p, grads)}
                self.adam_update(grads)
                losses.append(loss.detach())
        return torch.stack(losses).mean(), first_grad, traj["done"], float(torch.stack(scales).mean())

    @torch.no_grad()
    def adam_update(self, grads):
        """Adam, with bias correction."""
        self.adam_steps += 1
        b1, b2 = ADAM_BETAS
        bc1, bc2 = 1 - b1 ** self.adam_steps, 1 - b2 ** self.adam_steps
        for (key, param), g in zip(self.params.items(), grads):
            m, v2 = self.adam[key]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v2.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (torch.sqrt(v2) / math.sqrt(bc2)).add_(ADAM_EPS)
            param.addcdiv_(m, denom, value=-self.s["lr"] / bc1)


def initial_weights(shapes: dict, seed: int, device) -> dict:
    """The benchmark's initial weights, drawn on ``device`` from ``seed`` in
    one call: each matrix normal with variance 2 / fan_in (He), biases and
    ``log_std`` zero."""
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = torch.randn(sum(math.prod(s) for s in shapes.values() if len(s) == 2), generator=gen, device=device)
    out, used = {}, 0
    for name, shape in shapes.items():
        if len(shape) == 2:
            size = math.prod(shape)
            out[name] = draws[used:used + size].reshape(shape) * math.sqrt(2.0 / shape[1])
            used += size
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def leaf_difference(program: dict, reference: dict) -> tuple[float, str]:
    """The widest norm of a leaf's difference between the program and the
    reference, over the larger of that leaf's reference norm and the
    median leaf's. Returns ``(gap, leaf)``."""
    ref = {k: float(torch.linalg.vector_norm(v.float())) for k, v in reference.items()}
    median = float(np.median(list(ref.values())))
    gaps = {k: float(torch.linalg.vector_norm(program[k].float() - reference[k].float())) / max(ref[k], median, 1e-30)
            if k in program else float("inf") for k in reference}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def leaf_gap(program: dict, reference: dict, keep=None) -> tuple[float, str]:
    """The widest gap between a leaf's norm in the program and in the
    reference, over the larger of that leaf's reference norm and the median
    leaf's; ``keep`` limits the leaves compared. Returns ``(gap, leaf)``."""
    names = [k for k in reference if keep is None or keep[k]]
    ref = {k: float(torch.linalg.vector_norm(reference[k].float())) for k in names}
    # a leaf the program never reported reads as infinitely far
    prog = {k: float(torch.linalg.vector_norm(program[k].float())) if k in program else float("inf") for k in names}
    median = float(np.median(list(ref.values())))
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst
