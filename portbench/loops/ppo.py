"""The ``ppo`` loop: one trainer repeats ``train_step(state)`` and reads each
step's loss to the host, as a logging loop does; that read times the step.

Set-up builds the trainer (``init_ppo``, ``make_train_step``) with the
benchmark's weights, drawn from the seed, and drives it through its first
``checked_steps`` train steps by the window's own call. The window runs
train steps until ``seconds`` have passed. For the check it records the
checked steps and the train step in which lanes that never terminated
reach the time limit, truncate and reset (in the window, or run on to after
a window too short to hold it): the program's state before each, what its
rollout carried at every env step, its loss, the first gradient the
optimizer took and each leaf's change. Recording keeps references to
tensors the program made anyway, and copies the parameters and the
optimizer's moments before and after the recorded step.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from portbench import check
from portbench import trace as tracing
from portbench.drive import Cell, report_times, setup_mark, sync
from portbench.reference import ppo as ref_ppo


class Recorder:
    """Wraps the trainer's ``_rollout`` (a module function it calls by name)
    so that, while ``on``, each env step's returned carry and time step and
    the rollout's trajectory are kept: one Python call an env step, no
    device work."""

    def __init__(self, module):
        self.module, self.inner = module, module._rollout
        self.on, self.steps, self.traj = False, [], None
        module._rollout = self.rollout

    def rollout(self, state, env_step, num_steps, continuous, noise=None):
        if not self.on:
            return self.inner(state, env_step, num_steps, continuous, noise)

        def step(carry, action):
            new, ts = env_step(carry, action)
            self.steps.append((new, ts))
            return new, ts

        carry, obs, traj = self.inner(state, step, num_steps, continuous, noise)
        self.traj = traj
        return carry, obs, traj

    def remove(self):
        self.module._rollout = self.inner


class Handle:
    def __init__(self, state, step, recorder, weights, seeds, names):
        self.state, self.step, self.recorder = state, step, recorder
        self.weights, self.seeds, self.names = weights, seeds, names
        self.done, self.records, self.change_checked = 0, [], None


def _crossing(cell: Cell) -> int:
    """The train step (counted from 0) in which lanes that never terminated
    reach the time limit."""
    return (cell.config["max_episode_steps"] - 1) // cell.traffic["ppo"]["rollout_steps"]


def _params(h: Handle) -> dict:
    return {k: p.detach().clone() for k, p in h.state.policy.named_parameters()}


def _moments(h: Handle):
    opt = h.state.optimizer
    state = {h.names[id(p)]: opt.state[p] for g in opt.param_groups for p in g["params"] if opt.state[p]}
    if not state:
        return None, 0
    steps = {int(s["step"]) for s in state.values()}
    return {k: (s["exp_avg"].clone(), s["exp_avg_sq"].clone()) for k, s in state.items()}, steps.pop()


def _train_step(h: Handle, label: str | None) -> float:
    """One train step by the window's call, its loss read to the host;
    recorded under ``label`` unless that is ``None``."""
    if label is None:
        h.state, metrics = h.step(h.state)
        h.done += 1
        return float(metrics["loss"])
    state = h.state
    env_carry = state.env_carry
    before = {"params": _params(h), "moments": _moments(h), "carry": env_carry,
              "train_rng": state.rng.get_state(), "env_rng": _env(env_carry).rng.get_state()}
    first = {}

    def first_update(opt, args, kwargs):
        if not first:
            for group in opt.param_groups:
                for p in group["params"]:
                    first[h.names[id(p)]] = opt.state[p]["exp_avg"].clone()

    hook = state.optimizer.register_step_post_hook(first_update)
    h.recorder.on, h.recorder.steps = True, []
    h.state, metrics = h.step(state)
    loss = float(metrics["loss"])
    h.recorder.on = False
    hook.remove()
    h.done += 1
    h.records.append({"label": label, "before": before, "steps": h.recorder.steps, "traj": h.recorder.traj,
                      "loss": loss, "first": first, "after": _params(h)})
    return loss


def _env(carry):
    return carry.env if hasattr(carry, "wrappers") else carry


def setup(cell: Cell) -> Handle:
    from portbench import program

    setup_mark(cell, "program imported")
    state, step = program.trainer(cell.config, cell.traffic, cell.seed, cell.device)
    setup_mark(cell, "trainer built")
    policy = state.policy
    shapes = {k: tuple(p.shape) for k, p in policy.named_parameters()}
    weights = ref_ppo.initial_weights(shapes, int(np.random.SeedSequence([cell.seed, 11]).generate_state(1)[0]),
                                      cell.device)
    with torch.no_grad():
        for k, p in policy.named_parameters():
            p.copy_(weights[k])
    seeds = (state.rng.initial_seed(), _env(state.env_carry).rng.initial_seed())
    names = {id(p): k for k, p in policy.named_parameters()}
    h = Handle(state, step, Recorder(program.ppo), weights, seeds, names)
    for i in range(cell.traffic["checked_steps"]):
        _train_step(h, str(i + 1))
        setup_mark(cell, f"train step {i + 1}")
    h.change_checked = {k: p.detach() - weights[k] for k, p in policy.named_parameters()}
    sync(cell.device)
    return h


def window(cell: Cell, h: Handle) -> dict:
    crossing = _crossing(cell)
    times = []
    start = last = time.perf_counter()
    while last - start < cell.seconds:
        _train_step(h, "x" if h.done == crossing else None)
        now = time.perf_counter()
        times.append(now - last)
        last = now
    window_s = last - start
    report_times("step", times)
    per_step = cell.traffic["ppo"]["rollout_steps"] * cell.config["num_envs"]
    metrics = {"train_env_steps_per_s": len(times) * per_step / window_s}
    if len(times) >= 10:
        metrics["train_step_ms_p90"] = 1e3 * statistics.quantiles(times, n=10, method="inclusive")[-1]
    return {"units": len(times), "window_s": window_s, "metrics": metrics}


def trace(cell: Cell, h: Handle) -> dict:
    count = cell.traffic["trace_steps"]

    def unit():
        _train_step(h, None)

    steps = count * cell.traffic["ppo"]["rollout_steps"]
    traced = tracing.capture(unit, count, cell.context(steps, count), lambda: sync(cell.device))
    return {"units": count, "trace": traced}


def keep(cell: Cell, h: Handle) -> dict:
    """The recorded steps as plain tensors (running on to the step that
    crosses the time limit where the window ended before it), the
    program's state freed."""
    crossing = _crossing(cell)
    while h.done <= crossing and not any(r["label"] == "x" for r in h.records):
        _train_step(h, "x" if h.done == crossing else None)
    wrappers = cell.traffic["ppo"]["wrappers"]
    runs = [_plain(r, wrappers) for r in h.records]
    kept = {"runs": runs, "weights": h.weights, "seeds": h.seeds, "change_checked": h.change_checked,
            "last_checked": str(cell.traffic["checked_steps"])}
    h.recorder.remove()
    h.records, h.state, h.step = [], None, None
    return kept


def _plain(record: dict, wrappers: list) -> dict:
    """One recorded train step as plain tensors: the env states ``q``, ``qd``
    (T + 1, before each step and after the last), each env step's reward as
    the trainer got it and the scale the program divided it by (the return
    statistics' std after the step), its flags (``done``) and actions; the
    loss, the first gradient the optimizer took (from its first moment
    before and after its first update), each leaf's change; and, for a step
    judged from the program's state, ``start``."""
    before, steps, traj = record["before"], record["steps"], record["traj"]
    carries = [before["carry"]] + [c for c, _ in steps]
    i_obs = wrappers.index("NormalizeObservation") if "NormalizeObservation" in wrappers else None
    i_rew = wrappers.index("NormalizeReward") if "NormalizeReward" in wrappers else None
    one = torch.ones((), device=steps[0][1].reward.device)
    scale = [torch.sqrt(c.wrappers[i_rew].rms.var + ref_ppo.REWARD_EPS) if i_rew is not None else one
             for c, _ in steps]
    moments, adam_steps = before["moments"]
    b1 = ref_ppo.ADAM_BETAS[0]
    grad1 = {k: (m1 - (b1 * moments[k][0] if moments else 0.0)) / (1 - b1) for k, m1 in record["first"].items()}
    out = {
        "label": record["label"],
        "q": torch.stack([_env(c).state["qpos"] for c in carries]),
        "qd": torch.stack([_env(c).state["qvel"] for c in carries]),
        "prev_done0": _env(before["carry"]).prev_done,
        "env_rng": before["env_rng"],
        "reward": torch.stack([ts.reward for _, ts in steps]), "reward_scale": torch.stack(scale),
        "done": traj["done"], "action": traj["action"],
        "loss": record["loss"], "grad1": grad1,
        "change": {k: record["after"][k] - v for k, v in before["params"].items()},
        "start": None,
    }
    if record["label"] == "x":
        c0 = before["carry"]
        o_rms = c0.wrappers[i_obs] if i_obs is not None else None
        r_state = c0.wrappers[i_rew] if i_rew is not None else None
        n = out["q"].shape[1]
        out["start"] = {
            "params": before["params"], "adam": moments, "adam_steps": adam_steps,
            "q": out["q"][0], "qd": out["qd"][0], "steps": _env(c0).steps, "prev_done": out["prev_done0"],
            "obs_rms": (o_rms.mean, o_rms.var, o_rms.count) if o_rms is not None else (0.0, 1.0, 1.0),
            "ret_rms": ((r_state.rms.mean, r_state.rms.var, r_state.rms.count) if r_state is not None
                        else (0.0, 1.0, 1.0)),
            "acc": r_state.accumulated if r_state is not None else torch.zeros(n, device=out["q"].device),
            "train_rng": before["train_rng"],
        }
    return out


def readings(cell: Cell, kept: dict, control: bool = False) -> dict:
    return check.train_readings(cell.task(), cell.config, cell.traffic["ppo"], kept, cell.seed, control)
