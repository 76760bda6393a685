"""What decides ``correct``: the program's outputs held against the
reference (:mod:`portbench.reference`), and each number beside its limit.

The env steps are judged one at a time: each checked step's outputs
against the reference task's step, in float64, from the state the program
carried into it, under the same actions and reset draws, which the
reference makes again from the env generator's state. ``collect`` judges
steps of the kept blocks. ``train`` judges steps of the recorded train
steps the same way, and the trainer by the reference trainer
(:mod:`portbench.reference.ppo`), which takes the program's env states
(judged here) as its trajectory and works out everything else again: each
step's loss (its gap over the loss's scale), the first gradient the optimizer took (the gap of its norm
and the norm of its difference, by the worst leaf), and each leaf's change.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import ppo as ref_ppo

QUANTILE = 0.99


def _row_gaps(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each row's widest relative gap, an element's gap taken over its
    reference magnitude plus its column's root mean square over the finite
    rows (a lane whose state has blown up reads as one wide row)."""
    prog, ref = prog.double().reshape(prog.shape[0], -1), ref.double().reshape(ref.shape[0], -1)
    finite = torch.isfinite(ref).all(1, keepdim=True)
    rms = torch.sqrt(torch.mean(torch.where(finite, ref * ref, 0.0), 0) * ref.shape[0] / finite.sum().clamp(min=1))
    scale = rms + 1e-3 * torch.median(rms) + 1e-30
    gap = (prog - ref).abs() / (ref.abs() + scale)
    return torch.nan_to_num(gap, nan=np.inf).amax(1)


def _p99(gaps: list) -> float:
    return float(torch.quantile(torch.cat(gaps).float().clamp(max=1e30), QUANTILE))


def reference_step(task, q, qd, action, draws, prev_done, dtype):
    """The reference's auto-resetting step in ``dtype`` from ``(q, qd)``:
    the observation of the next state (the reset's on lanes done a step
    before) and the reward (0 on those lanes), with the state it was
    worked out from."""
    q, qd, action = q.to(dtype), qd.to(dtype), action.to(dtype)
    q1, qd1 = task.step(q, qd, action)
    rq, rqd = task.reset(draws, dtype)
    lane = prev_done[:, None]
    obs = task.observation(torch.where(lane, rq, q1), torch.where(lane, rqd, qd1))
    reward = torch.where(prev_done, 0.0, task.reward(q, q1, qd1, action))
    return obs, reward, (q, q1, qd1, action)


def step_gaps(task, q, qd, action, draws, prev_done, judged_obs, judged_reward, judged_q=None, reward_scale=1.0):
    """Each row's observation gap and reward gap of one judged step against
    the float64 reference; the judged reward is the reference's over
    ``reward_scale``."""
    obs, reward, (q64, q1, qd1, a64) = reference_step(task, q, qd, action, draws, prev_done, torch.float64)
    if judged_q is not None:  # the healthy bonus read at the judged torso height
        reward = torch.where(prev_done, 0.0, task.reward(q64, q1, qd1, a64, judged_q.double()))
    return _row_gaps(judged_obs, obs), _row_gaps(judged_reward[:, None], (reward / reward_scale)[:, None])


def collect_readings(task, config: dict, blocks: list, steps_per_block: int, seed: int, control=None) -> dict:
    """The ``collect`` numbers over the kept ``blocks``, each ``(gen_state,
    carry_before, traj)``. With ``control`` (a dtype), the judged outputs
    are not the program's but the reference's in that dtype."""
    limit = config["max_episode_steps"]
    chooser = np.random.default_rng([seed, 7])
    obs_gaps, reward_gaps, flag_errors, rows, reset_rows = [], [], 0, 0, 0
    for gen_state, carry, traj in blocks:
        obs, reward = traj.obs, traj.reward
        term, trunc = traj.terminated, traj.truncated
        device, (length, n) = obs.device, reward.shape
        done = term | trunc
        # the drawn steps, the block's first, and the first step after a done
        picked = set(chooser.choice(length, size=min(steps_per_block, length), replace=False).tolist()) | {0}
        after = torch.nonzero(done.any(1)).flatten().tolist()
        if after and after[0] + 1 < length:
            picked.add(after[0] + 1)
        gen = torch.Generator(device=device)
        gen.set_state(gen_state)
        steps, prev_done = carry.steps.long(), carry.prev_done
        for i in range(max(picked) + 1):
            action = task.random_actions(gen, n, device)
            draws = task.reset_draws(gen, n, device)
            steps = torch.where(prev_done, 0, steps + 1)
            if i in picked:
                q, qd = task.state_from_carry(carry.state) if i == 0 else task.state_from_obs(obs[i - 1].double())
                judged = (obs[i], reward[i], term[i], trunc[i])
                if control is not None:
                    c_obs, c_reward, _ = reference_step(task, q, qd, action, draws, prev_done, control)
                    pq, pqd = task.state_from_obs(c_obs.double())
                    c_term = task.terminated(pq, pqd) & ~prev_done
                    judged = (c_obs.float(), c_reward.float(), c_term, ~c_term & (steps >= limit) & ~prev_done)
                pq, pqd = task.state_from_obs(judged[0].double())
                o, r = step_gaps(task, q, qd, action, draws, prev_done, judged[0], judged[1], pq)
                obs_gaps.append(o)
                reward_gaps.append(r)
                # the flags against the judged step's own next state
                term_exp = task.terminated(pq, pqd) & ~prev_done
                trunc_exp = ~term_exp & (steps >= limit) & ~prev_done
                flag_errors += int(((judged[2] != term_exp) | (judged[3] != trunc_exp)).sum())
                rows += n
                reset_rows += int(prev_done.sum())
            prev_done = done[i]
    return {"obs_gap_p99": _p99(obs_gaps), "reward_gap_p99": _p99(reward_gaps), "flag_errors": float(flag_errors),
            "_rows_checked": rows, "_reset_rows_checked": reset_rows}


def train_readings(task, config: dict, settings: dict, kept: dict, seed: int, control: bool = False) -> dict:
    """The ``train`` numbers of the recorded train steps ``kept["runs"]``
    (see :mod:`portbench.loops.ppo`): the checked steps from the start
    (labels ``1``, ``2``, ...), which the reference trainer follows from
    the benchmark's weights and the seeds of the program's generators, and
    a window step judged from the program's own state before it (label
    ``x``). With ``control``, the judged outputs are the reference's, its
    policy's operands in float8 and its env steps in bfloat16."""
    runs = kept["runs"]
    device = runs[0]["q"].device
    chooser = np.random.default_rng([seed, 5])
    readings, obs_gaps, reward_gaps, flag_errors = {}, [], [], 0

    def trainer(start, lower=False):
        if start is None:
            return ref_ppo.Reference.from_seeds(task, config, settings, kept["weights"], kept["seeds"], device, lower)
        return ref_ppo.Reference(task, config, settings, start, device, lower)

    ref = trainer(None)
    ctl = trainer(None, True) if control else None
    readings["start_errors"] = float(int((runs[0]["q"][0] != ref.q).any(1).sum())
                                     + int((runs[0]["qd"][0] != ref.qd).any(1).sum()))
    keep = None
    for run in runs:
        label = run["label"]
        if run["start"] is not None:
            ref = trainer(run["start"])
            ctl = trainer(run["start"], True) if control else None
        before = {k: v.detach().clone() for k, v in ref.params.items()}
        loss_r, grad_r, done_r, scale_r = ref.train_step(run["q"][1:], run["qd"][1:])
        judged = {"loss": run["loss"], "grad1": run["grad1"], "change": run["change"], "done": run["done"]}
        if control:
            c_before = {k: v.detach().clone() for k, v in ctl.params.items()}
            loss_c, grad_c, done_c, _ = ctl.train_step(run["q"][1:], run["qd"][1:])
            judged = {"loss": float(loss_c), "grad1": grad_c, "done": done_c,
                      "change": {k: ctl.params[k].detach() - c_before[k] for k in c_before}}
        # the loss of a policy in training comes near 0: its gap is taken over the loss's scale
        readings[f"loss_scaled_gap_{label}"] = abs(judged["loss"] - float(loss_r)) / max(scale_r, 1e-30)
        readings[f"_loss_{label}"] = float(loss_r)
        flag_errors += int((judged["done"] != done_r).sum())
        if label in ("1", "x"):
            tag = "" if label == "1" else "_x"
            readings["grad1_gap" + tag], _ = ref_ppo.leaf_gap(judged["grad1"], grad_r)
            readings["grad1_diff" + tag], _ = ref_ppo.leaf_difference(judged["grad1"], grad_r)
            # leaves whose reference gradient is nought to rounding move by round-off alone
            norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grad_r.items()}
            median = float(np.median(list(norms.values())))
            keep = {k: norms[k] >= 1e-3 * median for k in norms}
            readings["_leaves_left_out" + tag] = sorted(k for k, v in keep.items() if not v)
        if label == "x":
            change = {k: ref.params[k].detach() - before[k] for k in before}
            readings["update_gap_x"], _ = ref_ppo.leaf_gap(judged["change"], change, keep)
        elif label == kept["last_checked"]:
            # each leaf's change over the checked steps from the start
            change = {k: ref.params[k].detach() - kept["weights"][k] for k in before}
            judged_change = (kept["change_checked"] if not control else
                             {k: ctl.params[k].detach() - kept["weights"][k] for k in before})
            readings["update_gap"], _ = ref_ppo.leaf_gap(judged_change, change, keep)
        # env steps: the first, two drawn from the seed, the first done and the step after it
        t_len, n = run["done"].shape
        picked = {0} | set(chooser.choice(t_len, size=min(2, t_len), replace=False).tolist())
        first_done = torch.nonzero(run["done"].any(1)).flatten().tolist()
        if first_done:
            picked |= {first_done[0]} | ({first_done[0] + 1} if first_done[0] + 1 < t_len else set())
        gen = torch.Generator(device=device)
        gen.set_state(run["env_rng"])
        prev_done = run["prev_done0"]
        for t in range(max(picked) + 1):
            draws = task.reset_draws(gen, n, device)
            if t in picked:
                q, qd, action = run["q"][t], run["qd"][t], run["action"][t]
                # the next state the program carried, in the observation's coordinates, and its
                # reward as the trainer got it, held against the reference's scaled by the
                # program's own return statistics after the step
                j_q, scale = run["q"][t + 1], run["reward_scale"][t].double()
                j_obs, j_reward = task.observation(j_q.double(), run["qd"][t + 1].double()), run["reward"][t]
                if control:
                    c_obs, c_reward, _ = reference_step(task, q, qd, action, draws, prev_done, torch.bfloat16)
                    j_obs, j_reward, j_q = c_obs.float(), c_reward.double() / scale, None
                o, r = step_gaps(task, q, qd, action, draws, prev_done, j_obs, j_reward, j_q, scale)
                obs_gaps.append(o)
                reward_gaps.append(r)
            prev_done = run["done"][t]
    readings["state_gap_p99"] = _p99(obs_gaps)
    readings["reward_gap_p99"] = _p99(reward_gaps)
    readings["flag_errors"] = float(flag_errors)
    return readings


def judge(readings: dict, limits: dict) -> tuple[bool, list[dict]]:
    """``correct`` and each compared number beside its limit: a number is
    within its limit when it is at most the limit."""
    lines = []
    for name, limit in limits.items():
        value = readings.get(name)
        ok = value is not None and np.isfinite(value) and value <= limit
        lines.append({"name": name, "value": value, "limit": limit, "ok": bool(ok)})
    return all(line["ok"] for line in lines), lines
