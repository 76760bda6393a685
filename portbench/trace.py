"""The traced window: ``torch.profiler`` over a fixed amount of a cell's
work, reduced to plain event tables that the per-layer readers
(``portbench/metrics/<name>.py``) take their numbers from.

The profiler has lost the first launches of a trace before, so a lead-in
unit of work runs inside the trace and ends in a synchronise under the
range ``portbench.lead_in``; the window starts where that range ends and
closes with a synchronise under ``portbench.sync``.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import importlib.util
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

LEAD_IN, SYNC = "portbench.lead_in", "portbench.sync"


@dataclasses.dataclass
class Trace:
    """A traced window: device operations ``(name, start_us, end_us)``,
    the host's events ``(name, start_us, end_us, thread)``, and what the
    window held (``context``: ``steps``, the env steps of the whole batch;
    ``units``, the blocks or train steps; ``num_envs``; ``counts``, the
    cell's frozen kernel counts; ``peaks``)."""

    device_ops: list
    host: list
    start_us: float
    end_us: float
    close_us: float  # where the closing synchronise begins
    window_s: float
    context: dict

    @property
    def kernels(self) -> list:
        return [e for e in self.device_ops if not e[0].startswith(("Memcpy", "Memset"))]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        total, reach = 0.0, self.start_us
        for _, start, end in sorted(self.device_ops, key=lambda e: e[1]):
            start, end = max(start, reach), min(end, self.end_us)
            if end > start:
                total += end - start
                reach = end
        return total / 1e6

    def idle_gaps(self) -> list:
        """``(start_us, end_us)`` of each stretch with no device operation."""
        gaps, reach = [], self.start_us
        for _, start, end in sorted(self.device_ops, key=lambda e: e[1]):
            if start > reach:
                gaps.append((reach, start))
            reach = max(reach, end)
        if self.end_us > reach:
            gaps.append((reach, self.end_us))
        return gaps


def capture(unit, count: int, context: dict, sync) -> Trace:
    """Trace ``count`` calls of ``unit`` after one lead-in call; ``sync``
    waits for the device."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(LEAD_IN):
            unit()
            sync()
        start = time.perf_counter()
        for _ in range(count):
            unit()
        with record_function(SYNC):
            sync()
        window_s = time.perf_counter() - start
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    device_ops, host = [], []
    for e in prof.events():
        r = e.time_range
        if e.device_type == cuda and not e.is_user_annotation:
            device_ops.append((e.name, float(r.start), float(r.end)))
        elif e.device_type == cpu:
            host.append((e.name, float(r.start), float(r.end), e.thread))
    lead = [h for h in host if h[0] == LEAD_IN]
    sync = [h for h in host if h[0] == SYNC]
    if len(lead) != 1 or len(sync) != 1:
        raise RuntimeError(f"the trace holds {len(lead)} lead-in and {len(sync)} closing ranges, not one each")
    start_us, end_us = lead[0][2], sync[0][2]
    device_ops = [e for e in device_ops if e[1] >= start_us]
    host = [h for h in host if h[1] >= start_us and h[2] <= end_us]
    return Trace(device_ops, host, start_us, end_us, sync[0][1], window_s, dict(context))


def readers(directory: Path) -> dict:
    """Each per-layer metric's reader, ``portbench/metrics/<name>.py``, by name."""
    found = {}
    for path in sorted(directory.glob("*.py")):
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(found)}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        found[path.stem] = module.read
    return found


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    stretches summed by the host event (the innermost) that was running
    at their middle."""
    by_op = collections.Counter()
    for name, start, end in trace.device_ops:
        by_op[name[:120]] += (end - start) / 1e6
    main = collections.Counter(h[3] for h in trace.host).most_common(1)
    thread = main[0][0] if main else None
    host = sorted((h for h in trace.host if h[3] == thread), key=lambda h: h[1])
    starts = [h[1] for h in host]
    by_host = collections.Counter()
    for lo, hi in sorted(trace.idle_gaps(), key=lambda g: g[0] - g[1])[:500]:
        mid, label = (lo + hi) / 2, "no host event"
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0 and i > bisect.bisect_right(starts, mid) - 200:
            if host[i][2] >= mid:
                label = host[i][0]
                break
            i -= 1
        by_host[label[:120]] += (hi - lo) / 1e6
    return {"device_ops": [[k, v] for k, v in by_op.most_common(top)],
            "idle_gaps": [[k, v] for k, v in by_host.most_common(top)]}
