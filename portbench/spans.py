"""What the per-layer readers take from the program's spans in a traced
window: the host ranges that ``gymnasium_tpu_torch.utils.tracing.span``
records while a profiler is active, named ``vector.*``, ``func.*``,
``mujoco.*`` and ``ppo.*``, on the same clock as the device's operations.

A span's time is the sum of its ranges' durations, its children included.
Each function returns ``None`` where the window holds no range of the span
(a program without it, or a step replayed from a CUDA graph, which records
its spans only at capture).
"""

from __future__ import annotations

import bisect
import collections

PROGRAM = ("vector.", "func.", "mujoco.", "ppo.")
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cudaMemcpy", "cudaMemcpy2D", "cudaMemset")
LAUNCH = ("cudaLaunch", "cuLaunch")


def blocking(name: str) -> bool:
    """A CUDA runtime call that blocks the host: the names
    ``host_syncs_per_env_step`` counts."""
    return name in BLOCKING


def launch(name: str) -> bool:
    """A kernel-launch runtime call."""
    return name.startswith(LAUNCH)


def ranges(trace, name: str) -> list:
    """``(start_us, end_us)`` of each range of the span ``name``, in order."""
    return sorted((start, end) for n, start, end, _ in trace.host if n == name)


def host_us(trace, name: str) -> float | None:
    """Host microseconds inside the span, summed over its ranges."""
    spans = ranges(trace, name)
    return sum(end - start for start, end in spans) if spans else None


def per_env_step_us(trace, name: str) -> float | None:
    """Host microseconds inside the span over the window's env steps of the
    whole batch."""
    total, steps = host_us(trace, name), trace.context.get("steps")
    return total / steps if total is not None and steps else None


def per_unit_ms(trace, name: str) -> float | None:
    """Host milliseconds inside the span over the window's units (train steps)."""
    total, units = host_us(trace, name), trace.context.get("units")
    return total / units / 1e3 if total is not None and units else None


def calls_inside(trace, name: str, match) -> int | None:
    """Host events for which ``match(event_name)`` holds and that start
    inside a range of the span ``name`` (runtime calls are matched by time
    alone: the profiler may give them another thread id than the ranges)."""
    spans = ranges(trace, name)
    if not spans:
        return None
    starts = [start for start, _ in spans]
    found = 0
    for n, start, _, _ in trace.host:
        if match(n):
            i = bisect.bisect_right(starts, start) - 1
            found += i >= 0 and start <= spans[i][1]
    return found


def calls_per_env_step(trace, name: str, match) -> float | None:
    found, steps = calls_inside(trace, name, match), trace.context.get("steps")
    return found / steps if found is not None and steps else None


def idle_by_innermost(trace) -> collections.Counter | None:
    """Microseconds of the window's device idle time by the innermost
    program span at each gap's middle (``None``: no span there), searched
    on the thread holding most of the spans; ``None`` without spans or
    device operations."""
    spans = [h for h in trace.host if h[0].startswith(PROGRAM)]
    if not spans or not trace.device_ops:
        return None
    thread = collections.Counter(h[3] for h in spans).most_common(1)[0][0]
    spans = sorted((h for h in spans if h[3] == thread), key=lambda h: (h[1], -h[2]))
    idle, stack, i = collections.Counter(), [], 0
    for lo, hi in trace.idle_gaps():  # in order, so their middles are too
        mid = (lo + hi) / 2
        while i < len(spans) and spans[i][1] <= mid:
            while stack and stack[-1][2] <= spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        idle[stack[-1][0] if stack else None] += hi - lo
    return idle


def unattributed_idle_pct(trace, containers) -> float | None:
    """Share of the window's device idle time whose gap has, at its middle,
    no program span or only a container (a span named in ``containers``)
    as the innermost."""
    idle = idle_by_innermost(trace)
    if idle is None:
        return None
    total = sum(idle.values())
    if total <= 0:
        return 0.0
    return 100.0 * sum(us for name, us in idle.items() if name is None or name in containers) / total
