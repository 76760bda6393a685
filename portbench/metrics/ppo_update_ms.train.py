"""Host milliseconds a train step spends inside the trainer's
``ppo.update`` range, averaged over the traced train steps."""

RANGE = "ppo.update"


def read(trace):
    spans = [end - start for name, start, end, _ in trace.host if name == RANGE]
    return sum(spans) / len(spans) / 1e3 if spans else None
