"""Share of the traced window in which no operation runs on the device
(the union of the device operations' intervals against the window)."""


def read(trace):
    window_s = (trace.end_us - trace.start_us) / 1e6
    return 100.0 * (1.0 - trace.busy_s() / window_s) if window_s > 0 else None
