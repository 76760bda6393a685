"""Share of its roofline that the generated articulated kernel reaches.

The least time is the larger of the frozen operations (each distinct
operation of a call, per env) times the envs and launches over the
float32 peak, and the frozen bytes (each input byte read once, each output
byte written once) over the memory peak; the time is the device time of
the kernels whose names hold ``MATCH``, summed over the traced window."""

MATCH = "ArticulatedStep"


def read(trace):
    counts, peaks = trace.context.get("counts"), trace.context["peaks"]
    own = [(start, end) for name, start, end in trace.kernels if MATCH in name]
    if counts is None or not own:
        return None
    calls = len(own) * trace.context["num_envs"]
    least_s = max(counts["operations_per_env"] * calls / peaks["float32_flops"],
                  counts["bytes_per_env"] * calls / peaks["hbm_bytes_per_s"])
    return 100.0 * least_s / (sum(end - start for start, end in own) / 1e6)
