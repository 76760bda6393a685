"""CUDA runtime calls that block the host (a stream, device or event
synchronise, a synchronous copy) in the traced window, over the env steps
of the whole batch; the window's own closing synchronise not counted."""

BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cudaMemcpy", "cudaMemcpy2D", "cudaMemset")


def read(trace):
    steps = trace.context.get("steps")
    if not steps:
        return None
    return sum(1 for name, start, _, _ in trace.host if name in BLOCKING and start < trace.close_us) / steps
