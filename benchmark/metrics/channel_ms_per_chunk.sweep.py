"""Device time per chunk, in ms, of every operation in the traced sweep
window that is not one of the port's decode kernels: where the engine has
no mc mode, the torch key draw, the exact error injection and the copy of
the statistics to the host."""

PORT_KERNELS = r"fused_generic_kernel|generic_stream_kernel|fused_qc_kernel|qc_stream_kernel"


def read(run):
    if run["kind"] != "sweep" or run["trace"] is None or not run["chunks"]:
        return None
    seconds = run["trace"].device_seconds_except(PORT_KERNELS)
    if seconds <= 0.0:
        return None
    return seconds * 1e3 / len(run["chunks"])
