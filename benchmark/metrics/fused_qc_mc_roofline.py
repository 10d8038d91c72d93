"""The fused QC kernel's mc mode (``csrc/fused_qc.cu``,
``fused_qc_kernel<LAYERED, ADAPTIVE, OFFSET, MC=true, ...>``): the least
time the card could take for the traced chunks (``mc_bound`` in the run's
schedule, work from the frames' own iteration counts) over the kernel's
device time, in %."""

from benchmark.harness.bounds import mc_bound

PATTERN = r"fused_qc_kernel<\s*\w+\s*,\s*\w+\s*,\s*\w+\s*,\s*(true|1)\b"


def read(run):
    if run["kind"] != "sweep" or run["trace"] is None:
        return None
    seconds, launches = run["trace"].kernel_seconds(PATTERN)
    if launches == 0 or seconds <= 0.0:
        return None
    ms = sum(mc_bound(c["frames"], run["n"], run["edges"], c["iterations"],
                      run["schedule"])[0] for c in run["chunks"])
    return 100.0 * ms / 1e3 / seconds
