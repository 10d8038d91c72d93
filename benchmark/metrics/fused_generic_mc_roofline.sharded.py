"""The fused generic kernel's mc mode in a sweep split over ranks: the
least time the cards could take for the traced chunks (``mc_bound`` of
every rank's share, work from the frames' own iteration counts) over the
kernel's device time summed over the cards, in %."""

from benchmark.harness.bounds import mc_bound

PATTERN = r"fused_generic_kernel<\s*\w+\s*,\s*\w+\s*,\s*(true|1)\b"


def read(run):
    if run["kind"] != "sweep" or run["trace"] is None or "collective_ms" not in run:
        return None
    seconds, launches = run["trace"].kernel_seconds(PATTERN)
    if launches == 0 or seconds <= 0.0:
        return None
    ms = sum(mc_bound(c["frames"], run["n"], run["edges"], c["iterations"],
                      run["schedule"])[0] for c in run["chunks"])
    return 100.0 * ms / 1e3 / seconds
