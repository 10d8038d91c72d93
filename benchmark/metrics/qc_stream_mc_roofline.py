"""The streamed QC kernel's mc mode in the min-sum family
(``csrc/qc_stream.cu``, ``qc_stream_kernel<LAYERED, ADAPTIVE, OFFSET,
MC=true, CHECK=0>``): the least time the card could take for the traced
chunks (``mc_bound`` in the run's schedule, work from the frames' own
iteration counts) over the kernel's device time, in %. The SPA pair's mc
instantiations (CHECK 1 and 2) do other work than ``mc_bound`` counts and
are left out."""

from benchmark.harness.bounds import mc_bound

PATTERN = (r"qc_stream_kernel<\s*\w+\s*,\s*\w+\s*,\s*\w+\s*,\s*(true|1)\s*,"
           r"\s*0\s*>")


def read(run):
    if run["kind"] != "sweep" or run["trace"] is None:
        return None
    seconds, launches = run["trace"].kernel_seconds(PATTERN)
    if launches == 0 or seconds <= 0.0:
        return None
    ms = sum(mc_bound(c["frames"], run["n"], run["edges"], c["iterations"],
                      run["schedule"])[0] for c in run["chunks"])
    return 100.0 * ms / 1e3 / seconds
