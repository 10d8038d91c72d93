"""The fused generic kernel's decode mode (``csrc/fused_generic.cu``,
``fused_generic_kernel<ADAPTIVE, OFFSET, MC=false, ...>``) in library
rounds: the least time the card could take for the traced rounds
(``decode_bound``, work from the frames' own iteration counts) over the
kernel's device time, in %."""

from benchmark.harness.bounds import decode_bound

PATTERN = r"fused_generic_kernel<\s*\w+\s*,\s*\w+\s*,\s*(false|0)\b"


def read(run):
    if run["kind"] != "rounds" or run["trace"] is None:
        return None
    seconds, launches = run["trace"].kernel_seconds(PATTERN)
    if launches == 0 or seconds <= 0.0:
        return None
    ms = sum(decode_bound(c["frames"], run["n"], run["m"], run["edges"],
                          c["iterations"], run["schedule"])[0]
             for c in run["chunks"])
    return 100.0 * ms / 1e3 / seconds
