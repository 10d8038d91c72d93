"""The streamed generic kernel's trial mode (``csrc/generic_stream.cu``,
``generic_stream_kernel``): the least time the card could take for the
traced chunks (``bound``, two int8 keys in per bit, work from the frames'
own iteration counts) over the kernel's device time, in %."""

from benchmark.harness.bounds import bound

PATTERN = r"generic_stream_kernel"


def read(run):
    if run["kind"] != "sweep" or run["trace"] is None:
        return None
    seconds, launches = run["trace"].kernel_seconds(PATTERN)
    if launches == 0 or seconds <= 0.0:
        return None
    ms = sum(bound(c["frames"], run["n"], run["edges"], c["iterations"],
                   run["schedule"], bytes_per_bit=2)[0] for c in run["chunks"])
    return 100.0 * ms / 1e3 / seconds
