"""Rank 0's milliseconds a chunk waiting in the statistics' reduction: the
time inside the program's ``parallel.wait`` spans (each wait on an
all-reduce and each host read of its result, where rank 0 waits for the
slowest rank), over the number of its ``parallel.step`` spans in the
traced window."""

from benchmark.harness import spans


def read(run):
    if run["kind"] != "sweep":
        return None
    steps = spans.count(run["trace"], "parallel.step")
    ms = spans.total_ms(run["trace"], "parallel.wait")
    if ms is None or not steps:
        return None
    return ms / steps
