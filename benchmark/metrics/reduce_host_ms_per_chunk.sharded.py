"""Rank 0's milliseconds a chunk in the statistics' reduction outside its
waits: the time inside the program's ``parallel.reduce`` spans
(``psum_stats``: the small launches and the all-reduces' calls) and
outside their ``parallel.wait`` spans, over the number of its
``parallel.step`` spans in the traced window."""

from benchmark.harness import spans


def read(run):
    if run["kind"] != "sweep":
        return None
    steps = spans.count(run["trace"], "parallel.step")
    ms = spans.ms_outside_children(run["trace"], "parallel.reduce",
                                   "parallel.wait")
    if ms is None or not steps:
        return None
    return ms / steps
