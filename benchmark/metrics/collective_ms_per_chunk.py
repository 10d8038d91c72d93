"""Milliseconds a chunk that a rank spends in the statistics' collective
(``parallel.sharded_step``'s ``times``: from the end of its decode, at a
device synchronize, to the reduced statistics on the host; rank wait
included), averaged over the window's chunks and the ranks."""


def read(run):
    return run.get("collective_ms")
