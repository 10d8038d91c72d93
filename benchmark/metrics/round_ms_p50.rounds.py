"""Median of the untraced window's round times (the benchmark's clock from
the call of ``protocol.qkd_ldpc_rate_adapt`` until the round's flags and
iterations are on the host), in ms."""

import statistics


def read(run):
    times = run.get("round_ms")
    if run["kind"] != "rounds" or not times:
        return None
    return float(statistics.median(times))
