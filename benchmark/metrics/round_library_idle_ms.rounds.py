"""Device-idle milliseconds a library round: the time inside the program's
``protocol.round`` spans (the body of ``protocol.qkd_ldpc_rate_adapt``) in
which no kernel, copy or memset ran on the card, over the number of those
spans in the traced window."""

from benchmark.harness import spans


def read(run):
    if run["kind"] != "rounds":
        return None
    return spans.idle_ms_per_span(run["trace"], "protocol.round")
