"""Device-idle milliseconds a combination: the time inside the program's
``sim.combination`` spans (the body of ``simulation.run_combination``) in
which no kernel, copy or memset ran on the card, over the number of those
spans in the traced sweep window."""

from benchmark.harness import spans


def read(run):
    if run["kind"] != "sweep":
        return None
    return spans.idle_ms_per_span(run["trace"], "sim.combination")
