"""Device milliseconds a chunk of the key draw and the error injection:
the device operations whose launching host operation (linked by the
trace's ``External id``) starts inside one of the program's ``channel.*``
spans (``channel.keys``, ``channel.inject``), over the number of its
``sim.chunk`` spans in the traced sweep window."""

from benchmark.harness import spans


def read(run):
    if run["kind"] != "sweep":
        return None
    chunks = spans.count(run["trace"], "sim.chunk")
    ms = spans.device_ms_launched_in(run["trace"], "channel.")
    if ms is None or not chunks:
        return None
    return ms / chunks
