"""Share of the traced sweep window in which no kernel, copy or memset
ran on the card (100 minus the union of device intervals over the
window), in %."""


def read(run):
    if run["kind"] != "sweep" or run["trace"] is None:
        return None
    t = run["trace"]
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
