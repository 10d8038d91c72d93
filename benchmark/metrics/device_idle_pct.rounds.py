"""Share of the traced window of library rounds in which no kernel, copy
or memset ran on the card, in %."""


def read(run):
    if run["kind"] != "rounds" or run["trace"] is None:
        return None
    t = run["trace"]
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
