"""Share of the traced window of a sweep split over ranks in which no
kernel, copy or memset ran on a card (100 minus the union of device
intervals over the window, averaged over the cards), in %."""


def read(run):
    if run["kind"] != "sweep" or run["trace"] is None or "collective_ms" not in run:
        return None
    t = run["trace"]
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
