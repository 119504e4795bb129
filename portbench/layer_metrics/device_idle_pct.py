"""Device: the share of the window in which no operation ran on the card
(100 - the union of the trace's device intervals over the window), in
percent."""


def read(run):
    view = run["device"]
    if view is None or view["window_s"] <= 0 or view["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - view["busy_s"] / view["window_s"])
