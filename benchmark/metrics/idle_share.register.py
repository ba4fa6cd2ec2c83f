"""idle_share.register: the share of the traced window in which no operation
runs on the card (the union of device intervals), in %."""


def read(run):
    t = run.trace
    if t is None or t.calls == 0 or t.busy_s <= 0:  # no device operation traced
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
