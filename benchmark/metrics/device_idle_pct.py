"""device_idle_pct: the share of the traced window in which the device
runs nothing."""


def read(run):
    t = run.trace_data
    if not t or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
