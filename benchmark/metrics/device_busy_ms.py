"""device_busy_ms: the union of the device's activity intervals in the
traced window (torch.profiler), over the requests completed in it."""


def read(run):
    t, done = run.trace_data, len(run.completed)
    return t.busy_s * 1e3 / done if t and done and t.busy_s > 0 else None
