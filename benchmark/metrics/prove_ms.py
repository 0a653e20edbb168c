"""prove_ms: the measured window (first request sent to last proof back)
over the requests completed in it."""


def read(run):
    done = len(run.completed)
    return run.window_s * 1e3 / done if done else None
