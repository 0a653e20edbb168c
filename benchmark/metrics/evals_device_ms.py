"""evals_device_ms: the prove's device span `evals`, the stream's wall
time between CUDA events recorded before the witness's Montgomery form
and after the three weighted evaluations of u, v and w (the ELL products
and sums and the wide rows' kernel; idle bubbles included), the mean over
the traced window's proves (`program_spans.py`).  A program without the
span leaves nothing to read."""

from .. import program_spans

collect = program_spans.collect


def read(run):
    return program_spans.mean_ms(run, "evals")
