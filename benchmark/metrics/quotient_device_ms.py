"""quotient_device_ms: the prove's device span `quotient`, the stream's
wall time between CUDA events recorded before the witness's Montgomery
form and after the quotient (idle bubbles included), the mean over the
traced window's proves (`program_spans.py`)."""

from .. import program_spans

collect = program_spans.collect


def read(run):
    return program_spans.mean_ms(run, "quotient")
