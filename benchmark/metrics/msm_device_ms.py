"""msm_device_ms: the prove's device span `msm`, the stream's wall time
between CUDA events recorded after the quotient and after the G2 MSM
(idle bubbles included), the mean over the traced window's proves
(`program_spans.py`)."""

from .. import program_spans

collect = program_spans.collect


def read(run):
    return program_spans.mean_ms(run, "msm")
