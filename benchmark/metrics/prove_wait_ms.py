"""prove_wait_ms: the program's span `prove.wait` in `device_prove` (the
host waiting for the card to finish the prove: one synchronize), the
mean over the traced window's proves (`program_spans.py`)."""

from .. import program_spans

collect = program_spans.collect


def read(run):
    return program_spans.mean_ms(run, "prove.wait")
