"""prove_issue_ms: the program's span `prove.issue` in `device_prove` (the
witness's upload, its Montgomery form and every launch of the quotient
and the five MSMs, host waits inside them included), the mean over the
traced window's proves (`program_spans.py`)."""

from .. import program_spans

collect = program_spans.collect


def read(run):
    return program_spans.mean_ms(run, "prove.issue")
