"""prove_assemble_ms: the program's span `prove.assemble` in
`device_prove` (the five points made affine and the host's blinding
arithmetic down to the proof), the mean over the traced window's
proves (`program_spans.py`)."""

from .. import program_spans

collect = program_spans.collect


def read(run):
    return program_spans.mean_ms(run, "prove.assemble")
