"""prove_encode_ms: the program's span `prove.encode` in `device_prove`
(the blinding, the witness padded and its limbs made on the host,
`FR_CTX.to_limbs_np`), the mean over the traced window's proves
(`program_spans.py`)."""

from .. import program_spans

collect = program_spans.collect


def read(run):
    return program_spans.mean_ms(run, "prove.encode")
