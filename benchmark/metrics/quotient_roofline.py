"""quotient_roofline: the least time of one prove's quotient over its
device time.

Device time (trace.py): in each prove of the traced window, the kernels
from its first through its last NTT kernel and the run of Montgomery
products and elementwise kernels right after it: the witness's Montgomery form, the ELL products of u, v
and w, their three inverse transforms, divide_by_vanishing's coset
transforms and products, and the conversions of u, v, h and the witness
out of Montgomery form; their busy time, the mean over the window's
proves.  (What the MSM stage leaves.)
Least time (work.py): 7 size-n transforms and one product a non-zero of
the constraint system; each non-zero, the witness and u, v, h once.
"""

from .. import trace, work
from ..reference.groth16 import log_domain

STAGE = trace.before_split("ntt", then="montmul|elementwise")


def collect(run):
    ref = run.reference()
    run.extra["quotient_least"] = work.quotient_work(
        1 << log_domain(ref.n_gates), ref.nnz, ref.num_wires)


def read(run):
    w = run.extra.get("quotient_least")
    t = trace.stage_seconds(run.trace_data, STAGE)
    return 100.0 * w.least_s / t if w and t else None
