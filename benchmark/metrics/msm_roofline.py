"""msm_roofline: the least time of one prove's five MSMs over their
device time.

Device time (trace.py): in each prove of the traced window, the kernels
after its last NTT kernel and the run of Montgomery products and
elementwise kernels right after it (the quotient's last scaling and the
conversions of u, v, h and the witness out of Montgomery form): the pads,
the four G1 MSMs and the G2 MSM; their busy time, the mean over the
window's proves.
Least time (work.py): the MSMs over u and v (n scalars each, G1; v again
on G2) and h (n - 1) count as full-width, those polynomials' coefficients
being uniform in Fr; the C MSM over the witness's private part counts the
witness of the window's last request as it is.  Each point set (xi, xi t,
the delta sums over the private wires, xi on G2) is read once, and each
distinct scalar once.
"""

from .. import trace, work
from ..reference.groth16 import log_domain

STAGE = trace.after_split("ntt", then="montmul|elementwise")


def least(ref, witness) -> work.Work:
    n = 1 << log_domain(ref.n_gates)
    private = ref.num_wires - ref.public - 1
    wit = work.scalar_limbs(witness[ref.public + 1:])
    return work.msm_work(
        [("g1", None, n), ("g1", None, n), ("g1", None, n - 1),
         ("g1", wit, 0), ("g2", None, n)],
        [("g1", n), ("g1", n - 1), ("g1", private), ("g2", n)],
        3 * n - 1 + private)


def collect(run):
    last = getattr(run, "last", None)
    if last is not None:
        run.extra["msm_least"] = least(run.reference(), last[1])


def read(run):
    w = run.extra.get("msm_least")
    t = trace.stage_seconds(run.trace_data, STAGE)
    return 100.0 * w.least_s / t if w and t else None
