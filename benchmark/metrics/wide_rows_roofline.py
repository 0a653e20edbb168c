"""wide_rows_roofline: the least time of one prove's wide-row sums over
their device time.

Device time (trace.py): in each prove of the traced window, the busy time
of the kernels named `wide_rows` (the CSR sums of the rows that the
prover's ELL leaves out), the mean over the window's proves.
Least time (work.py's peaks): the reference's rows wider than the ELL
width that the program chose for their matrix (the layout counters
`narrow_width_u`, `_v`, `_w` that `compile_r1cs` sets, read from
`zksnark_tpu_torch.utils.profiling.layout_counts`), each of their
non-zeros one Montgomery product reading a 4 B index, a 32 B value and a
32 B witness element, each such row writing 32 B.  The program picks the
widths, the reference counts the rows and non-zeros past them.  A program
without the counters or the kernel leaves nothing to read.
"""

from .. import trace, work


def STAGE(kernels):
    return [k for k in kernels if "wide_rows" in k[2]]


def narrow_widths():
    """The program's ELL width of u, v and w, or None without them."""
    try:
        from zksnark_tpu_torch.utils import profiling
    except ImportError:
        return None
    counts = getattr(profiling, "layout_counts", dict)()
    widths = [counts.get(f"narrow_width_{m}") for m in "uvw"]
    return None if None in widths else widths


def least(ref, k0s) -> work.Work:
    """The wide rows' work: the rows of each of the reference's width
    histograms (u, v, w) wider than that matrix's k0."""
    rows = nnz = 0
    for hist, k0 in zip(ref.widths, k0s):
        for k, c in dict(hist).items():
            if k > k0:
                rows, nnz = rows + c, nnz + k * c
    return work.Work(nnz, nnz * (4 + 2 * work.SCALAR_BYTES)
                     + rows * work.SCALAR_BYTES)


def collect(run):
    ref = run.reference()
    k0s = narrow_widths()
    if getattr(ref, "widths", None) is not None and k0s:
        run.extra["wide_least"] = least(ref, k0s)


def read(run):
    w = run.extra.get("wide_least")
    t = trace.stage_seconds(run.trace_data, STAGE)
    return 100.0 * w.least_s / t if w and w.products and t else None
