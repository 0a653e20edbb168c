"""launches_per_prove: the prover's kernel launch counters (the LAUNCHES
dicts of ops/montmul.py, ops/ntt.py and ops/curve_kernels.py) over the
window, over the requests completed in it."""


def read(run):
    done = len(run.completed)
    total = sum(run.launches.values())
    return total / done if done and total else None
