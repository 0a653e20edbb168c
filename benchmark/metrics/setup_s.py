"""setup_s: from the harness's start (before its imports) to the end of
warm-up: imports, the kernels' build or load, the circuit, compile_r1cs,
device_setup, the pool's witnesses and the warm-up requests."""


def read(run):
    return run.setup_s
