"""Nothing the benchmark runs imports JAX or the JAX package (compared by
whole top-level names: the port's name begins with the JAX package's),
and the reference imports nothing of the program."""

import json
import os
import subprocess
import sys

from benchmark import session

MODULES = ["benchmark.run", "benchmark.session", "benchmark.control",
           "benchmark.trace", "benchmark.work",
           "benchmark.circuits.square_chain", "benchmark.circuits.keccak256"]


def _loaded(modules):
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.', 1)[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=session.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    metrics = [f"benchmark.metrics.{m['name']}" for m in
               session.load_spec()["end_to_end"]
               + session.load_spec()["per_layer"]]
    loaded = _loaded(MODULES + metrics)
    assert not loaded & session.FORBIDDEN
    assert "zksnark_tpu_torch" in loaded


def test_reference_loads_nothing_of_the_program():
    refs = ["benchmark.reference.groth16", "benchmark.reference.bn254",
            "benchmark.reference.keccak", "benchmark.reference.square_chain",
            "benchmark.reference.keccak256"]
    loaded = _loaded(refs)
    assert not loaded & (session.FORBIDDEN | {"zksnark_tpu_torch", "torch"})


def test_jax_modules_compares_whole_names():
    assert session.jax_modules(["zksnark_tpu_torch", "zksnark_tpu_torch.ops",
                                "jaxtyping", "numpy"]) == set()
    assert session.jax_modules(["zksnark_tpu.ops.msm", "jax._src",
                                "flax"]) == {"zksnark_tpu", "jax", "flax"}
