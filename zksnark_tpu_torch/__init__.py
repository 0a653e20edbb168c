"""zksnark_tpu_torch — the Groth16 / BN254 stack of `zksnark_tpu`, ported
to PyTorch and hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

It imports `torch` and never `jax`, and nothing of the JAX package.
Layout (each module is the counterpart of the JAX package's module of the
same path):

  field/     host prime fields (FR, FQ, Z251), params, limbs and the
             plain Montgomery arithmetic (product, power, inverse)
  poly/      dense coefficient polynomials (the host QAP's, and the
             NTT's oracle)
  frontend/  the .zk lexer / parser, compiler, witness interpreter, the
             legacy format, R1CS
  builder/   the imperative circuit builder: gates, words, comparators,
             in-circuit Keccak-256
  csrc/      CUDA sources: the field header, K1 montmul, K2-K4 point ops
  ops/       montmul (K1), curve_kernels (K2-K4), ntt, scans, msm
  curve/     field_ops, jacobian, bn254 (host), native (host pairing)
  groth16/   prover (device setup / prove), qap and protocol (host
             setup / prove / verify), backend (BN254, the Z251 mock)
  utils/     serialization (the JAX package's CRS, proof and witness
             formats), keccak_host, profiling
  cli.py     compile / setup / prove / verify / bench on .zk files
  bench.py   the groth16_prove_2^20 headline on the card
  examples/  keccak_proof: a Keccak-256 preimage proof at n = 2^18

Entry points run on the CUDA card unless the caller passes
`device="cpu"` (the CLI: `--device cpu`), where each kernel is replaced
by its plain version.
"""

from .field.host import FQ, FR, Z251, PrimeField  # noqa: F401
from .frontend import ast, compiler, legacy, witness  # noqa: F401
from .frontend.r1cs import R1CS  # noqa: F401
from .frontend.witness import weights  # noqa: F401
from .groth16 import backend, protocol, qap  # noqa: F401
from .groth16.backend import BN254Backend, Z251Backend  # noqa: F401
from .groth16.protocol import Proof, SigmaG1, SigmaG2, prove, setup, verify  # noqa: F401
from .groth16.qap import QAP, from_r1cs  # noqa: F401


def parse_zk(code: str, field=None) -> R1CS:
    """Compile ``.zk`` source to an R1CS (over Z251 unless `field` is
    given, as in the JAX package)."""
    return compiler.parse(code, field if field is not None else Z251)
