"""zksnark_tpu_torch — the Groth16 / BN254 prover of `zksnark_tpu`, ported
to PyTorch and hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

It imports `torch` and never `jax`, and nothing of the JAX package.
Layout (each module is the counterpart of the JAX package's module of the
same path):

  field/     params, limbs and the plain Montgomery arithmetic
  csrc/      CUDA sources: the field header, K1 montmul, K2-K4 point ops
  ops/       montmul (K1), curve_kernels (K2-K4), ntt, scans, msm
  curve/     field_ops, jacobian, bn254 (host), native (host pairing)
  groth16/   prover (setup / prove), protocol (verify), backend
  frontend/  r1cs
  utils/     serialization (the JAX package's CRS formats)

Entry points run on the CUDA card unless the caller passes
`device="cpu"`, where each kernel is replaced by its plain version.
"""
