"""The benchmark of the PyTorch and CUDA Groth16 prover (`zksnark_tpu_torch`).

`python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once; see README.md.
"""
