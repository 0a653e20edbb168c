"""The plain reference that decides `correct`: Python integers only.

It imports neither `jax`, `zksnark_tpu` nor `zksnark_tpu_torch`, and takes
nothing the program made: from the statement, the trapdoor and the
blinding that the benchmark drew, it works out every proof element itself.
"""
