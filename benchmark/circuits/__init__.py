"""The circuits as the prover gets them, one module per configuration's
`circuit` key: `statement(cfg, rng)` draws a statement, and `Circuit(cfg)` has
`r1cs()` and `witness(statement)`.  Their plain references are the modules of the
same name under `benchmark/reference/`."""
