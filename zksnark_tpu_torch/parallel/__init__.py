"""The mesh path: the prover over several processes (`torch.distributed`)."""
