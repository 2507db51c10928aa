"""repro_torch.dist — fault injection and retries (:mod:`chaos`) and
atomic step checkpoints of numpy trees (:mod:`checkpoint`)."""
