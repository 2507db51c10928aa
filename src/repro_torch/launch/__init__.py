"""repro_torch.launch — entry points: the graph server (:mod:`serve`)."""
