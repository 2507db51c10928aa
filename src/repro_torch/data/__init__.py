"""repro_torch.data — graph data helpers (:mod:`pipeline`: ``build_csr``)."""
