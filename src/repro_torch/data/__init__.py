"""repro_torch.data — the random-walk corpus over a quilted MAGM graph
and ``build_csr`` (:mod:`pipeline`)."""
