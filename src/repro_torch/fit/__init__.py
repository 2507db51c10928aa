"""MAGFIT on PyTorch: variational-EM estimation of MAG parameters from edge
lists, the fitting half of the generate -> fit -> generate loop.

- :mod:`.magfit`: the E/M steps, the monotone EM driver ``magfit.magfit``
  and the dense scoring;
- :mod:`.ingest`: external edge lists into the shard and CSR forms;
- :mod:`.recover`: the round trip, fit packaged as a ``SamplerConfig``
  (``recover.recover``).

The drivers share their submodules' names, so the package exports them as
the aliases :func:`fit` and :func:`roundtrip`.
"""

from repro_torch.fit import ingest, magfit, recover
from repro_torch.fit.ingest import EdgeList, fit_data, load_edge_list, to_csr
from repro_torch.fit.magfit import (
    FitData,
    FitOptions,
    FitResult,
    dense_expected_logprob,
    elbo,
    elbo_dense,
    shard_edges,
)
from repro_torch.fit.recover import (
    RecoveryReport,
    bootstrap_theta_se,
    canonicalize,
    fitted_config,
    hard_attributes,
)

fit = magfit.magfit
roundtrip = recover.recover

__all__ = [
    "EdgeList",
    "FitData",
    "FitOptions",
    "FitResult",
    "RecoveryReport",
    "bootstrap_theta_se",
    "canonicalize",
    "dense_expected_logprob",
    "elbo",
    "elbo_dense",
    "fit",
    "fit_data",
    "fitted_config",
    "hard_attributes",
    "ingest",
    "load_edge_list",
    "magfit",
    "recover",
    "roundtrip",
    "shard_edges",
    "to_csr",
]
