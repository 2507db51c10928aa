"""MAGFIT on PyTorch: only the dense scoring so far (:mod:`.magfit`)."""

from repro_torch.fit import magfit
from repro_torch.fit.magfit import dense_expected_logprob, elbo_dense

__all__ = ["magfit", "dense_expected_logprob", "elbo_dense"]
