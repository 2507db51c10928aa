"""repro_torch.api — the public sampling surface: :class:`SamplerConfig`,
:class:`MAGMSampler`, :class:`KPGMSampler` and :class:`GraphSample`; and
:func:`fit_config`, which goes the other way, from an observed edge list to
a ready-to-sample config."""

from repro_torch.api.config import SamplerConfig
from repro_torch.api.result import GraphSample, KPGMStats, QuiltStats
from repro_torch.api.session import KPGMSampler, MAGMSampler

__all__ = ["SamplerConfig", "GraphSample", "KPGMStats", "QuiltStats", "MAGMSampler", "KPGMSampler", "fit_config"]


def fit_config(edges, n, d, *, key=None, backend="auto", device=None, **fit_kwargs):
    """Fit MAG parameters to an (E, 2) edge list on ``device`` (default
    ``"cuda"``; raises without a card) by variational EM
    (``repro_torch.fit.magfit.magfit``, imported here: the fitting package
    builds on these sessions), and package the MAP attributes and fitted
    ``(thetas, mu)`` as a :class:`SamplerConfig` on the same device.
    Returns ``(config, fit_result)``."""
    from repro_torch.core.device import resolve_device
    from repro_torch.fit import magfit as _magfit
    from repro_torch.fit import recover as _recover

    dev = resolve_device(device)
    fit = _magfit.magfit(edges, n, d, key=key, device=dev, **fit_kwargs)
    return _recover.fitted_config(fit, backend=backend, device=dev), fit
