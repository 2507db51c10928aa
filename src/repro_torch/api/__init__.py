"""repro_torch.api — the public sampling surface: :class:`SamplerConfig`,
:class:`MAGMSampler`, :class:`KPGMSampler` and :class:`GraphSample`."""

from repro_torch.api.config import SamplerConfig
from repro_torch.api.result import GraphSample, KPGMStats, QuiltStats
from repro_torch.api.session import KPGMSampler, MAGMSampler

__all__ = ["SamplerConfig", "GraphSample", "KPGMStats", "QuiltStats", "MAGMSampler", "KPGMSampler"]
