"""repro_torch.api — the public sampling surface: :class:`SamplerConfig`,
:class:`MAGMSampler` and :class:`GraphSample`."""

from repro_torch.api.config import SamplerConfig
from repro_torch.api.result import GraphSample, QuiltStats
from repro_torch.api.session import MAGMSampler

__all__ = ["SamplerConfig", "GraphSample", "QuiltStats", "MAGMSampler"]
