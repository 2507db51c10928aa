"""MAGMSampler: build the device state once, sample many times.

A session resolves a frozen :class:`SamplerConfig` into an owned
:class:`repro_torch.core.quilt.QuiltPlan` on its device and a key stream;
each ``.sample()`` runs one exact-cell round.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.api.config import SamplerConfig
from repro_torch.api.result import GraphSample
from repro_torch.core import magm, prng, quilt
from repro_torch.core.device import resolve_device


class MAGMSampler:
    """Session over one MAGM configuration.

    Examples
    --------
    >>> import numpy as np
    >>> from repro_torch.api import MAGMSampler, SamplerConfig
    >>> from repro_torch.core import magm, prng
    >>> theta = np.array([[0.3, 0.6], [0.6, 0.9]], dtype=np.float32)
    >>> cfg = SamplerConfig(params=magm.make_params(theta, 0.5, 5),
    ...                     num_nodes=24, device="cpu")
    >>> gs = MAGMSampler(cfg).sample(prng.PRNGKey(1))
    >>> gs.num_edges == gs.stats.kept_edges
    True
    """

    def __init__(self, config: SamplerConfig, *, key: Optional[torch.Tensor] = None):
        reason = quilt.unported_reason(
            backend=config.backend, mesh=config.mesh,
            exact_cells=config.exact_cells, split=config.split,
        )
        if reason is not None:
            raise NotImplementedError(f"{reason} is not ported yet")
        params = config.params
        if not hasattr(params, "mu"):
            raise TypeError("MAGMSampler needs magm.MAGMParams (with mu)")
        self.config = config
        self.device = resolve_device(config.device)
        self._key = key if key is not None else prng.PRNGKey(0)
        self.F = magm.resolve_attributes(
            params,
            config.F,
            num_nodes=config.num_nodes,
            attribute_key=config.attribute_key,
            device=self.device,
        )
        self.n = int(self.F.shape[0])
        if self.n > 0 and np.iinfo(np.dtype(config.dtype)).max < self.n - 1:
            raise ValueError(
                f"dtype {np.dtype(config.dtype)} cannot hold node ids up to {self.n - 1}"
            )
        self.plan: Optional[quilt.QuiltPlan] = None
        if self.F.size:
            self.plan = quilt.build_quilt_plan(self.F, params.thetas, device=self.device)

    def _next_key(self) -> torch.Tensor:
        """Advance the session's key stream (used when sample(key=None))."""
        self._key, sub = prng.split(self._key)
        return sub

    def sample(self, key: Optional[torch.Tensor] = None) -> GraphSample:
        """Draw one MAGM graph; ``key=None`` consumes the session's stream."""
        key = self._next_key() if key is None else key
        if self.plan is None:
            return GraphSample(
                np.zeros((0, 2), dtype=self.config.dtype), 0,
                quilt.QuiltStats(0, 0, 0, 0, 0, 0, None), key,
            )
        c = self.config
        run = quilt.quilt_run(
            key, self.plan, backend=c.backend, use_kernel=c.use_kernel,
            exact_cells=c.exact_cells,
        )
        edges = run.edges()
        return GraphSample(
            edges.astype(c.dtype, copy=False), self.n,
            run.stats(edges.shape[0]), key,
        )
