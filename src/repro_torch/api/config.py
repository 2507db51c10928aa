"""SamplerConfig: the one frozen value describing how to sample.

The fields of the reference's ``repro.api.SamplerConfig``, plus
``device``.  A config is pure data; a session resolves it into device
state once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

VALID_BACKENDS = ("auto", "device", "host", "balldrop")


@dataclasses.dataclass(frozen=True, eq=False)
class SamplerConfig:
    """Immutable sampler description consumed by :class:`MAGMSampler` and
    :class:`KPGMSampler`.

    ``params`` is ``magm.MAGMParams`` (MAGM) or ``kpgm.KPGMParams`` (KPGM);
    the attribute source of a MAGM session is an explicit (n, d) ``F`` or
    ``num_nodes`` rows drawn with ``attribute_key`` (default
    ``PRNGKey(0)``).  ``use_kernel`` None runs the device rounds' block
    lookup through its kernel wrapper, False asks for the plain PyTorch
    version.  ``device`` is where the session runs (default ``"cuda"``; a
    session raises when no card is present).  The other fields mean what
    they mean in the reference (``split=True`` is the section-5 split
    sampler, ``bprime`` its light-part cap); ``mesh``, which this port does
    not run yet (ROADMAP queue 1 item 7b), makes the session raise
    ``NotImplementedError``.
    """

    params: Any
    F: Optional[np.ndarray] = None
    num_nodes: Optional[int] = None
    attribute_key: Optional[Any] = None
    backend: str = "auto"
    mesh: Any = None
    use_kernel: Optional[bool] = None
    oversample: float = 1.05
    max_rounds: int = 8
    bprime: Optional[int] = None
    split: bool = False
    exact_cells: Optional[bool] = None
    dtype: Any = np.int64
    device: Any = "cuda"

    def __post_init__(self) -> None:
        if self.backend not in VALID_BACKENDS:
            raise ValueError(
                f"backend must be one of {VALID_BACKENDS}, got {self.backend!r}"
            )
        if not self.oversample >= 1.0:
            raise ValueError(f"oversample must be >= 1.0, got {self.oversample}")
        if int(self.max_rounds) < 1:
            raise ValueError(f"max_rounds must be >= 1, got {self.max_rounds}")
        if self.exact_cells is not None and not isinstance(self.exact_cells, bool):
            raise ValueError(
                f"exact_cells must be None or a bool, got {self.exact_cells!r}"
            )
        if np.dtype(self.dtype).kind not in "iu":
            raise ValueError(f"dtype must be an integer dtype, got {self.dtype!r}")
        torch.device(self.device)  # parses, or raises on a malformed name

    def replace(self, **changes) -> "SamplerConfig":
        """A new config with ``changes`` applied (configs are immutable)."""
        return dataclasses.replace(self, **changes)
