"""Decode-time caches of the dense family: KV, or a sliding-window ring KV
(the reference's ``repro.models.kvcache``).

Layout (leading-L stacked, as the reference's, so the layer loop indexes
it): ``{"k": (L, B, S_cache, KV, hd), "v": ...}`` in bfloat16, whatever the
model dtype.  For sliding-window models S_cache = min(window, S): the ring
buffer bounds the footprint.

On ``device="meta"`` :func:`init_cache` allocates nothing: the shapes and
dtypes serve byte counts (``analysis.roofline.model_min_bytes``).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig

Cache = Dict[str, torch.Tensor]


def require_dense(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port does not run yet
    (moe, ssm, hybrid, vlm and audio: ROADMAP queue 1 item 10.1.3)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported yet (ROADMAP queue 1 item 10.1.3)"
        )


def attn_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, device=None) -> Cache:
    """Zero-initialised decode cache for one model on ``device``."""
    require_dense(cfg)
    shape = (cfg.num_layers, batch, attn_cache_len(cfg, seq_len), cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
    }
