"""Decode-time caches: dense KV, sliding-window ring KV, SSM state (the
reference's ``repro.models.kvcache``).

Layout (leading-L stacked, as the reference's, so the layer loop indexes
it):
  attention: {"k": (L, B, S_cache, KV, hd), "v": ...}       bfloat16
  ssm:       {"h": (L, B, ...) float32, "conv": (L, B, k-1, ...) bfloat16}
  hybrid:    the ssm stack + {"shared_k", "shared_v"}: one KV entry per
             application of the shared attention block (L // every)
  audio:     the decoder's KV + "enc_out" (B, encoder_seq, D) bfloat16
For sliding-window models S_cache = min(window, S): the ring buffer bounds
the footprint.  The vlm's cache holds ``num_layers`` KV entries; its
prefill and decode keep only the self layers' (``model.Model.prefill``).

On ``device="meta"`` :func:`init_cache` allocates nothing: the shapes and
dtypes serve byte counts (``analysis.roofline.model_min_bytes``).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_lib

Cache = Dict[str, torch.Tensor]


def attn_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, device=None) -> Cache:
    """Zero-initialised decode cache for one model on ``device``."""

    def mk(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    L = cfg.num_layers
    kv = (batch, attn_cache_len(cfg, seq_len), cfg.num_kv_heads, cfg.head_dim)
    cache: Cache = {}
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        cache["k"] = mk((L, *kv), torch.bfloat16)
        cache["v"] = mk((L, *kv), torch.bfloat16)
        if cfg.family == "audio":
            cache["enc_out"] = mk((batch, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
    elif cfg.family in ("ssm", "hybrid"):
        shapes = (ssm_lib.mamba1_cache_shape if cfg.family == "ssm" else ssm_lib.mamba2_cache_shape)(cfg, batch)
        cache["h"] = mk((L, *shapes["h"]), torch.float32)
        cache["conv"] = mk((L, *shapes["conv"]), torch.bfloat16)
        if cfg.family == "hybrid":
            n_shared = L // cfg.shared_attn_every
            cache["shared_k"] = mk((n_shared, *kv), torch.bfloat16)
            cache["shared_v"] = mk((n_shared, *kv), torch.bfloat16)
    else:
        raise ValueError(cfg.family)
    return cache
