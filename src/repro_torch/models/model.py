"""Public model API: ``build(config) -> Model`` with init / forward /
prefill / decode (the reference's ``repro.models.model``, dense family).

The abstract (no-allocation) params and input specs of the reference's
dry-run wait for ROADMAP queue 1 item 10.3.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import kvcache, transformer

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # ---- params ----
    def init(self, key: torch.Tensor, *, device=None) -> Params:
        """The reference's ``Model.init(key)`` bits on ``device`` (default
        ``"cuda"``; raises without a card)."""
        return transformer.init_model(key, self.cfg, device=device)

    # ---- inputs ----
    def input_specs(self, shape: ShapeConfig, *, device=None) -> Dict[str, Any]:
        """Zero inputs of one cell on ``device`` (default ``"cuda"``).

        train:   tokens + labels (B, S)
        prefill: tokens (B, S)
        decode:  tokens (B, 1) + cache + cache_len
        """
        kvcache.require_dense(self.cfg)
        dev = resolve_device(device)
        b, s = shape.global_batch, shape.seq_len
        if shape.kind in ("train", "prefill"):
            specs = {"tokens": torch.zeros((b, s), dtype=torch.int32, device=dev)}
            if shape.kind == "train":
                specs["labels"] = torch.zeros((b, s), dtype=torch.int32, device=dev)
            return specs
        return {
            "tokens": torch.zeros((b, 1), dtype=torch.int32, device=dev),
            "cache": kvcache.init_cache(self.cfg, b, s, device=dev),
            "cache_len": torch.zeros((), dtype=torch.int32, device=dev),
        }

    # ---- compute ----
    def forward(self, params: Params, tokens: torch.Tensor, *, remat=True) -> Tuple[torch.Tensor, torch.Tensor]:
        logits, aux, _ = transformer.forward(params, self.cfg, tokens, remat=remat)
        return logits, aux

    def prefill(self, params: Params, tokens: torch.Tensor, *, max_len: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
        """Forward + decode-cache construction.

        ``max_len`` is the cache capacity (defaults to S + 1 so at least one
        decode step fits); sliding-window caches are capped at the window."""
        logits, _, (kvs, _) = transformer.forward(params, self.cfg, tokens, collect_kv=True)
        b, s = tokens.shape
        return logits, self._assemble_cache(kvs, b, s, max_len or (s + 1))

    def _assemble_cache(self, kvs, b: int, s: int, max_len: int) -> Params:
        w = kvcache.attn_cache_len(self.cfg, max_len)

        def ring(k):  # (L, B, S, kv, hd) -> cache layout (L, B, W, kv, hd)
            if w >= s:  # dense cache: pad the prefix K/V out to capacity
                out = torch.zeros(k.shape[:-3] + (w,) + k.shape[-2:], dtype=k.dtype, device=k.device)
                out[..., :s, :, :] = k
                return out
            # sliding window: keep the last w positions, ring-ordered
            slots = torch.arange(s - w, s, device=k.device) % w
            out = torch.zeros(k.shape[:-3] + (w,) + k.shape[-2:], dtype=k.dtype, device=k.device)
            out[..., slots, :, :] = k[..., s - w :, :, :]
            return out

        kstack, vstack = kvs  # (L, B, S, kv, hd)
        return {"k": ring(kstack.to(torch.bfloat16)), "v": ring(vstack.to(torch.bfloat16))}

    def decode(self, params: Params, cache: Params, tokens: torch.Tensor, cache_len) -> Tuple[torch.Tensor, Params]:
        """One token per sequence over ``cache`` (updated in place)."""
        return transformer.decode_step(params, self.cfg, cache, tokens, cache_len)


def build(cfg: ModelConfig) -> Model:
    kvcache.require_dense(cfg)
    return Model(cfg)
