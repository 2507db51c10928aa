"""Public model API: ``build(config) -> Model`` with init / forward /
prefill / decode for all six families (the reference's
``repro.models.model``).

``abstract_params`` and ``input_specs(shape, abstract=True)`` give the
reference's shapes and dtypes as ``meta`` tensors (no allocation), the
counterpart of its ``jax.eval_shape`` trees, for the dry-run.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import kvcache, transformer

Params = Dict[str, Any]


def context_len(cfg: ModelConfig) -> Optional[int]:
    """Tokens of the family's context: the vlm's image tokens, the audio
    encoder's frames; None for the families without one."""
    return {"vlm": cfg.num_image_tokens, "audio": cfg.encoder_seq}.get(cfg.family)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # ---- params ----
    def init(self, key: torch.Tensor, *, device=None) -> Params:
        """The reference's ``Model.init(key)`` bits on ``device`` (default
        ``"cuda"``; raises without a card)."""
        return transformer.init_model(key, self.cfg, device=device)

    def abstract_params(self) -> Params:
        """The params' shapes and dtypes as ``meta`` tensors: no memory, no
        draws."""
        return transformer.init_model(None, self.cfg, device="meta")

    # ---- inputs ----
    def input_specs(self, shape: ShapeConfig, *, device=None, abstract: bool = False) -> Dict[str, Any]:
        """Zero inputs of one cell on ``device`` (default ``"cuda"``), or
        with ``abstract`` their shapes and dtypes as ``meta`` tensors.

        train:   tokens + labels (B, S) [+ context embeddings]
        prefill: tokens (B, S) [+ context]
        decode:  tokens (B, 1) + cache + cache_len [+ context]

        ``context`` (bfloat16): the vlm's (B, num_image_tokens, D) always,
        the audio family's (B, encoder_seq, D) except at decode (the cache
        holds the encoder's output).
        """
        cfg = self.cfg
        dev = torch.device("meta") if abstract else resolve_device(device)
        b, s = shape.global_batch, shape.seq_len
        if shape.kind in ("train", "prefill"):
            specs = {"tokens": torch.zeros((b, s), dtype=torch.int32, device=dev)}
            if shape.kind == "train":
                specs["labels"] = torch.zeros((b, s), dtype=torch.int32, device=dev)
        else:
            specs = {
                "tokens": torch.zeros((b, 1), dtype=torch.int32, device=dev),
                "cache": kvcache.init_cache(cfg, b, s, device=dev),
                "cache_len": torch.zeros((), dtype=torch.int32, device=dev),
            }
        n = context_len(cfg)
        if n is not None and not (cfg.family == "audio" and shape.kind == "decode"):
            specs["context"] = torch.zeros((b, n, cfg.d_model), dtype=torch.bfloat16, device=dev)
        return specs

    # ---- compute ----
    def forward(self, params: Params, tokens: torch.Tensor, *, context=None,
                remat=True) -> Tuple[torch.Tensor, torch.Tensor]:
        logits, aux, _ = transformer.forward(params, self.cfg, tokens, context=context, remat=remat)
        return logits, aux

    def prefill(self, params: Params, tokens: torch.Tensor, *, context=None,
                max_len: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
        """Forward + decode-cache construction.

        ``max_len`` is the cache capacity (defaults to S + 1 so at least one
        decode step fits); sliding-window caches are capped at the window."""
        logits, _, (pieces, ctx) = transformer.forward(params, self.cfg, tokens, context=context, collect_kv=True)
        b, s = tokens.shape
        return logits, self._assemble_cache(pieces, ctx, b, s, max_len or (s + 1))

    def _assemble_cache(self, pieces, ctx, b: int, s: int, max_len: int) -> Params:
        cfg = self.cfg
        w = kvcache.attn_cache_len(cfg, max_len)

        def ring(k):  # (L, B, S, kv, hd) -> cache layout (L, B, W, kv, hd), bfloat16
            # made from k's own pieces, so a DTensor stack keeps its sharding
            k = k.to(torch.bfloat16)
            if w >= s:  # dense cache: pad the prefix K/V out to capacity
                pad = torch.zeros_like(k[..., :1, :, :]).expand(*k.shape[:-3], w - s, *k.shape[-2:])
                return torch.cat([k, pad], dim=-3)
            # sliding window: the last w positions, ring-ordered (position p in
            # slot p % w): a roll as two slices (torch 2.11's DTensor has no
            # strategy for aten.roll)
            last, shift = k[..., s - w :, :, :], (s - w) % w
            if shift == 0:
                return last.clone(memory_format=torch.contiguous_format)
            return torch.cat([last[..., w - shift :, :, :], last[..., : w - shift, :, :]], dim=-3)

        if cfg.family in ("dense", "moe", "vlm", "audio"):  # the vlm's pieces are its self layers'
            cache = {"k": ring(pieces[0]), "v": ring(pieces[1])}
            if cfg.family == "audio":
                cache["enc_out"] = ctx.to(torch.bfloat16)
            return cache
        if cfg.family == "ssm":
            return {"h": pieces["h"], "conv": pieces["conv"]}
        ssm_caches, shared = pieces  # hybrid
        return {"h": ssm_caches["h"], "conv": ssm_caches["conv"], "shared_k": ring(shared[0]),
                "shared_v": ring(shared[1])}

    def decode(self, params: Params, cache: Params, tokens: torch.Tensor, cache_len, *,
               context=None) -> Tuple[torch.Tensor, Params]:
        """One token per sequence over ``cache`` (updated in place)."""
        return transformer.decode_step(params, self.cfg, cache, tokens, cache_len, context=context)


def build(cfg: ModelConfig) -> Model:
    return Model(cfg)
