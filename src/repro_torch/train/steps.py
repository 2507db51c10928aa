"""Serving steps: ``make_prefill_step`` / ``make_decode_step`` return the
closures the serve loop calls (the reference's ``repro.train.steps``).

The loss and ``train_step`` wait for the training slice (ROADMAP queue 1
item 10.1.2).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.model import Model


def make_prefill_step(model: Model, *, max_len: Optional[int] = None):
    """(params, batch) -> (logits, cache); ``batch["tokens"]`` (B, S)."""

    def prefill_step(params, batch):
        return model.prefill(params, batch["tokens"], max_len=max_len)

    return prefill_step


def make_decode_step(model: Model):
    """One token in, one token out, greedy: (params, batch) -> (next_tok
    (B,) int32, logits (B, 1, V), cache); ``batch`` holds ``cache``,
    ``tokens`` (B, 1) and ``cache_len``."""

    def decode_step(params, batch):
        logits, cache = model.decode(params, batch["cache"], batch["tokens"], batch["cache_len"])
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, logits, cache

    return decode_step
