"""Train / prefill / decode steps: ``make_train_step``, ``make_prefill_step``
and ``make_decode_step`` return the closures the trainer and the serve loop
call (the reference's ``repro.train.steps``).

A train step is eager PyTorch: the loss's forward, ``torch.autograd.grad``
over the parameter leaves, then :func:`repro_torch.train.optimizer.update`.
Its metrics stay tensors on the device, so a step makes no host sync; the
caller's ``float(v)`` is the one wait (``dist.fault.TrainSupervisor``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.dist.hints import shard
from repro_torch.models.model import Model
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.train import optimizer as opt_lib

AUX_LOSS_COEF = 0.01


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean token NLL and accuracy; logits float32 (B, S, V), labels (B, S).

    The gold logit is the reference's masked sum over the vocab axis (not a
    gather), so the sum has the same terms."""
    logz = torch.logsumexp(logits, dim=-1)
    vocab_ids = torch.arange(logits.shape[-1], device=logits.device)
    hit = vocab_ids == labels[..., None]
    gold = torch.where(hit, logits, 0.0).sum(dim=-1)
    nll = torch.mean(logz - gold)
    acc = torch.mean((torch.argmax(logits, dim=-1) == labels).to(torch.float32))
    return nll, acc


def make_loss_fn(model: Model) -> Callable:
    """(params, batch) -> (loss, {"nll", "aux", "acc"})."""

    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch["tokens"], context=batch.get("context"))
        nll, acc = cross_entropy(logits, batch["labels"])
        loss = nll + AUX_LOSS_COEF * aux
        return loss, {"nll": nll, "aux": aux, "acc": acc}

    return loss_fn


def make_grad_fn(model: Model) -> Callable:
    """(params, batch) -> (loss, parts, grads): the reference's
    ``jax.value_and_grad(loss_fn, has_aux=True)``, with ``grads`` in the
    params' structure and dtypes.  Values come back detached."""
    loss_fn = make_loss_fn(model)

    def grad_fn(params, batch):
        with torch.enable_grad():
            live = tree_map(lambda t: t.detach().requires_grad_(True), params)
            loss, parts = loss_fn(live, batch)
            grads = iter(torch.autograd.grad(loss, list(tree_leaves(live))))
        grads = tree_map(lambda _: next(grads), live)
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads

    return grad_fn


def make_train_step(model: Model, opt_cfg: Optional[opt_lib.OptConfig] = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics)."""
    opt_cfg = opt_cfg or opt_lib.OptConfig()
    grad_fn = make_grad_fn(model)

    def train_step(params, opt_state, batch):
        loss, parts, grads = grad_fn(params, batch)
        with torch.no_grad():
            params, opt_state, opt_metrics = opt_lib.update(opt_cfg, grads, opt_state, params)
        return params, opt_state, {"loss": loss, **parts, **opt_metrics}

    return train_step


def make_prefill_step(model: Model, *, max_len: Optional[int] = None):
    """(params, batch) -> (logits, cache); ``batch["tokens"]`` (B, S) and
    the optional ``batch["context"]``."""

    def prefill_step(params, batch):
        return model.prefill(params, batch["tokens"], context=batch.get("context"), max_len=max_len)

    return prefill_step


def make_decode_step(model: Model):
    """One token in, one token out, greedy: (params, batch) -> (next_tok
    (B,) int32, logits (B, 1, V), cache); ``batch`` holds ``cache``,
    ``tokens`` (B, 1), ``cache_len`` and the optional ``context``."""

    def decode_step(params, batch):
        logits, cache = model.decode(params, batch["cache"], batch["tokens"], batch["cache_len"],
                                     context=batch.get("context"))
        # the vocab gathered first under a mesh: DTensor's argmax over a
        # sharded dim fails on a batch of one row a rank (long_500k)
        next_tok = torch.argmax(shard(logits[:, -1], "batch"), dim=-1).to(torch.int32)
        return next_tok, logits, cache

    return decode_step
