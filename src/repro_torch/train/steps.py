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

from repro_torch.dist.hints import is_dtensor, local_map, shard
from repro_torch.models.model import Model
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.train import optimizer as opt_lib

AUX_LOSS_COEF = 0.01


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean token NLL and accuracy; logits float32 (B, S, V), labels (B, S).

    The gold logit is the reference's masked sum over the vocab axis (not a
    gather), so the sum has the same terms.  DTensor logits go through
    :func:`_vocab_parallel_cross_entropy`, which never gathers the vocab."""
    if is_dtensor(logits):
        return _vocab_parallel_cross_entropy(logits, labels)
    logz = torch.logsumexp(logits, dim=-1)
    vocab_ids = torch.arange(logits.shape[-1], device=logits.device)
    hit = vocab_ids == labels[..., None]
    gold = torch.where(hit, logits, 0.0).sum(dim=-1)
    nll = torch.mean(logz - gold)
    acc = torch.mean((torch.argmax(logits, dim=-1) == labels).to(torch.float32))
    return nll, acc


def _all_reduce(x: torch.Tensor, op: str, groups) -> torch.Tensor:
    """``x`` reduced by ``op`` over each ``(mesh, mesh dim)`` of ``groups``."""
    import torch.distributed._functional_collectives as funcol

    for group in groups:
        x = funcol.wait_tensor(funcol.all_reduce(x, op, group))
    return x


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token NLL and correctness on one rank's vocab shard (B, S, V_r)
    whose first global vocab id is ``offset``: the max, the sum of
    exponentials and the gold logit are reduced over ``groups`` (the mesh
    dims that shard the vocab), so no rank holds more than its shard.  The
    gradient is softmax - onehot on the shard, scaled by the NLL's; it
    needs no collective.  Correctness is ``argmax == label`` with the
    argmax a (max value, lowest index) reduction, as ``torch.argmax`` picks
    the first of tied maxima."""

    @staticmethod
    def forward(ctx, logits, labels, offset, groups):
        local_max, local_idx = logits.max(dim=-1)
        top = _all_reduce(local_max, "max", groups)
        sumexp = _all_reduce(torch.exp(logits - top[..., None]).sum(dim=-1), "sum", groups)
        logz = top + torch.log(sumexp)
        hit = _vocab_ids(logits, offset) == labels[..., None]
        gold = _all_reduce(torch.where(hit, logits, 0.0).sum(dim=-1), "sum", groups)
        first = torch.where(local_max == top, local_idx + offset, torch.iinfo(torch.int64).max)
        correct = (_all_reduce(first, "min", groups) == labels).to(torch.float32)
        ctx.save_for_backward(logits, labels, logz)
        ctx.offset = offset
        ctx.mark_non_differentiable(correct)
        return logz - gold, correct

    @staticmethod
    def backward(ctx, grad_nll, _grad_correct):
        logits, labels, logz = ctx.saved_tensors
        g = grad_nll[..., None]
        hit = _vocab_ids(logits, ctx.offset) == labels[..., None]
        # the unsharded autograd's two terms, summed in its roundings
        grad = torch.exp(logits - logz[..., None]) * g + torch.where(hit, -g, 0.0)
        return grad, None, None, None


def _vocab_ids(logits: torch.Tensor, offset: int) -> torch.Tensor:
    return torch.arange(offset, offset + logits.shape[-1], device=logits.device)


def _vocab_parallel_cross_entropy(logits, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`cross_entropy` of DTensor logits: each rank works on its own
    vocab shard (``hints.local_map``), the reductions over the vocab's mesh
    dims are all-reduces of (B, S) tensors, and the per-token results are
    averaged as DTensors.  Equal to the unsharded loss up to the order of
    the vocab sums."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, vdim = logits.device_mesh, logits.ndim - 1
    in_pl = tuple(Replicate() if p.is_partial() else p for p in logits.placements)
    vocab_dims = [i for i, p in enumerate(in_pl) if p.is_shard(vdim)]
    tok_pl = tuple(Replicate() if i in vocab_dims else p for i, p in enumerate(in_pl))
    offset = compute_local_shape_and_global_offset(logits.shape, mesh, in_pl)[1][vdim]
    groups = [(mesh, i) for i in vocab_dims]
    nll_tok, correct = local_map(
        lambda lg, lb: _VocabParallelNLL.apply(lg, lb, offset, groups),
        (logits, labels), (in_pl, tok_pl), (tok_pl, tok_pl),
    )
    return torch.mean(nll_tok), torch.mean(correct)


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
