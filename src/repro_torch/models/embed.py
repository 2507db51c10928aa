"""The token embedding's gather, plain and vocab-parallel.

On plain tensors :func:`embed` is ``table[tokens]``.  On a DTensor table
(vocab over ``model``, d_model over ``data``: ``dist.sharding``'s
``("tp", "fsdp")``) each rank gathers from its own vocab shard
(``hints.local_map``), as the vocab-parallel loss in ``train.steps`` works
on its shard of the logits: DTensor's strategies for ``aten.index`` and
its ``index_put`` backward differ between torch releases, and some refuse
the production meshes' placements.
"""

from __future__ import annotations

import torch

from repro_torch.dist.hints import is_dtensor, local_map


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` (V, D) at ``tokens`` (B, S): (B, S, D).  For a
    DTensor table the result is ``Partial()`` over the mesh dims that
    shard the vocab; the caller's ``hints.shard`` reduces it."""
    if is_dtensor(table):
        return _vocab_parallel_embed(table, tokens)
    return table[tokens]


class _VocabParallelGather(torch.autograd.Function):
    """Rows of one rank's vocab shard (V_r, D), whose first global id is
    ``offset``, at the tokens in ``[offset, offset + V_r)``; zero rows for
    the others.  The backward adds the output's gradient into a zero
    (V_r, D) shard at the same rows."""

    @staticmethod
    def forward(ctx, table, tokens, offset):
        rows = tokens - offset
        miss = (rows < 0) | (rows >= table.shape[0])
        rows = rows.masked_fill(miss, 0)
        ctx.save_for_backward(rows, miss)
        ctx.table_shape = table.shape
        if table.shape[0] == 0:  # an uneven split can leave a rank no rows
            return table.new_zeros(tokens.shape + table.shape[1:])
        return table[rows].masked_fill(miss[..., None], 0)

    @staticmethod
    def backward(ctx, grad):
        rows, miss = ctx.saved_tensors
        d = ctx.table_shape[1]
        out = grad.new_zeros(ctx.table_shape)
        if out.shape[0]:
            out.index_add_(0, rows.reshape(-1), grad.masked_fill(miss[..., None], 0).reshape(-1, d))
        return out, None, None


def _vocab_parallel_embed(table, tokens) -> torch.Tensor:
    """:func:`embed` of a DTensor table: the table redistributed with
    d_model replicated (as FSDP gathers a weight) and the vocab kept on its
    mesh dims; the tokens keep their batch placements and are replicated
    over the vocab's dims.  The table's gradient is its shard's rows,
    ``Partial()`` over the dims that shard the tokens, which DTensor
    reduces back to the leaf's placements."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = table.device_mesh
    vocab_dims = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    table_pl = tuple(Shard(0) if i in vocab_dims else Replicate() for i in range(mesh.ndim))
    tok = tokens.placements if isinstance(tokens, DTensor) else (Replicate(),) * mesh.ndim
    tok_pl = tuple(Replicate() if i in vocab_dims or p.is_partial() else p for i, p in enumerate(tok))
    out_pl = tuple(Partial() if i in vocab_dims else p for i, p in enumerate(tok_pl))
    grad_pl = tuple(Shard(0) if i in vocab_dims else Partial() if p.is_shard() else Replicate()
                    for i, p in enumerate(tok_pl))
    offset = compute_local_shape_and_global_offset(table.shape, mesh, table_pl)[1][0]
    return local_map(
        lambda t, x: _VocabParallelGather.apply(t, x, offset),
        (table, tokens), (table_pl, tok_pl), out_pl, grad_placements=(grad_pl, None),
    )
