"""Flash attention: an online softmax over ``(q_chunk, kv_chunk)`` blocks
and its block-recomputing backward, the reference's ``repro.models.flash``
arithmetic in PyTorch.

Per query chunk, a running max ``m``, normaliser ``l`` and accumulator
``acc`` (all float32) are carried over the key chunks:

    s     = q k^T * hd^-0.5          (float32 products and sums)
    m'    = max(m, rowmax(s));  p = exp(s - m');  corr = exp(m - m')
    l'    = l * corr + rowsum(p);   acc' = acc * corr + p V

and the chunk's output is ``acc / max(l, 1e-30)``.  GQA: k/v carry KV
heads, broadcast to H heads one chunk at a time, so a full-length repeated
K/V never exists.  Masks (causal, sliding window, ``q_offset``) come from
absolute positions.  The accumulators are made ``*_like`` a block or an
input, so on DTensors they take that tensor's sharding.  The score and PV products take the reference's
``preferred_element_type=float32``: both operands are widened to float32
(exact for bf16) and summed in float32 (float64 inputs stay float64).

The backward (the reference's custom VJP, here a
``torch.autograd.Function``) keeps only ``(q, k, v, out, lse)`` from the
forward and recomputes each block's probabilities:

    delta = rowsum(dO * O)
    p     = exp(q k^T * scale - lse)
    ds    = p * (dO V^T - delta) * scale
    dq   += ds K;   dk += ds^T q;   dv += p^T dO

over key chunks outside and query chunks inside, each product in float32
from operands cast as the reference casts them (``ds`` and ``p`` to the
inputs' dtype).  GQA's dk/dv are summed over each KV head's group.  Only
q, k and v are differentiable; the other arguments are static.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window:
        m &= qpos[:, None] - kpos[None, :] < window
    return m


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype: float32, or float64 for float64 inputs (which
    the float64 gradient check feeds)."""
    return torch.promote_types(dtype, torch.float32)


def _f32_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(spec, a, b, preferred_element_type=float32)``."""
    w = _acc_dtype(torch.promote_types(a.dtype, b.dtype))
    return torch.einsum(spec, a.to(w), b.to(w))


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, KV, hd)
    v: torch.Tensor,  # (B, Sk, KV, hd)
    causal: bool,
    window: int,
    q_offset: int,
    q_chunk: int,
    kv_chunk: int,
) -> torch.Tensor:
    args = (causal, window, q_offset, q_chunk, kv_chunk)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Flash.apply(q, k, v, *args)
    out, _ = _flash_fwd_impl(q, k, v, *args)  # serving: nothing to save
    return out


class _Flash(torch.autograd.Function):
    """The reference's ``jax.custom_vjp`` with ``nondiff_argnums=(3..7)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, q_chunk, kv_chunk):
        out, lse = _flash_fwd_impl(q, k, v, causal, window, q_offset, q_chunk, kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_offset, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _flash_bwd_impl(*ctx.saved_tensors, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def _flash_fwd_impl(q, k, v, causal, window, q_offset, q_chunk, kv_chunk) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out (B, Sq, H, hd) in q's dtype, lse (B, H, Sq) float32)``."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    scale = hd**-0.5
    qc, kc = q_chunk, kv_chunk
    nq, nk = sq // qc, sk // kc
    dev, acc_t = q.device, _acc_dtype(q.dtype)

    outs, lses = [], []
    for qi in range(nq):
        qblk = q[:, qi * qc : (qi + 1) * qc]
        qpos = q_offset + qi * qc + torch.arange(qc, device=dev)
        m = l = acc = None  # made from the first block, so they take its layout
        for ki in range(nk):
            kblk = k[:, ki * kc : (ki + 1) * kc]
            vblk = v[:, ki * kc : (ki + 1) * kc]
            if rep > 1:  # GQA: broadcast KV -> H for this chunk only
                kblk = kblk.repeat_interleave(rep, dim=2, output_size=h)
                vblk = vblk.repeat_interleave(rep, dim=2, output_size=h)
            kpos = ki * kc + torch.arange(kc, device=dev)
            s = _f32_einsum("bqhd,bkhd->bhqk", qblk, kblk) * scale
            s = torch.where(_mask(qpos, kpos, causal, window)[None, None], s, NEG_INF)
            if m is None:
                m, l = torch.full_like(s[..., 0], NEG_INF), torch.zeros_like(s[..., 0])
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = _f32_einsum("bhqk,bkhd->bhqd", p.to(vblk.dtype), vblk)
            acc = (torch.zeros_like(pv) if acc is None else acc) * corr[..., None] + pv
            m = m_new
        l_safe = torch.clamp_min(l, 1e-30)
        outs.append((acc / l_safe[..., None]).to(q.dtype))  # (b, h, qc, hd)
        lses.append(m + torch.log(l_safe))  # (b, h, qc)
    out = torch.cat(outs, dim=2).transpose(1, 2)  # (b, sq, h, hd)
    return out, torch.cat(lses, dim=2)


def _flash_bwd_impl(q, k, v, out, lse, dout, causal, window, q_offset, q_chunk, kv_chunk):
    """``(dq, dk, dv)`` in the dtypes of q, k and v: the reference's
    ``_bwd``, its two scans as loops in the same order (key chunks outside,
    query chunks inside, each accumulator summed from zero)."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    scale = hd**-0.5
    qc, kc = q_chunk, kv_chunk
    nq, nk = sq // qc, sk // kc
    dev, acc_t = q.device, _acc_dtype(q.dtype)

    delta = _f32_einsum("bqhd,bqhd->bhq", dout, out)  # (b, h, sq)
    # per-chunk accumulators, joined at the end (no writes into slices, so
    # DTensors keep their sharding)
    dq = [torch.zeros_like(q[:, qi * qc : (qi + 1) * qc], dtype=acc_t) for qi in range(nq)]
    dk, dv = [], []
    for ki in range(nk):
        ks = slice(ki * kc, (ki + 1) * kc)
        kblk, vblk = k[:, ks], v[:, ks]
        if rep > 1:  # GQA: broadcast KV -> H for this chunk only
            kblk = kblk.repeat_interleave(rep, dim=2)
            vblk = vblk.repeat_interleave(rep, dim=2)
        kpos = ki * kc + torch.arange(kc, device=dev)
        dk_blk = torch.zeros_like(k[:, ks], dtype=acc_t)
        dv_blk = torch.zeros_like(v[:, ks], dtype=acc_t)
        for qi in range(nq):
            qs = slice(qi * qc, (qi + 1) * qc)
            qblk, doblk = q[:, qs], dout[:, qs]
            qpos = q_offset + qi * qc + torch.arange(qc, device=dev)
            s = _f32_einsum("bqhd,bkhd->bhqk", qblk, kblk) * scale
            s = torch.where(_mask(qpos, kpos, causal, window)[None, None], s, NEG_INF)
            p = torch.exp(s - lse[:, :, qs, None])  # (b, h, qc, kc)
            dp = _f32_einsum("bqhd,bkhd->bhqk", doblk, vblk)
            ds = p * (dp - delta[:, :, qs, None]) * scale
            dq_b = _f32_einsum("bhqk,bkhd->bqhd", ds.to(kblk.dtype), kblk)
            dk_b = _f32_einsum("bhqk,bqhd->bkhd", ds.to(qblk.dtype), qblk)
            dv_b = _f32_einsum("bhqk,bqhd->bkhd", p.to(doblk.dtype), doblk)
            if rep > 1:  # group-sum the broadcast back to KV heads
                dk_b = dk_b.reshape(b, kc, kvh, rep, hd).sum(3)
                dv_b = dv_b.reshape(b, kc, kvh, rep, hd).sum(3)
            dk_blk = dk_blk + dk_b
            dv_blk = dv_blk + dv_b
            dq[qi] = dq[qi] + dq_b
        dk.append(dk_blk)
        dv.append(dv_blk)
    return (torch.cat(dq, dim=1).to(q.dtype), torch.cat(dk, dim=1).to(k.dtype),
            torch.cat(dv, dim=1).to(v.dtype))


def ref_attention(q, k, v, *, causal: bool, window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Dense softmax oracle for tests (materialises full scores); k/v carry
    H heads."""
    hd = q.shape[-1]
    s = _f32_einsum("bqhd,bkhd->bhqk", q, k) * hd**-0.5
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    s = torch.where(_mask(qpos, kpos, causal, window)[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _f32_einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)
