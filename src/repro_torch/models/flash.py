"""Flash attention, forward: an online softmax over ``(q_chunk, kv_chunk)``
blocks, the reference's ``repro.models.flash`` arithmetic in PyTorch.

Per query chunk, a running max ``m``, normaliser ``l`` and accumulator
``acc`` (all float32) are carried over the key chunks:

    s     = q k^T * hd^-0.5          (float32 products and sums)
    m'    = max(m, rowmax(s));  p = exp(s - m');  corr = exp(m - m')
    l'    = l * corr + rowsum(p);   acc' = acc * corr + p V

and the chunk's output is ``acc / max(l, 1e-30)``.  GQA: k/v carry KV
heads, broadcast to H heads one chunk at a time, so a full-length repeated
K/V never exists.  Masks (causal, sliding window, ``q_offset``) come from
absolute positions.  The score and PV products take the reference's
``preferred_element_type=float32``: both operands are widened to float32
(exact for bf16) and summed in float32.

The backward (the reference's custom VJP) belongs to training and is not
here.
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


def _f32_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(spec, a, b, preferred_element_type=float32)``."""
    return torch.einsum(spec, a.float(), b.float())


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
    out, _ = _flash_fwd_impl(q, k, v, causal, window, q_offset, q_chunk, kv_chunk)
    return out


def _flash_fwd_impl(q, k, v, causal, window, q_offset, q_chunk, kv_chunk) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out (B, Sq, H, hd) in q's dtype, lse (B, H, Sq) float32)``."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    scale = hd**-0.5
    qc, kc = q_chunk, kv_chunk
    nq, nk = sq // qc, sk // kc
    dev = q.device

    outs, lses = [], []
    for qi in range(nq):
        qblk = q[:, qi * qc : (qi + 1) * qc]
        qpos = q_offset + qi * qc + torch.arange(qc, device=dev)
        m = torch.full((b, h, qc), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, qc, hd), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kblk = k[:, ki * kc : (ki + 1) * kc]
            vblk = v[:, ki * kc : (ki + 1) * kc]
            if rep > 1:  # GQA: broadcast KV -> H for this chunk only
                kblk = kblk.repeat_interleave(rep, dim=2)
                vblk = vblk.repeat_interleave(rep, dim=2)
            kpos = ki * kc + torch.arange(kc, device=dev)
            s = _f32_einsum("bqhd,bkhd->bhqk", qblk, kblk) * scale
            s = torch.where(_mask(qpos, kpos, causal, window)[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = _f32_einsum("bhqk,bkhd->bhqd", p.to(vblk.dtype), vblk)
            acc = acc * corr[..., None] + pv
            m = m_new
        l_safe = torch.clamp_min(l, 1e-30)
        outs.append((acc / l_safe[..., None]).to(q.dtype))  # (b, h, qc, hd)
        lses.append(m + torch.log(l_safe))  # (b, h, qc)
    out = torch.cat(outs, dim=2).transpose(1, 2)  # (b, sq, h, hd)
    return out, torch.cat(lses, dim=2)


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
