"""Dispatch to the port's kernels, plus the counter-PRNG helpers the core
engines share with them.

A kernel call goes by the device of its tensors: a CUDA tensor launches the
kernel, a CPU tensor runs the plain PyTorch version.  Unlike the
reference's ``ops`` there is nothing to pad: each CUDA kernel masks its own
ragged edge and works at the real attribute depth d.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import f32math, kpgm, magm, prng
from repro_torch.core.device import resolve_device
from repro_torch.kernels import bernoulli_tile as _bt
from repro_torch.kernels import exact_accept as _ea
from repro_torch.kernels import magm_logprob as _ml
from repro_torch.kernels import quadrant_descent as _qd

# the reference's opt-in for its hardware-PRNG kernel variant; here it
# selects the device-native Philox descent (quadrant_descent_native) for
# sample_edge_batch_prng(tpu_native=None)
TPU_NATIVE_PRNG = False

PRNG_CHANNELS = _qd.PRNG_CHANNELS
counter_seed = _qd.counter_seed
counter_hash = _qd.counter_hash
counter_u01 = _qd.counter_u01
counter_rank = _qd.counter_rank
descent_uniforms = _qd.descent_uniforms
rank_pair = _qd.rank_pair

quilt_prng_descent_lookup = _qd.quilt_prng_descent_lookup
quilt_prng_descent_lookup_plain = _qd.quilt_prng_descent_lookup_plain
quadrant_descent = _qd.quadrant_descent
quilt_descent_lookup = _qd.quilt_descent_lookup
exact_accept = _ea.exact_accept
exact_accept_plain = _ea.exact_accept_plain

# the reference draws the naive tile's uniforms over the shape padded to
# its (256, 256) Pallas blocks; the same draw gives the same mask
_DRAW_BLOCK = 256


def kernel_launches() -> dict:
    """Launch count of every kernel, by name."""
    return {
        "quilt_prng_descent_lookup": _qd.LAUNCHES,
        "quadrant_descent_prng": _qd.PRNG_LAUNCHES,
        "magm_logprob": _ml.LAUNCHES,
        "bernoulli_tile": _bt.LAUNCHES,
        "quadrant_descent": _qd.DESCENT_LAUNCHES,
        "quilt_descent_lookup": _qd.LOOKUP_LAUNCHES,
        "quadrant_descent_native": _qd.NATIVE_LAUNCHES,
        "exact_accept": _ea.LAUNCHES,
    }


def reset_kernel_launches() -> None:
    """Set every kernel's launch count to 0."""
    _qd.LAUNCHES = 0
    _qd.PRNG_LAUNCHES = 0
    _ml.LAUNCHES = 0
    _bt.LAUNCHES = 0
    _qd.DESCENT_LAUNCHES = 0
    _qd.LOOKUP_LAUNCHES = 0
    _qd.NATIVE_LAUNCHES = 0
    _ea.LAUNCHES = 0


def _batch_cumprobs(thetas) -> torch.Tensor:
    """(d, 4) cumulative quadrant probabilities as the reference's
    ``sample_edge_batch_prng`` computes them, eagerly: each level's sum and
    its cumulative sum run sequentially from index 0."""
    f = torch.as_tensor(thetas, dtype=torch.float32).reshape(-1, 4)
    q = f / (((f[:, 0] + f[:, 1]) + f[:, 2]) + f[:, 3])[:, None]
    c1 = q[:, 0] + q[:, 1]
    c2 = c1 + q[:, 2]
    return torch.stack([q[:, 0], c1, c2, c2 + q[:, 3]], dim=1).contiguous()


def sample_edge_batch_prng(
    key: torch.Tensor,
    thetas,
    num_edges: int,
    *,
    tpu_native: Optional[bool] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counter-PRNG Algorithm-1 batch of ``num_edges`` KPGM candidate edges:
    int32 ``(src, dst)`` on ``device`` (default ``"cuda"``; raises without a
    card), equal to the reference's for the same key.  Slot s draws from
    channel words s * 64 + k of graph 0, so a longer batch extends a shorter
    one.

    ``tpu_native`` keeps the reference's name (None follows
    ``TPU_NATIVE_PRNG``).  There it runs the TPU's hardware PRNG; on the
    H100, which has none, True runs the device-native variant: the kernel
    ``quadrant_descent_native`` draws each slot's uniforms from an in-kernel
    Philox4x32-10 stream keyed by the same seed words.  Its bits are neither
    the TPU's nor the counter hash's; its law is the same (the 3-sigma
    suite), and a shorter batch is still a prefix of a longer one."""
    dev = resolve_device(device)
    cum = _batch_cumprobs(thetas).to(dev)
    native = TPU_NATIVE_PRNG if tpu_native is None else bool(tpu_native)
    return _qd.quadrant_descent_prng(counter_seed(key), cum, num_slots=int(num_edges), tpu_native=native)


def sample_edge_batch(key: torch.Tensor, thetas, num_edges: int, *, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Algorithm-1 batch of ``num_edges`` KPGM candidate edges from the
    threefry uniforms of ``key``: int32 ``(src, dst)`` on ``device``
    (default ``"cuda"``; raises without a card), equal to the reference's
    ``sample_edge_batch_pallas`` for the same key.  The (num_edges, d) draw
    goes to the ``quadrant_descent`` kernel in row chunks (see
    ``kpgm.descend_draw``); the reference pads the draw to 512 rows, which
    changes none of the first num_edges rows, so nothing is padded here.
    ``cum`` is computed eagerly, as that function computes it."""
    dev = resolve_device(device)
    return kpgm.descend_draw(key, _batch_cumprobs(thetas).to(dev), int(num_edges))  # lint: disable=host-sync-in-step -- the level table, computed on the host in the reference's order


def _packed_bilinear(thetas, device) -> Tuple[torch.Tensor, ...]:
    """(u, v, w, c0) of the bilinear form as contiguous float32 on device."""
    bl = magm.bilinear_decompose(thetas)
    return tuple(t.to(device=device, dtype=torch.float32).contiguous() for t in (bl.u, bl.v, bl.w, bl.c0))


def _attributes(F_src, F_dst) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both attribute blocks as contiguous float32 on F_src's device."""
    if not isinstance(F_src, torch.Tensor):
        raise TypeError(f"F_src must be a torch.Tensor (its device picks the kernel), got {type(F_src)}")
    fs = F_src.to(torch.float32).contiguous()
    ft = torch.as_tensor(F_dst).to(device=fs.device, dtype=torch.float32).contiguous()  # lint: disable=host-sync-in-step -- a no-op for F on the card; a host F_dst is copied once a call
    return fs, ft


def magm_logprob(F_src, F_dst, thetas) -> torch.Tensor:
    """(ns, d), (nt, d) attributes -> (ns, nt) float32 log Q through the tile
    kernel on F_src's device (the reference's ``magm_logprob_pallas``)."""
    fs, ft = _attributes(F_src, F_dst)
    return _ml.magm_logprob(fs, ft, *_packed_bilinear(thetas, fs.device))


def bernoulli_sample(key: torch.Tensor, F_src, F_dst, thetas) -> torch.Tensor:
    """Fused naive-baseline tile on F_src's device: (ns, nt) int8 adjacency
    sampled from Q (the reference's ``bernoulli_sample_pallas``).

    The log-uniforms are drawn over the shape rounded up to multiples of 256,
    as the reference draws them, and the kernel reads the (ns, nt) corner of
    that draw in place, so the same key gives the same mask."""
    fs, ft = _attributes(F_src, F_dst)
    ns, nt = fs.shape[0], ft.shape[0]
    shape = tuple(-(-m // _DRAW_BLOCK) * _DRAW_BLOCK for m in (ns, nt))
    logu = f32math.log(prng.uniform(key, shape, minval=1e-38, maxval=1.0, device=fs.device))
    return _bt.bernoulli_tile(fs, ft, *_packed_bilinear(thetas, fs.device), logu[:ns, :nt])
