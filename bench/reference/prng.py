"""Threefry-2x32 keys and draws as ``jax.random`` makes them (raw keys,
partitionable counters): the subset the samplers use.

A key is a ``(2,)`` int64 tensor of two uint32 words.  uint32 arithmetic
runs in int64 with ``& 0xFFFFFFFF`` masks, which every PyTorch device
supports.  Element i of a draw uses counter i, whatever the shape.
"""

from __future__ import annotations

import math

import torch

from bench.reference import f32

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x0, x1):
    """The 20-round Threefry-2x32 block function on uint32 words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: words (0, seed) in the int32 range,
    else the seed's high and low 32 bits."""
    seed = int(seed)
    if -(1 << 31) <= seed < (1 << 31):
        return torch.tensor([0, seed & M32], dtype=torch.int64)
    if 0 <= seed < (1 << 64):
        return torch.tensor([seed >> 32, seed & M32], dtype=torch.int64)
    raise ValueError(f"seed {seed} does not fit 64 bits")


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``(num, 2)`` keys, as ``jax.random.split``."""
    n = torch.arange(int(num), dtype=torch.int64)
    a, b = threefry2x32(k[0], k[1], n >> 32, n & M32)
    return torch.stack([a, b], dim=1)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` for a uint32 ``data``."""
    z = torch.zeros((), dtype=torch.int64)
    a, b = threefry2x32(k[0], k[1], z, torch.full((), int(data) & M32, dtype=torch.int64))
    return torch.stack([a, b])


def _counts(shape, device, offset: int = 0):
    c = torch.arange(offset, offset + math.prod(shape), dtype=torch.int64, device=device)
    return (c >> 32).reshape(shape), (c & M32).reshape(shape)


def bits32(k: torch.Tensor, shape, device=None) -> torch.Tensor:
    """uint32 bits as ``jax.random.bits(k, shape)``."""
    k = k.to(device) if device is not None else k
    hi, lo = _counts(tuple(shape), k.device)
    a, b = threefry2x32(k[0], k[1], hi, lo)
    return a ^ b


def bits64_scalar(k: torch.Tensor) -> int:
    """One ``jax.random.bits(k, (), uint64)`` as the int64 with its bits."""
    a, b = threefry2x32(k[0], k[1], torch.zeros((), dtype=torch.int64), torch.zeros((), dtype=torch.int64))
    v = (int(a) << 32) | int(b)
    return v - (1 << 64) if v >= 1 << 63 else v


def uniform(k: torch.Tensor, shape, *, minval: float = 0.0, device=None) -> torch.Tensor:
    """float32 uniforms in [minval, 1): the top 23 bits as a mantissa in
    [1, 2), minus one, then scaled by a fused multiply-add where minval is
    not 0 (the reference's compiled code fuses it)."""
    b = bits32(k, shape, device)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if minval != 0.0:
        lo = float(torch.tensor(minval, dtype=torch.float32))
        span = float(torch.tensor(1.0 - lo, dtype=torch.float32))
        f = f32.ftz(f32.fma(f, span, lo))
        return torch.clamp_min(f, lo)
    return f


_NORMAL_LO = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
_SQRT2 = float(torch.tensor(math.sqrt(2.0), dtype=torch.float32))


def normal(k: torch.Tensor, shape) -> torch.Tensor:
    """float32 standard normals, ``sqrt(2) * erf_inv(u)`` with u uniform in
    (-1, 1), as ``jax.random.normal``."""
    return _SQRT2 * f32.erf_inv(uniform(k, shape, minval=_NORMAL_LO))
