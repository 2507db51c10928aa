"""Threefry-2x32 key stream, bit-identical to ``jax.random`` (raw keys,
``jax_threefry_partitionable=True``, the default of jax 0.5 and later).

A key is a ``(2,)`` int64 tensor holding two uint32 words, the same words
``jax.random.key_data`` shows for the reference's key.  Only the subset the
sampler uses is here: ``PRNGKey``, ``split``, ``fold_in``, ``key_data``,
``bits`` (uint32 / uint64), ``uniform`` and ``normal`` (float32) and
``randint`` (int32).

The partitionable counter of element i of a draw is its flat index i, so
element i does not depend on the shape: ``offset=o`` draws the elements
o, o + 1, ... of a longer draw, which lets a large batch be drawn in
chunks with the bits of one whole draw.

All uint32 arithmetic runs in int64 with ``& 0xFFFFFFFF`` masks: PyTorch's
CPU kernels do not implement ``>>``, ``+`` or ``%`` for uint32.  A uint64
result is returned as the int64 with the same 64 bits.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import math

import torch

from repro_torch.core import f32math

M32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)

Key = torch.Tensor
Shape = Union[int, Sequence[int]]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def _rounds(x0, x1, rots):
    for r in rots:
        x0 = (x0 + x1) & M32
        x1 = x0 ^ _rotl(x1, r)
    return x0, x1


def threefry2x32(
    k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block function (20 rounds) on uint32 words held in
    int64 tensors; ``k1``/``k2`` broadcast against the counts."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        x0, x1 = _rounds(x0, x1, _ROT0 if i % 2 == 0 else _ROT1)
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """Raw key for an integer seed, as ``jax.random.PRNGKey(seed)`` makes it
    (a seed in int32 range gives words ``(0, seed mod 2^32)``)."""
    seed = int(seed)
    if -(1 << 31) <= seed < (1 << 31):
        hi, lo = 0, seed & M32
    elif 0 <= seed < (1 << 64):
        hi, lo = seed >> 32, seed & M32
    else:
        raise ValueError(f"seed {seed} does not fit 64 bits")
    return torch.tensor([hi, lo], dtype=torch.int64)


def key_data(key: Key) -> Key:
    """The key's two uint32 words (keys are raw, so the key itself)."""
    return key


def _words(key: Key, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    key = torch.as_tensor(key, dtype=torch.int64)
    if key.shape != (2,):
        raise ValueError(f"a key is a (2,) tensor of uint32 words, got {tuple(key.shape)}")
    if device is not None:
        key = key.to(device)  # lint: disable=host-sync-in-step -- a host key's 16 bytes go to the draw's device once a draw
    return key[0], key[1]


def _iota_2x32(shape: Tuple[int, ...], device, offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    offset = int(offset)
    count = torch.arange(offset, offset + math.prod(shape), dtype=torch.int64, device=device)
    return (count >> 32).reshape(shape), (count & M32).reshape(shape)


def split(key: Key, num: int = 2) -> Key:
    """``(num, 2)`` keys, as ``jax.random.split(key, num)``."""
    k1, k2 = _words(key)
    hi, lo = _iota_2x32((int(num),), k1.device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=1)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    k1, k2 = _words(key)
    z = torch.zeros((), dtype=torch.int64, device=k1.device)
    d = torch.full((), int(data) & M32, dtype=torch.int64, device=k1.device)
    o0, o1 = threefry2x32(k1, k2, z, d)
    return torch.stack([o0, o1])


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)  # lint: disable=host-sync-in-step -- a shape of Python ints


def bits(
    key: Key, shape: Shape = (), dtype: str = "uint32", *, offset: int = 0, device=None
) -> torch.Tensor:
    """Random bits as ``jax.random.bits(key, shape, dtype)``: ``"uint32"``
    values in ``[0, 2^32)``, or ``"uint64"`` values as int64 bit patterns.
    ``offset`` starts at that flat element of the draw (uint32 only: a
    uint64 element takes two counters)."""
    if offset and dtype != "uint32":
        raise ValueError("offset= is supported for uint32 bits only")
    k1, k2 = _words(key, device)
    hi, lo = _iota_2x32(_shape(shape), k1.device, offset)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    if dtype == "uint32":
        return b1 ^ b2
    if dtype == "uint64":
        return (b1 << 32) | b2
    raise ValueError(f"dtype must be 'uint32' or 'uint64', got {dtype!r}")


def _f32_daz(x: float) -> float:
    """``x`` rounded to float32, a subnormal read as zero (the reference's
    compiled CPU code runs with denormals-are-zero)."""
    x = float(torch.tensor(x, dtype=torch.float32))
    return x * 0.0 if abs(x) < f32math._MIN_NORMAL else x


def uniform(
    key: Key,
    shape: Shape = (),
    *,
    minval: float = 0.0,
    maxval: float = 1.0,
    offset: int = 0,
    device=None,
) -> torch.Tensor:
    """float32 uniforms in ``[minval, maxval)``, as ``jax.random.uniform(key,
    shape, minval=minval, maxval=maxval)``: the top 23 bits become the
    mantissa of a float ``f`` in ``[1, 2)``, and the result is
    ``max(minval, (f - 1) * (maxval - minval) + minval)``.

    The reference runs this with denormals flushed to zero, so a subnormal
    ``minval`` (the naive sampler's 1e-38) counts as 0 and a zero draw stays
    0; so it does here, and the bits equal the reference's on every device.
    ``offset`` draws the elements from that flat index on (see the module
    docstring).
    """
    lo, hi = _f32_daz(minval), _f32_daz(maxval)
    span = _f32_daz(hi - lo)
    b = bits(key, shape, "uint32", offset=offset, device=device)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if (span, lo) != (1.0, 0.0):  # else exact: f * 1 + 0 = f
        f = f32math._ftz(f32math.fma(f, span, lo))  # fused, as the reference's code
    return torch.clamp_min(f, lo)


# jax draws a normal from uniform(nextafter(-1, 0), 1): the open interval
_NORMAL_LO = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
_SQRT2 = float(torch.tensor(math.sqrt(2.0), dtype=torch.float32))


def normal(key: Key, shape: Shape = (), *, offset: int = 0, device=None) -> torch.Tensor:
    """float32 standard normals as ``jax.random.normal(key, shape)``:
    ``sqrt(2) * erf_inv(u)`` with ``u`` uniform in ``(-1, 1)``, the inverse
    error function evaluated as the reference's compiled code evaluates it
    (``f32math.erf_inv``), so the bits are equal on every device.
    ``offset`` draws the elements from that flat index on, as in
    :func:`uniform`."""
    u = uniform(key, shape, minval=_NORMAL_LO, maxval=1.0, offset=offset, device=device)
    return _SQRT2 * f32math.erf_inv(u)


def randint(key: Key, shape: Shape, minval: int, maxval: int, *, device=None) -> torch.Tensor:
    """int32 integers in ``[minval, maxval)``, as ``jax.random.randint(key,
    shape, minval, maxval, dtype=jnp.int32)``: two uint32 draws from the
    halves of ``split(key)``, folded as ``(hi % span) * (2^32 % span) + lo %
    span`` in wrapping uint32 arithmetic, then ``% span`` (a span of 1 when
    ``maxval <= minval``).  Bounds must lie in the int32 range."""
    lo, hi = int(minval), int(maxval)
    if not (-(1 << 31) <= lo < (1 << 31) and -(1 << 31) <= hi < (1 << 31)):
        raise ValueError(f"bounds must lie in the int32 range, got [{lo}, {hi})")
    k1, k2 = split(key)
    higher = bits(k1, shape, device=device)
    lower = bits(k2, shape, device=device)
    span = (hi - lo) & M32 if hi > lo else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & M32) % span
    # the int64 product wraps mod 2^64, so its low 32 bits are the uint32 product's
    off = (((higher % span) * mult) & M32) + lower % span
    return (lo + (off & M32) % span).to(torch.int32)
