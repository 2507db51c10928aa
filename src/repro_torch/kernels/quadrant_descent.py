"""Quadrant descent, with and without the per-block lookup: the CUDA
kernels' wrappers, their plain PyTorch versions, and the counter-hash
family.

Candidate row ``s`` of graph ``g`` draws its level-``k`` uniform from
``counter_u01(seed, g, s * PRNG_CHANNELS + k)``, a pure function of the round
key's two words, the global graph id and the candidate's absolute slot, so
every device and every layout of the graphs sees the same stream.  The hash
family below is bit-identical to the reference's
(``repro/kernels/quadrant_descent.py``); uint32 arithmetic runs in int64
with ``& 0xFFFFFFFF`` masks, which PyTorch supports on every device.

:func:`quilt_prng_descent_lookup` runs the CUDA kernel
(``csrc/quilt_prng_descent_lookup.cu``) on a CUDA tensor and its plain
version :func:`quilt_prng_descent_lookup_plain` on a CPU tensor.
:func:`quadrant_descent_prng` (``csrc/quadrant_descent_prng.cu``, plain
version :func:`quadrant_descent_prng_plain`) is the plain KPGM descent of
a batch of slots of graph 0, with no lookup.  Its ``tpu_native=True``
variant, :func:`quadrant_descent_native` (``csrc/quadrant_descent_native.cu``,
plain version :func:`quadrant_descent_native_plain`), draws the uniforms
from a Philox4x32-10 stream (:func:`philox4x32`) in place of the TPU's
hardware PRNG.

The two older kernels read their uniforms from an ``(N, d)`` float32
operand instead (the threefry draws of the ranked host rounds):
:func:`quadrant_descent` (``csrc/quadrant_descent.cu``) descends it, and
:func:`quilt_descent_lookup` (``csrc/quilt_descent_lookup.cu``) also looks
each config up in the block rows ``kb``/``lb`` of the tables; their plain
versions are :func:`quadrant_descent_plain` and
:func:`quilt_descent_lookup_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

M32 = 0xFFFFFFFF

# channels reserved per candidate slot: 0..d-1 carry the descent uniforms,
# the last two the ball-dropping block ranks
PRNG_CHANNELS = 64
_RANK0 = PRNG_CHANNELS - 2

# lowbias32 avalanche multipliers plus the word / graph stream separators
_MIX_A = 0x7FEB352D
_MIX_B = 0x846CA68B
_WORD_C = 0x9E3779B9
_GID_C = 0x85EBCA6B

_TWO_M24 = 2.0**-24

Seed = Tuple[int, int]


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = (x * _MIX_A) & M32
    x = x ^ (x >> 15)
    x = (x * _MIX_B) & M32
    return x ^ (x >> 16)


def counter_hash(s0, s1, gid: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
    """uint32 hash (in int64) of the counter ``(seed words, graph, word)``."""
    gid = gid.to(torch.int64) & M32
    x = _mix32((word.to(torch.int64) * _WORD_C + s0) & M32)
    x = x ^ ((gid * _GID_C + s1) & M32)
    return _mix32(x)


def counter_u01(s0, s1, gid: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
    """float32 uniform in [0, 1) from the hash's top 24 bits (exact)."""
    return (counter_hash(s0, s1, gid, word) >> 8).to(torch.float32) * _TWO_M24


def counter_rank(s0, s1, gid, word, num_blocks: int) -> torch.Tensor:
    """int32 rank in [0, num_blocks) from 31 hash bits."""
    return ((counter_hash(s0, s1, gid, word) >> 1) % int(num_blocks)).to(torch.int32)


def counter_seed(key: torch.Tensor) -> Seed:
    """The counter hash's two seed words (uint32 ints) from a key."""
    words = torch.as_tensor(key, dtype=torch.int64).reshape(-1)[-2:].tolist()  # lint: disable=host-sync-in-step -- the seed words are kernel arguments; the sessions' keys live on the host
    return words[0] & M32, words[1] & M32


def descent_uniforms(s0, s1, gid: torch.Tensor, slot: torch.Tensor, d: int) -> torch.Tensor:
    """(N, d) float32 descent uniforms for channels 0..d-1 of each slot."""
    ch = torch.arange(d, dtype=torch.int64, device=slot.device)
    word = slot.to(torch.int64).reshape(-1, 1) * PRNG_CHANNELS + ch[None, :]
    return counter_u01(s0, s1, gid.reshape(-1, 1), word)


def rank_pair(s0, s1, gid, slot, num_blocks: int):
    """(kb, lb) block ranks from the two reserved rank channels."""
    base = slot.to(torch.int64) * PRNG_CHANNELS
    kb = counter_rank(s0, s1, gid, base + _RANK0, num_blocks)
    lb = counter_rank(s0, s1, gid, base + _RANK0 + 1, num_blocks)
    return kb, lb


def _descend_body(u: torch.Tensor, cum: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, d) uniforms + (d, 4) cumulative probs -> int32 (src, dst) configs;
    level 0 is the most significant bit."""
    quad = (u >= cum[None, :, 0]).to(torch.int64)
    quad = quad + (u >= cum[None, :, 1]) + (u >= cum[None, :, 2])
    d = u.shape[1]
    pows = torch.ones((), dtype=torch.int64, device=u.device) << torch.arange(
        d - 1, -1, -1, device=u.device
    )
    src = ((quad >> 1) * pows).sum(dim=1)
    dst = ((quad & 1) * pows).sum(dim=1)
    return src.to(torch.int32), dst.to(torch.int32)


def _block_pairs(s0, s1, gid, base, num_blocks: int, ranks: bool):
    if ranks:
        kb = counter_rank(s0, s1, gid, base + _RANK0, num_blocks)
        lb = counter_rank(s0, s1, gid, base + _RANK0 + 1, num_blocks)
        return kb.to(torch.int64), lb.to(torch.int64)
    blk = gid % (num_blocks * num_blocks)
    kb = blk // num_blocks
    return kb, blk - kb * num_blocks


def _lookup(table_cfg: torch.Tensor, table_node: torch.Tensor, row, target):
    """Lower bound of ``target`` in row ``row`` of the ascending (B, L)
    tables, clamped to L - 1; the node id on an exact hit, else -1 (also
    for a row outside [0, B))."""
    B, L = table_cfg.shape
    cfg = table_cfg.to(torch.int64)
    inside = (row >= 0) & (row < B)
    row = torch.where(inside, row, torch.zeros_like(row))
    rows = torch.arange(B, dtype=torch.int64, device=cfg.device)
    flat = ((rows[:, None] << 32) | cfg).reshape(-1)  # ascending overall
    pos = torch.searchsorted(flat, (row << 32) | target) - row * L
    idx = row * L + pos.clamp_max(L - 1)
    hit = (cfg.reshape(-1)[idx] == target) & inside
    node = table_node.reshape(-1)[idx]
    return torch.where(hit, node, torch.full_like(node, -1))


def quilt_prng_descent_lookup_plain(
    seed: Seed,
    gids: torch.Tensor,
    cum: torch.Tensor,
    table_cfg: torch.Tensor,
    table_node: torch.Tensor,
    *,
    a_tot: int,
    num_blocks: int,
    ranks: bool = False,
):
    """The kernel's function in plain PyTorch, on any device.

    Row ``r`` of the ``gids.numel() * a_tot`` rows is slot ``r % a_tot`` of
    graph ``gids[r // a_tot]``.  Returns ``(src_cfg, dst_cfg, src_node,
    dst_node)``, each int32, node -1 where the config is not in the block.
    Levels are hashed one at a time, so memory stays O(rows).
    """
    s0, s1 = seed
    dev = gids.device
    n = gids.numel() * int(a_tot)
    row = torch.arange(n, dtype=torch.int64, device=dev)
    local = row // a_tot
    gid = gids.reshape(-1).to(torch.int64)[local]
    base = (row - local * a_tot) * PRNG_CHANNELS
    del row, local
    scfg = torch.zeros(n, dtype=torch.int64, device=dev)
    dcfg = torch.zeros(n, dtype=torch.int64, device=dev)
    for k in range(cum.shape[0]):
        u = counter_u01(s0, s1, gid, base + k)
        quad = (u >= cum[k, 0]).to(torch.int64) + (u >= cum[k, 1]) + (u >= cum[k, 2])
        scfg = (scfg << 1) | (quad >> 1)
        dcfg = (dcfg << 1) | (quad & 1)
    kb, lb = _block_pairs(s0, s1, gid, base, int(num_blocks), ranks)
    snode = _lookup(table_cfg, table_node, kb, scfg)
    dnode = _lookup(table_cfg, table_node, lb, dcfg)
    return scfg.to(torch.int32), dcfg.to(torch.int32), snode, dnode


# launches of each CUDA kernel since import (or since a caller reset it);
# only the CUDA branch of quilt_prng_descent_lookup adds to LAUNCHES, only
# that of quadrant_descent_prng to PRNG_LAUNCHES, of quadrant_descent to
# DESCENT_LAUNCHES, of quilt_descent_lookup to LOOKUP_LAUNCHES and of
# quadrant_descent_native to NATIVE_LAUNCHES
LAUNCHES = 0
PRNG_LAUNCHES = 0
DESCENT_LAUNCHES = 0
LOOKUP_LAUNCHES = 0
NATIVE_LAUNCHES = 0

_LIB = None
_PRNG_LIB = None
_DESCENT_LIB = None
_LOOKUP_LIB = None
_NATIVE_LIB = None


def _library():
    """The built kernel library with its C signatures declared."""
    global _LIB
    if _LIB is None:
        lib = _build.load("quilt_prng_descent_lookup")
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        fn = lib.qkg_quilt_prng_descent_lookup
        fn.argtypes = [i, u, u, p, i, p, i, p, p, i, i, i, i, i, p, p, p, p, p]
        fn.restype = i
        lib.qkg_error_string.argtypes = [i]
        lib.qkg_error_string.restype = ctypes.c_char_p
        lib.qkg_tables_in_smem.argtypes = [i, i, i]
        lib.qkg_tables_in_smem.restype = i
        _LIB = lib
    return _LIB


def tables_in_shared_memory(table_cfg: torch.Tensor) -> bool:
    """Whether the kernel keeps these (B, L) tables in shared memory."""
    B, L = table_cfg.shape
    return _library().qkg_tables_in_smem(table_cfg.device.index or 0, B, L) == 1


def _check_cum(cum: torch.Tensor) -> None:
    if cum.dtype != torch.float32:
        raise TypeError(f"cum must be float32, got {cum.dtype}")
    if not cum.is_contiguous():
        raise ValueError("cum must be contiguous")
    d = cum.shape[0]
    if cum.shape != (d, 4) or not 1 <= d <= 31:
        raise ValueError(f"cum must be (d, 4) with 1 <= d <= 31, got {tuple(cum.shape)}")


def _check_cuda_inputs(gids, cum, table_cfg, table_node, a_tot, num_blocks):
    dev = gids.device
    for name, t, dtype in (
        ("gids", gids, torch.int32),
        ("cum", cum, torch.float32),
        ("table_cfg", table_cfg, torch.int32),
        ("table_node", table_node, torch.int32),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, gids on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_cum(cum)
    if table_cfg.ndim != 2 or table_cfg.shape != table_node.shape or 0 in table_cfg.shape:
        raise ValueError(
            f"tables must be two equal non-empty (B, L), got "
            f"{tuple(table_cfg.shape)} and {tuple(table_node.shape)}"
        )
    if not 1 <= num_blocks <= table_cfg.shape[0]:
        raise ValueError(f"num_blocks={num_blocks} outside [1, B={table_cfg.shape[0]}]")
    if gids.numel() * a_tot >= 2**31:
        raise ValueError("gids.numel() * a_tot must stay below 2^31 rows")


def quilt_prng_descent_lookup(
    seed: Seed,
    gids: torch.Tensor,
    cum: torch.Tensor,
    table_cfg: torch.Tensor,
    table_node: torch.Tensor,
    *,
    a_tot: int,
    num_blocks: int,
    ranks: bool = False,
):
    """Fused descent + lookup over ``gids.numel() * a_tot`` rows.

    On a CUDA tensor this launches the CUDA kernel on the current stream and
    raises if the launch fails; on a CPU tensor it is the plain version.
    Args as :func:`quilt_prng_descent_lookup_plain`; on CUDA ``gids`` and the
    tables are contiguous int32 and ``cum`` float32, all on one device.
    """
    global LAUNCHES
    dev = gids.device
    if dev.type == "cpu":
        return quilt_prng_descent_lookup_plain(
            seed, gids, cum, table_cfg, table_node,
            a_tot=a_tot, num_blocks=num_blocks, ranks=ranks,
        )
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    a_tot, num_blocks = int(a_tot), int(num_blocks)
    gids = gids.reshape(-1)
    _check_cuda_inputs(gids, cum, table_cfg, table_node, a_tot, num_blocks)
    n = gids.numel() * a_tot
    outs = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(4)]
    if n == 0:
        return tuple(outs)
    lib = _library()
    B, L = table_cfg.shape
    rc = lib.qkg_quilt_prng_descent_lookup(
        _build.device_index(dev),
        seed[0] & M32, seed[1] & M32,
        gids.data_ptr(), gids.numel(), cum.data_ptr(), cum.shape[0],
        table_cfg.data_ptr(), table_node.data_ptr(), B, L, a_tot, num_blocks,
        int(bool(ranks)),
        *(o.data_ptr() for o in outs),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        msg = lib.qkg_error_string(rc).decode()
        raise RuntimeError(f"quilt_prng_descent_lookup launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return tuple(outs)


def quadrant_descent_prng_plain(
    seed: Seed, cum: torch.Tensor, *, num_slots: int, chunk: int = 1 << 20
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, on ``cum``'s device.

    Slot ``s`` descends with the uniforms of channels 0..d-1 of graph 0,
    ``counter_u01(seed, 0, s * PRNG_CHANNELS + k)``.  Returns int32 ``(src,
    dst)`` of ``num_slots`` candidates; slots go ``chunk`` at a time, so
    memory stays O(num_slots).
    """
    s0, s1 = seed
    dev = cum.device
    num_slots = int(num_slots)
    src = torch.empty(num_slots, dtype=torch.int32, device=dev)
    dst = torch.empty(num_slots, dtype=torch.int32, device=dev)
    gid = torch.zeros((), dtype=torch.int64, device=dev)
    for a in range(0, num_slots, chunk):
        b = min(a + chunk, num_slots)
        slot = torch.arange(a, b, dtype=torch.int64, device=dev)
        src[a:b], dst[a:b] = _descend_body(descent_uniforms(s0, s1, gid, slot, cum.shape[0]), cum)
    return src, dst


def _prng_library():
    """The built kernel library of quadrant_descent_prng."""
    global _PRNG_LIB
    if _PRNG_LIB is None:
        lib = _build.load("quadrant_descent_prng")
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.qkg_quadrant_descent_prng.argtypes = [i, u, u, p, i, i, p, p, p]
        lib.qkg_quadrant_descent_prng.restype = i
        lib.qkg_error_string.argtypes = [i]
        lib.qkg_error_string.restype = ctypes.c_char_p
        _PRNG_LIB = lib
    return _PRNG_LIB


def quadrant_descent_prng(
    seed: Seed, cum: torch.Tensor, *, num_slots: int, tpu_native: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counter-PRNG quadrant descent of ``num_slots`` candidates: int32
    ``(src, dst)`` configs.

    On a CUDA tensor this launches the CUDA kernel on the current stream and
    raises if the launch fails; on a CPU tensor it is the plain version.
    ``tpu_native=True`` keeps the reference's name for its hardware-PRNG
    variant; on the H100 it selects :func:`quadrant_descent_native`, the
    descent on an in-kernel Philox4x32-10 stream, whose bits differ from the
    counter hash's (its law is held by the 3-sigma suite).
    """
    global PRNG_LAUNCHES
    if tpu_native:
        return quadrant_descent_native(seed, cum, num_slots=num_slots)
    dev = cum.device
    if dev.type == "cpu":
        return quadrant_descent_prng_plain(seed, cum, num_slots=num_slots)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    _check_cum(cum)
    n = _check_slots(num_slots)
    src = torch.empty(n, dtype=torch.int32, device=dev)
    dst = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return src, dst
    lib = _prng_library()
    rc = lib.qkg_quadrant_descent_prng(
        _build.device_index(dev),
        seed[0] & M32, seed[1] & M32, cum.data_ptr(), cum.shape[0], n,
        src.data_ptr(), dst.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        msg = lib.qkg_error_string(rc).decode()
        raise RuntimeError(f"quadrant_descent_prng launch failed: {msg} ({rc})")
    PRNG_LAUNCHES += 1
    return src, dst


def _check_slots(num_slots: int) -> int:
    n = int(num_slots)
    if not 0 <= n < 2**31:
        raise ValueError(f"num_slots must lie in [0, 2^31), got {n}")
    return n


# --- the device-native variant: Philox4x32-10 in place of the TPU's PRNG ---

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) uint32 halves of the 64-bit product of the constant ``a`` and
    the uint32 values ``b`` (in int64), from two products of a 16-bit half of
    ``a`` with ``b``, so no int64 intermediate overflows."""
    t = (a & 0xFFFF) * b
    mid = (a >> 16) * b + (t >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (t & 0xFFFF)


def philox4x32(ctr, key) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 of four uint32 counter words and two key words (each a
    tensor or int, uint32 values in int64; they broadcast): the four output
    words.  Equal to Random123's philox4x32 with 10 rounds and to the CUDA
    kernel's ``csrc/philox.cuh``."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    # an int key word stays a Python int (a scalar operand, no copy to the device)
    k0, k1 = (k.to(device=c0.device, dtype=torch.int64) if isinstance(k, torch.Tensor) else int(k) for k in key)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & M32, (k1 + _PHILOX_W[1]) & M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def native_uniforms(seed: Seed, slot: torch.Tensor, d: int) -> torch.Tensor:
    """(N, d) float32 uniforms of the device-native stream: slot s calls
    Philox with key ``seed`` and counter (s, j, 0, 0) for j < ceil(d / 4),
    level k takes word k % 4 of call k // 4, u = (bits >> 8) * 2^-24."""
    slot = slot.to(torch.int64)
    zero = torch.zeros_like(slot)
    words = []
    for j in range(-(-d // 4)):
        words.extend(philox4x32((slot, zero + j, zero, zero), seed))
    bits = torch.stack(words[:d], dim=1)
    return (bits >> 8).to(torch.float32) * _TWO_M24


def quadrant_descent_native_plain(
    seed: Seed, cum: torch.Tensor, *, num_slots: int, chunk: int = 1 << 20
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The native kernel's function in plain PyTorch, on ``cum``'s device:
    the descent of :func:`native_uniforms` for slots 0 .. num_slots - 1,
    ``chunk`` slots at a time.  Returns int32 ``(src, dst)``."""
    dev = cum.device
    num_slots = int(num_slots)
    src = torch.empty(num_slots, dtype=torch.int32, device=dev)
    dst = torch.empty(num_slots, dtype=torch.int32, device=dev)
    for a in range(0, num_slots, chunk):
        slot = torch.arange(a, min(a + chunk, num_slots), dtype=torch.int64, device=dev)
        src[a : a + slot.numel()], dst[a : a + slot.numel()] = _descend_body(
            native_uniforms(seed, slot, cum.shape[0]), cum
        )
    return src, dst


def _native_library():
    """The built kernel library of quadrant_descent_native."""
    global _NATIVE_LIB
    if _NATIVE_LIB is None:
        lib = _build.load("quadrant_descent_native")
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.qkg_quadrant_descent_native.argtypes = [i, u, u, p, i, i, p, p, p]
        lib.qkg_quadrant_descent_native.restype = i
        lib.qkg_error_string.argtypes = [i]
        lib.qkg_error_string.restype = ctypes.c_char_p
        _NATIVE_LIB = lib
    return _NATIVE_LIB


def quadrant_descent_native(
    seed: Seed, cum: torch.Tensor, *, num_slots: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quadrant descent of ``num_slots`` candidates on the device-native
    Philox stream: int32 ``(src, dst)`` configs.

    On a CUDA tensor this launches ``csrc/quadrant_descent_native.cu`` on the
    current stream and raises if the launch fails; on a CPU tensor it is
    :func:`quadrant_descent_native_plain`.
    """
    global NATIVE_LAUNCHES
    dev = cum.device
    if dev.type == "cpu":
        return quadrant_descent_native_plain(seed, cum, num_slots=num_slots)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    _check_cum(cum)
    n = _check_slots(num_slots)
    src = torch.empty(n, dtype=torch.int32, device=dev)
    dst = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return src, dst
    lib = _native_library()
    rc = lib.qkg_quadrant_descent_native(
        _build.device_index(dev),
        seed[0] & M32, seed[1] & M32, cum.data_ptr(), cum.shape[0], n,
        src.data_ptr(), dst.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "quadrant_descent_native")
    NATIVE_LAUNCHES += 1
    return src, dst


def quadrant_descent_plain(u: torch.Tensor, cum: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: (N, d) float32 uniforms and
    the (d, 4) cumulative table -> int32 ``(src, dst)``, on u's device."""
    return _descend_body(u, cum.to(u.device))  # lint: disable=host-sync-in-step -- plain version: a no-op for the card's table


def quilt_descent_lookup_plain(
    u: torch.Tensor,
    cum: torch.Tensor,
    kb: torch.Tensor,
    lb: torch.Tensor,
    table_cfg: torch.Tensor,
    table_node: torch.Tensor,
):
    """The kernel's function in plain PyTorch: the descent of
    :func:`quadrant_descent_plain`, then each row's src config looked up in
    row ``kb`` and its dst config in row ``lb`` of the (B, L) tables.
    Returns int32 ``(src_cfg, dst_cfg, src_node, dst_node)``, node -1 where
    the config is not in the block."""
    scfg, dcfg = _descend_body(u, cum.to(u.device))  # lint: disable=host-sync-in-step -- plain version: a no-op for the card's table
    snode = _lookup(table_cfg, table_node, kb.reshape(-1).to(torch.int64), scfg.to(torch.int64))
    dnode = _lookup(table_cfg, table_node, lb.reshape(-1).to(torch.int64), dcfg.to(torch.int64))
    return scfg, dcfg, snode, dnode


def _uniforms_library(name: str):
    """The built library of ``csrc/<name>.cu`` with its C signatures."""
    lib = _build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "quadrant_descent":
        lib.qkg_quadrant_descent.argtypes = [i, p, p, i, i, p, p, p]
        lib.qkg_quadrant_descent.restype = i
    else:
        lib.qkg_quilt_descent_lookup.argtypes = [i, p, p, i, p, p, p, p, p, i, i, i, p, p, p, p, p]
        lib.qkg_quilt_descent_lookup.restype = i
        lib.qkg_descent_tables_in_smem.argtypes = [i, i, i, i]
        lib.qkg_descent_tables_in_smem.restype = i
    lib.qkg_error_string.argtypes = [i]
    lib.qkg_error_string.restype = ctypes.c_char_p
    return lib


def _descent_library():
    global _DESCENT_LIB
    if _DESCENT_LIB is None:
        _DESCENT_LIB = _uniforms_library("quadrant_descent")
    return _DESCENT_LIB


def _lookup_library():
    global _LOOKUP_LIB
    if _LOOKUP_LIB is None:
        _LOOKUP_LIB = _uniforms_library("quilt_descent_lookup")
    return _LOOKUP_LIB


def descent_tables_in_shared_memory(d: int, table_cfg: torch.Tensor) -> bool:
    """Whether quilt_descent_lookup keeps these (B, L) tables in shared
    memory at depth ``d``."""
    B, L = table_cfg.shape
    return _lookup_library().qkg_descent_tables_in_smem(table_cfg.device.index or 0, int(d), B, L) == 1


def _check_uniforms(u: torch.Tensor, cum: torch.Tensor) -> None:
    _check_cum(cum)
    if u.dtype != torch.float32 or not u.is_contiguous():
        raise TypeError(f"u must be contiguous float32, got {u.dtype}")
    if u.ndim != 2 or u.shape[1] != cum.shape[0]:
        raise ValueError(f"u must be (N, {cum.shape[0]}), got {tuple(u.shape)}")
    if cum.device != u.device:
        raise ValueError(f"cum is on {cum.device}, u on {u.device}")
    if u.shape[0] >= 2**31:
        raise ValueError("u must have fewer than 2^31 rows")


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.qkg_error_string(rc).decode()} ({rc})")


def quadrant_descent(u: torch.Tensor, cum: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quadrant descent of an (N, d) float32 uniforms operand: int32
    ``(src, dst)``.

    On a CUDA tensor this launches the CUDA kernel on the current stream and
    raises if the launch fails; on a CPU tensor it is the plain version.
    On CUDA ``u`` is contiguous and ``cum`` a contiguous float32 (d, 4) on
    the same device.
    """
    global DESCENT_LAUNCHES
    dev = u.device
    if dev.type == "cpu":
        return quadrant_descent_plain(u, cum)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    _check_uniforms(u, cum)
    n = u.shape[0]
    src = torch.empty(n, dtype=torch.int32, device=dev)
    dst = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return src, dst
    lib = _descent_library()
    rc = lib.qkg_quadrant_descent(
        _build.device_index(dev), u.data_ptr(), cum.data_ptr(), cum.shape[0], n,
        src.data_ptr(), dst.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "quadrant_descent")
    DESCENT_LAUNCHES += 1
    return src, dst


def quilt_descent_lookup(
    u: torch.Tensor,
    cum: torch.Tensor,
    kb: torch.Tensor,
    lb: torch.Tensor,
    table_cfg: torch.Tensor,
    table_node: torch.Tensor,
    inv: Optional[torch.Tensor] = None,
):
    """Descent of an (N, d) float32 uniforms operand + lookup of each row's
    configs in block rows ``kb`` / ``lb`` (N,) of the (B, L) tables: four
    int32 (N,) arrays ``(src_cfg, dst_cfg, src_node, dst_node)``, node -1 on
    a miss.

    On a CUDA tensor this launches the CUDA kernel on the current stream and
    raises if the launch fails; on a CPU tensor it is the plain version,
    which searches the tables.  On CUDA every argument is contiguous, on u's
    device; ``kb``, ``lb`` and the tables int32.  ``inv``, the plan's
    (B, 2^d) int32 dense inverse of the same tables, makes each lookup one
    gather there; without it the kernel searches the tables.
    """
    global LOOKUP_LAUNCHES
    dev = u.device
    if dev.type == "cpu":
        return quilt_descent_lookup_plain(u, cum, kb, lb, table_cfg, table_node)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    _check_uniforms(u, cum)
    n = u.shape[0]
    kb, lb = kb.reshape(-1), lb.reshape(-1)
    named = [("kb", kb), ("lb", lb), ("table_cfg", table_cfg), ("table_node", table_node)]
    for name, t in named + ([] if inv is None else [("inv", inv)]):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous int32 on {dev}, got {t.dtype} on {t.device}")
    if kb.numel() != n or lb.numel() != n:
        raise ValueError(f"kb and lb must hold N={n} rows, got {kb.numel()} and {lb.numel()}")
    if table_cfg.ndim != 2 or table_cfg.shape != table_node.shape or 0 in table_cfg.shape:
        raise ValueError(
            f"tables must be two equal non-empty (B, L), got "
            f"{tuple(table_cfg.shape)} and {tuple(table_node.shape)}"
        )
    B, L = table_cfg.shape
    if inv is not None and inv.shape != (B, 1 << cum.shape[0]):
        raise ValueError(f"inv must be (B, 2^d) = {(B, 1 << cum.shape[0])}, got {tuple(inv.shape)}")
    outs = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(4)]
    if n == 0:
        return tuple(outs)
    lib = _lookup_library()
    rc = lib.qkg_quilt_descent_lookup(
        _build.device_index(dev), u.data_ptr(), cum.data_ptr(), cum.shape[0],
        kb.data_ptr(), lb.data_ptr(), table_cfg.data_ptr(), table_node.data_ptr(),
        None if inv is None else inv.data_ptr(), B, L, n,
        *(o.data_ptr() for o in outs), torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, rc, "quilt_descent_lookup")
    LOOKUP_LAUNCHES += 1
    return tuple(outs)
