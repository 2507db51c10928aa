"""The exact round's acceptance: the CUDA kernel's wrapper and its plain
PyTorch version.

Each candidate row of an exact round (``gids.numel()`` graphs of ``a_tot``
slots) is kept when both of its lookups hit and its cell's hash uniform
lies below the cell's alpha (``core/quilt.py``: ``_accept_u01`` and
``_exact_alpha``, composed by ``_exact_cell_valid``).  :func:`exact_accept`
launches ``csrc/exact_accept.cu`` on a CUDA tensor, one launch for the
whole mask, and runs :func:`exact_accept_plain`, that composition, on a
CPU tensor.  The hash unit is the config pair, or with ``node_bits`` the
node pair (ball dropping).  The kernel reads the per-level log table
``logt`` and ``log_level_sum`` that the plan computes once from the thetas
(``quilt.QuiltPlan``); the plain version derives them from ``thetas``
itself, as ``_exact_alpha`` always has.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel since import (or since a caller reset it);
# only the CUDA branch of exact_accept adds to it
LAUNCHES = 0

_LIB = None


def exact_accept_plain(
    salt: torch.Tensor,
    gids: torch.Tensor,
    scfg: torch.Tensor,
    dcfg: torch.Tensor,
    snode: torch.Tensor,
    dnode: torch.Tensor,
    thetas: torch.Tensor,
    logt: Optional[torch.Tensor] = None,
    log_level_sum: Optional[float] = None,
    *,
    a_tot: int,
    budget: int,
    log_extra: float = 0.0,
    node_bits: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: row ``r`` is
    slot ``r % a_tot`` of graph ``gids[r // a_tot]``; a bool mask, True
    where both lookups hit and the acceptance keeps the candidate.
    ``logt`` and ``log_level_sum`` are the kernel's; this version computes
    them from ``thetas``."""
    from repro_torch.core import quilt  # quilt imports this module (through ops)

    local = torch.arange(gids.numel() * int(a_tot), dtype=torch.int64, device=gids.device) // int(a_tot)
    gid = gids.reshape(-1).to(torch.int64)[local]
    cell = None
    if node_bits is not None:
        cell = snode.to(torch.int64) * (1 << int(node_bits)) + dnode.to(torch.int64)
    return (
        (snode >= 0)
        & (dnode >= 0)
        & quilt._exact_cell_valid(salt, gid, scfg, dcfg, thetas, budget, log_extra, cell)
    )


def _library():
    """The built kernel library with its C signature declared."""
    global _LIB
    if _LIB is None:
        lib = _build.load("exact_accept")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.qkg_exact_accept.argtypes = [i, p, p, i, i, p, i, f, f, f, i, i, p, p, p, p, p, p]
        lib.qkg_exact_accept.restype = i
        lib.qkg_error_string.argtypes = [i]
        lib.qkg_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_cuda_inputs(salt, gids, rows, logt, log_level_sum, n, d, bits) -> None:
    if logt is None or log_level_sum is None:
        raise ValueError("the kernel needs the plan's logt and log_level_sum")
    dev = gids.device
    named = (("salt", salt, torch.int64, dev), ("gids", gids, torch.int32, dev),
             ("logt", logt, torch.float32, torch.device("cpu")))
    named += tuple((name, t, torch.int32, dev) for name, t in zip(("scfg", "dcfg", "snode", "dnode"), rows))
    for name, t, dtype, where in named:
        if t.device != where:
            raise ValueError(f"{name} is on {t.device}, not on {where}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if salt.numel() != 1:
        raise ValueError(f"salt must hold one value, got {salt.numel()}")
    if logt.numel() != 4 * d or not 1 <= d <= 31:
        raise ValueError(f"logt must hold 4 d values with 1 <= d <= 31 (d = {d}), got {logt.numel()}")
    for name, t in zip(("scfg", "dcfg", "snode", "dnode"), rows):
        if t.numel() != n:
            raise ValueError(f"{name} must hold gids.numel() * a_tot = {n} rows, got {t.numel()}")
    if n >= 2**31:
        raise ValueError("gids.numel() * a_tot must stay below 2^31 rows")
    if not 0 <= bits <= 62:
        raise ValueError(f"the hash unit's shift must lie in [0, 62], got {bits}")


def exact_accept(
    salt: torch.Tensor,
    gids: torch.Tensor,
    scfg: torch.Tensor,
    dcfg: torch.Tensor,
    snode: torch.Tensor,
    dnode: torch.Tensor,
    thetas: torch.Tensor,
    logt: Optional[torch.Tensor],
    log_level_sum: Optional[float],
    *,
    a_tot: int,
    budget: int,
    log_extra: float = 0.0,
    node_bits: Optional[int] = None,
) -> torch.Tensor:
    """Bool keep mask of the ``gids.numel() * a_tot`` candidate rows.

    On a CUDA tensor this launches the CUDA kernel on the current stream,
    allocates only the mask and raises if the launch fails; on a CPU tensor
    it is the plain version.  On CUDA ``salt`` is one int64, ``gids`` and
    the four row arrays contiguous int32, all on one device, ``logt`` the
    (4 d,) float32 table in host memory (the launch takes it by value) and
    ``log_level_sum`` a float32 value.  ``budget``
    and ``log_extra`` reach the kernel rounded to float32 to nearest (the
    ctypes ``c_float`` argument), as the plain version's constants are."""
    global LAUNCHES
    dev = gids.device
    if dev.type == "cpu":
        return exact_accept_plain(
            salt, gids, scfg, dcfg, snode, dnode, thetas, logt, log_level_sum,
            a_tot=a_tot, budget=budget, log_extra=log_extra, node_bits=node_bits,
        )
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    a_tot = int(a_tot)
    gids = gids.reshape(-1)
    rows = (scfg, dcfg, snode, dnode)
    n = gids.numel() * a_tot
    d = thetas.shape[0]
    bits = d if node_bits is None else int(node_bits)
    _check_cuda_inputs(salt, gids, rows, logt, log_level_sum, n, d, bits)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return valid
    lib = _library()
    rc = lib.qkg_exact_accept(
        _build.device_index(dev), salt.data_ptr(), gids.data_ptr(), gids.numel(), a_tot,
        logt.data_ptr(), d, log_level_sum, log_extra, budget, int(node_bits is not None), bits,
        *(t.data_ptr() for t in rows), valid.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"exact_accept launch failed: {lib.qkg_error_string(rc).decode()} ({rc})")
    LAUNCHES += 1
    return valid
