"""The MAGM log edge-probability tile (bilinear form): the CUDA kernel's
wrapper and its plain PyTorch version.

    log Q = c0 + (F_s u) 1^T + 1 (F_t v)^T + F_s diag(w) F_t^T

:func:`magm_logprob` launches ``csrc/magm_logprob.cu`` on a CUDA tensor and
runs :func:`magm_logprob_plain` on a CPU tensor.  Unlike the reference's
Pallas kernel nothing is padded: the kernel works at the real depth d and
masks its own ragged M and N edges.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# launches of the CUDA kernel since import (or since a caller reset it);
# only the CUDA branch of magm_logprob adds to it
LAUNCHES = 0

_LIB = None


def magm_logprob_plain(F_src, F_dst, u, v, w, c0) -> torch.Tensor:
    """(M, d), (N, d) attributes and the (d,) terms u, v, w and scalar c0
    (any shapes holding those values) -> (M, N) float32 log Q, on the
    inputs' device, in the reference kernel's order of operations."""
    fs, ft = F_src.to(torch.float32), F_dst.to(torch.float32)
    u, v, w = (t.reshape(1, -1) for t in (u, v, w))
    row = torch.sum(fs * u, dim=1, keepdim=True)
    col = torch.sum(ft * v, dim=1, keepdim=True).T
    return c0.reshape(()) + row + col + (fs * w) @ ft.T


def check_tile_inputs(fs, ft, u, v, w, c0) -> None:
    """Raise unless the tile kernels take these: float32, contiguous, one
    CUDA device, (M, d) and (N, d) attributes, (d,) terms, one c0."""
    dev = fs.device
    for name, t in (("F_src", fs), ("F_dst", ft), ("u", u), ("v", v), ("w", w), ("c0", c0)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, F_src on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if fs.ndim != 2 or ft.ndim != 2 or fs.shape[1] != ft.shape[1]:
        raise ValueError(f"F_src, F_dst must be (M, d), (N, d), got {tuple(fs.shape)}, {tuple(ft.shape)}")
    d = fs.shape[1]
    for name, t in (("u", u), ("v", v), ("w", w)):
        if t.numel() != d:
            raise ValueError(f"{name} must hold d={d} values, got {t.numel()}")
    if c0.numel() != 1:
        raise ValueError(f"c0 must hold one value, got {c0.numel()}")
    if max(fs.shape[0], ft.shape[0], d) >= 2**31:
        raise ValueError("M, N and d must stay below 2^31")


def _library():
    """The built kernel library with its C signature declared."""
    global _LIB
    if _LIB is None:
        lib = _build.load("magm_logprob")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qkg_magm_logprob.argtypes = [i, p, p, i, i, i, p, p, p, p, p, p]
        lib.qkg_magm_logprob.restype = i
        lib.qkg_error_string.argtypes = [i]
        lib.qkg_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def magm_logprob(F_src, F_dst, u, v, w, c0) -> torch.Tensor:
    """(M, N) float32 log Q of the (M, d) and (N, d) attribute blocks.

    On a CUDA tensor this launches the CUDA kernel on the current stream and
    raises if the launch fails; on a CPU tensor it is the plain version.
    On CUDA all inputs are contiguous float32 on one device.
    """
    global LAUNCHES
    dev = F_src.device
    if dev.type == "cpu":
        return magm_logprob_plain(F_src, F_dst, u, v, w, c0)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    check_tile_inputs(F_src, F_dst, u, v, w, c0)
    M, d = F_src.shape
    N = F_dst.shape[0]
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _library()
    rc = lib.qkg_magm_logprob(
        _build.device_index(dev), F_src.data_ptr(), F_dst.data_ptr(), M, N, d,
        u.data_ptr(), v.data_ptr(), w.data_ptr(), c0.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"magm_logprob launch failed: {lib.qkg_error_string(rc).decode()} ({rc})")
    LAUNCHES += 1
    return out
