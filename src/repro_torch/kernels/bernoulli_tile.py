"""The naive sampler's fused tile: the log-Q tile compared against a tile of
log-uniforms, emitting an int8 adjacency mask.  The CUDA kernel's wrapper
and its plain PyTorch version.

:func:`bernoulli_tile` launches ``csrc/bernoulli_tile.cu`` on a CUDA tensor
(log Q stays in registers and never reaches device memory) and runs
:func:`bernoulli_tile_plain` on a CPU tensor.  ``logu`` may be a row-strided
view, such as the top-left corner of a larger draw.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.magm_logprob import check_tile_inputs, magm_logprob_plain

# launches of the CUDA kernel since import (or since a caller reset it);
# only the CUDA branch of bernoulli_tile adds to it
LAUNCHES = 0

_LIB = None


def bernoulli_tile_plain(F_src, F_dst, u, v, w, c0, logu) -> torch.Tensor:
    """(M, N) int8 mask ``logu < log Q`` on the inputs' device."""
    return (logu < magm_logprob_plain(F_src, F_dst, u, v, w, c0)).to(torch.int8)


def _library():
    """The built kernel library with its C signature declared."""
    global _LIB
    if _LIB is None:
        lib = _build.load("bernoulli_tile")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qkg_bernoulli_tile.argtypes = [i, p, p, i, i, i, p, p, p, p, p, ctypes.c_int64, p, p]
        lib.qkg_bernoulli_tile.restype = i
        lib.qkg_error_string.argtypes = [i]
        lib.qkg_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def bernoulli_tile(F_src, F_dst, u, v, w, c0, logu) -> torch.Tensor:
    """Sampled (M, N) int8 adjacency block: A[i, j] = [logu[i, j] < log Q[i, j]].

    On a CUDA tensor this launches the CUDA kernel on the current stream and
    raises if the launch fails; on a CPU tensor it is the plain version.  On
    CUDA the inputs are float32 on one device, contiguous except ``logu``,
    which needs unit column stride only.
    """
    global LAUNCHES
    dev = F_src.device
    if dev.type == "cpu":
        return bernoulli_tile_plain(F_src, F_dst, u, v, w, c0, logu)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    check_tile_inputs(F_src, F_dst, u, v, w, c0)
    M, d = F_src.shape
    N = F_dst.shape[0]
    if logu.device != dev or logu.dtype != torch.float32:
        raise TypeError(f"logu must be float32 on {dev}, got {logu.dtype} on {logu.device}")
    if logu.shape != (M, N):
        raise ValueError(f"logu must be ({M}, {N}), got {tuple(logu.shape)}")
    if (N > 1 and logu.stride(1) != 1) or (M > 1 and logu.stride(0) < N):
        raise ValueError(f"logu must have unit column stride and rows >= N apart, got {logu.stride()}")
    out = torch.empty((M, N), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    lib = _library()
    rc = lib.qkg_bernoulli_tile(
        _build.device_index(dev), F_src.data_ptr(), F_dst.data_ptr(), M, N, d,
        u.data_ptr(), v.data_ptr(), w.data_ptr(), c0.data_ptr(),
        logu.data_ptr(), max(logu.stride(0), N), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"bernoulli_tile launch failed: {lib.qkg_error_string(rc).decode()} ({rc})")
    LAUNCHES += 1
    return out
