"""Dispatch to the port's kernels, plus the counter-PRNG helpers the core
engines share with them.

A kernel call goes by the device of its tensors: a CUDA tensor launches the
kernel, a CPU tensor runs the plain PyTorch version.  Unlike the
reference's ``ops`` there is nothing to pad: the CUDA kernel masks its own
ragged edge.
"""

from __future__ import annotations

from repro_torch.kernels import quadrant_descent as _qd

PRNG_CHANNELS = _qd.PRNG_CHANNELS
counter_seed = _qd.counter_seed
counter_hash = _qd.counter_hash
counter_u01 = _qd.counter_u01
counter_rank = _qd.counter_rank
descent_uniforms = _qd.descent_uniforms
rank_pair = _qd.rank_pair

quilt_prng_descent_lookup = _qd.quilt_prng_descent_lookup
quilt_prng_descent_lookup_plain = _qd.quilt_prng_descent_lookup_plain


def kernel_launches() -> dict:
    """Launch count of every kernel, by name."""
    return {"quilt_prng_descent_lookup": _qd.LAUNCHES}


def reset_kernel_launches() -> None:
    """Set every kernel's launch count to 0."""
    _qd.LAUNCHES = 0
