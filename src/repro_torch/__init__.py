"""repro_torch — the MAGM quilting sampler on PyTorch and CUDA.

A port of :mod:`repro` (JAX, Pallas kernels for the TPU) that runs the
default MAGM session on an NVIDIA GPU, with the fused counter-PRNG descent
+ block lookup as a CUDA kernel (``csrc/quilt_prng_descent_lookup.cu``),
and beside it the naive O(n^2) baseline (``core/naive.py``, kernel
``csrc/bernoulli_tile.cu``), MAGFIT's dense scoring (``fit/magfit.py``,
kernel ``csrc/magm_logprob.cu``) and the counter-PRNG KPGM edge batch
(``kernels/ops.py``, kernel ``csrc/quadrant_descent_prng.cu``).
It imports ``torch`` and never ``jax``; its results are held bit-identical
to the JAX package's by the ``tests/test_torch_*.py`` suite.

Layout mirrors the reference: ``core/`` (PRNG, MAGM/KPGM math, partition,
dedup, the quilting engine, the naive sampler), ``kernels/`` (counter
hashes, each kernel's wrapper and its plain PyTorch version), ``fit/``
(dense scoring), ``api/`` (SamplerConfig, MAGMSampler, GraphSample) and
``configs/`` (the paper's thetas).

Device rule: every entry point runs on ``device="cuda"`` unless the caller
asks for the CPU, and raises when no card is present.
"""

__all__ = ["api", "core", "kernels", "fit", "configs", "interop"]
