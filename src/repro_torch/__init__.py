"""repro_torch — the MAGM quilting sampler on PyTorch and CUDA.

A port of :mod:`repro` (JAX, Pallas kernels for the TPU) that runs the
MAGM and KPGM sessions on an NVIDIA GPU, through the quilting engine
(``core/quilt.py``) or the ball-dropping engine (``core/balldrop.py``),
with every TPU kernel of the reference as a CUDA kernel under ``csrc/``;
beside them the naive O(n^2) baseline (``core/naive.py``), MAGFIT (the
variational EM, edge ingest and the generate -> fit -> generate round
trip, ``fit/``), the KPGM edge batches (``kernels/ops.py``),
the 3-sigma validation suite (``analysis/validate.py``), and the
resilience and serving layer: fault injection, atomic checkpoints,
resumable streams and the graph server.  It imports
``torch`` and never ``jax``; its results are held bit-identical to the JAX
package's (statistically, for the device-native Philox batch) by the
``tests/test_torch_*.py`` suite.

Layout mirrors the reference: ``core/`` (PRNG, MAGM/KPGM math, partition,
dedup, the Kronecker moments, the quilting and ball-dropping engines, the
naive sampler, graph statistics), ``kernels/`` (counter hashes, Philox,
each kernel's wrapper and its plain PyTorch version), ``fit/`` (MAGFIT:
``magfit``, ``ingest``, ``recover``), ``train/`` (``optimizer.py``, the
M-step's AdamW), ``data/`` (``pipeline.build_csr``), ``api/`` (SamplerConfig, MAGMSampler, GraphSample, the
StreamCheckpoint of ``stream.py``), ``dist/`` (``chaos.py``: fault
schedules and retries; ``checkpoint.py``: atomic step checkpoints),
``launch/`` (``serve.py``: GraphServer and its CLI), ``analysis/``
(validation) and ``configs/`` (the paper's thetas).

Device rule: every entry point runs on ``device="cuda"`` unless the caller
asks for the CPU, and raises when no card is present.
"""

__all__ = ["api", "core", "kernels", "fit", "train", "data", "configs", "analysis", "dist", "launch", "interop"]
