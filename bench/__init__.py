"""The benchmark of the PyTorch/CUDA port ``repro_torch``: ``bench/run.py``
runs one cell of ``BENCHMARK.json`` once (see ``bench/README.md``)."""
