"""Plain PyTorch/NumPy reference of the benchmark's samplers.  It imports
nothing of the program under test."""
