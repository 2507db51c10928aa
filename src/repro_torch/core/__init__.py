"""Core sampler math and the quilting engine (exact-cell path)."""
