"""repro_torch.analysis — the cross-backend statistical validation suite."""
