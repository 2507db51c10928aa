"""repro_torch.train — AdamW with float32 masters (:mod:`optimizer`), the
update MAGFIT's M-step refines the thetas with; the LM's prefill and decode
steps (:mod:`steps`)."""
