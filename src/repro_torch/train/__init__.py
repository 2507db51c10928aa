"""repro_torch.train — AdamW with float32 masters (:mod:`optimizer`), the
update MAGFIT's M-step and the LM's train step take; the LM's loss, train,
prefill and decode steps (:mod:`steps`)."""
