"""repro_torch.models — the LM the reference serves, dense family: configs
in :mod:`repro_torch.configs`, flash attention's forward (:mod:`flash`),
layers, the KV cache, the layer loop (:mod:`transformer`) and the public
:class:`model.Model`."""
