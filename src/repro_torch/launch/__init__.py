"""repro_torch.launch — entry points: the LM and graph server
(:mod:`serve`) and the LM trainer on a MAGM walk corpus (:mod:`train`)."""
