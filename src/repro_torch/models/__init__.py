"""repro_torch.models — the LMs the reference serves and trains, all six
families: configs in :mod:`repro_torch.configs`, flash attention
(:mod:`flash`), layers with cross-attention and the MoE, the Mamba mixers
(:mod:`ssm`), the caches, the layer loops (:mod:`transformer`) and the
public :class:`model.Model`."""
