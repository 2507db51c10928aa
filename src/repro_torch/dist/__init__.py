"""repro_torch.dist — fault injection and retries (:mod:`chaos`), atomic
step checkpoints of numpy and torch trees (:mod:`checkpoint`), and the
crash-restart training supervisor with its straggler monitor
(:mod:`fault`)."""

from repro_torch.dist import chaos, checkpoint, fault

__all__ = ["chaos", "checkpoint", "fault"]
