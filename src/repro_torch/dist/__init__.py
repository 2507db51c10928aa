"""repro_torch.dist — fault injection and retries (:mod:`chaos`), atomic
step checkpoints of numpy and torch trees (:mod:`checkpoint`), the
crash-restart training supervisor with its straggler monitor
(:mod:`fault`), the logical sharding hints and rules over DTensor
(:mod:`hints`, :mod:`sharding`) and the int8 compressed collectives
(:mod:`collectives`)."""

from repro_torch.dist import chaos, checkpoint, collectives, fault, hints, sharding

__all__ = ["chaos", "checkpoint", "collectives", "fault", "hints", "sharding"]
