"""Fault-tolerant training supervision (the reference's ``repro.dist.fault``).

``TrainSupervisor`` wraps the train step in a crash-restart loop: state is
checkpointed every ``ckpt_every`` steps *before* the step runs (so
checkpoint ``step_N`` is the state ENTERING step N), and on a recoverable
fault the loop restores the newest checkpoint and replays forward.  Replay
is exact because the data contract is ``batch_fn(step)`` — a pure function
of the step index (``data/pipeline.py``'s deterministic cursor) — so a
restarted run retraces the identical sequence of batches.

``StragglerMonitor`` is the serving-side counterpart: it flags steps whose
wall time exceeds ``factor`` x the rolling median, the signal a scheduler
uses to evict a slow host before it stalls the whole mesh.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.dist import checkpoint

# Canonical definitions live in repro_torch.dist.chaos (the bottom of the
# dist dependency stack); re-exported here so `fault.InjectedFault` call
# sites keep the same class identity.
from repro_torch.dist.chaos import DeviceLoss, InjectedFault  # noqa: F401


class TrainSupervisor:
    """Crash-restart loop around a deterministic train step.

    Args:
      step_fn: (params, opt_state, batch) -> (params, opt_state, metrics).
      batch_fn: step index -> batch; MUST be pure in the step index.
      ckpt_dir: checkpoint directory (shared storage in production).
      ckpt_every: checkpoint cadence in steps.
      fault_hook: optional callable(step) invoked before each step — the
        injection point for chaos tests.
      max_restarts: give up (re-raise) after this many recoveries.
      keep: checkpoints retained (older ones are pruned as training runs).
      straggler_monitor: optional :class:`StragglerMonitor`; each step runs
        under ``monitor.timed`` so slow steps are flagged (and the
        monitor's ``on_straggler`` callbacks fire) as training runs.

    A restore loads the newest checkpoint into the live state's structure,
    shapes, dtypes and devices (the reference's ``jax.eval_shape`` target).
    """

    def __init__(
        self,
        step_fn: Callable,
        batch_fn: Callable[[int], Any],
        ckpt_dir: str,
        *,
        ckpt_every: int = 25,
        fault_hook: Optional[Callable[[int], None]] = None,
        max_restarts: int = 8,
        keep: int = 4,
        recoverable: Tuple[type, ...] = (InjectedFault,),
        straggler_monitor: Optional["StragglerMonitor"] = None,
    ) -> None:
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = max(int(ckpt_every), 1)
        self.fault_hook = fault_hook
        self.max_restarts = max_restarts
        self.keep = keep
        self.recoverable = recoverable
        self.straggler_monitor = straggler_monitor
        self.restarts = 0

    def run(self, params: Any, opt_state: Any, num_steps: int) -> Tuple[Any, Any, List[Dict[str, float]]]:
        """Run ``num_steps`` steps; returns (params, opt_state, metrics).

        ``metrics`` holds one dict per EXECUTED step ({"step": i, ...});
        replayed steps appear once per execution, so the list is the true
        compute record, not the logical step range.  Reading a step's
        metrics (``float``) is the loop's one wait for the device.
        """
        metrics: List[Dict[str, float]] = []
        step = 0
        while step < num_steps:
            try:
                if step % self.ckpt_every == 0:
                    self._save(step, params, opt_state)
                if self.fault_hook is not None:
                    self.fault_hook(step)
                batch = self.batch_fn(step)
                if self.straggler_monitor is not None:
                    params, opt_state, m = self.straggler_monitor.timed(
                        step, lambda: self.step_fn(params, opt_state, batch)
                    )
                else:
                    params, opt_state, m = self.step_fn(params, opt_state, batch)
                metrics.append({"step": step, **{k: float(v) for k, v in m.items()}})
                step += 1
            except self.recoverable:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                last = checkpoint.latest_step(self.ckpt_dir)
                if last is None:  # fault before the first checkpoint landed
                    raise
                target = {"params": params, "opt_state": opt_state}
                state, _ = checkpoint.restore(self.ckpt_dir, last, target)
                params, opt_state = state["params"], state["opt_state"]
                step = last
        self._save(num_steps, params, opt_state)
        return params, opt_state, metrics

    def _save(self, step: int, params: Any, opt_state: Any) -> None:
        checkpoint.save(self.ckpt_dir, step, {"params": params, "opt_state": opt_state})
        checkpoint.prune(self.ckpt_dir, keep=self.keep)


class StragglerMonitor:
    """Rolling-median step-time watchdog.

    ``observe(step, seconds)`` returns True (and records the step in
    ``self.flagged``) when the duration exceeds ``factor`` x the median of
    the last ``window`` observations.  Flagged durations still enter the
    window, so a genuine sustained slowdown shifts the baseline instead of
    flagging forever.

    Action policies plug in via :meth:`on_straggler`: registered callbacks
    are invoked with ``(step, seconds, median)`` each time a step is
    flagged — the hook a scheduler uses to evict or rebalance the slow
    host.  A callback that raises propagates to the caller of ``observe``
    (an eviction policy MAY abort the step).
    """

    def __init__(self, *, window: int = 32, factor: float = 2.0, min_history: int = 4) -> None:
        self.factor = factor
        self.min_history = min_history
        self._durations: collections.deque = collections.deque(maxlen=window)
        self.flagged: List[Dict[str, float]] = []
        self._callbacks: List[Callable[[int, float, float], Any]] = []

    def on_straggler(self, callback: Callable[[int, float, float], Any]) -> Callable[[int, float, float], Any]:
        """Register ``callback(step, seconds, median)`` to fire on each
        flagged step.  Returns the callback (usable as a decorator)."""
        self._callbacks.append(callback)
        return callback

    def observe(self, step: int, seconds: float) -> bool:
        is_straggler = False
        median = None
        if len(self._durations) >= self.min_history:
            median = float(np.median(self._durations))
            if seconds > self.factor * median:
                is_straggler = True
                self.flagged.append({"step": step, "seconds": seconds, "median": median})
        self._durations.append(seconds)
        if is_straggler:
            for cb in self._callbacks:
                cb(step, seconds, median)
        return is_straggler

    def timed(self, step: int, fn: Callable[[], Any]) -> Any:
        """Run fn() and feed its wall time to the monitor."""
        t0 = time.perf_counter()
        out = fn()
        self.observe(step, time.perf_counter() - t0)
        return out
