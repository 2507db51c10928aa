"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: the device events inside the traced window, the device's busy
time (the union of their intervals), its idle gaps labelled by the
harness's innermost ``record_function`` range on the host, and the device
operations that took most time."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Sequence, Tuple

from bench.harness import stats

WINDOW = "bench.window"  # the record_function range around the traced window
OUTSIDE = "outside any range"
TOP = 10


class Event(NamedTuple):
    name: str
    device: bool  # True for an operation that ran on the card
    start: float  # seconds, on the trace's clock
    end: float


def events(prof) -> List[Event]:
    """The trace's events, from the profiler's raw (kineto) results.  The
    device-side copies of ``record_function`` ranges (which span the
    kernels a range launched, gaps included) are left out: they are no
    device operations."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        device = e.device_type() != DeviceType.CPU
        if device and e.is_user_annotation():
            continue
        start = e.start_ns() * 1e-9
        out.append(Event(e.name(), device, start, start + e.duration_ns() * 1e-9))
    return out


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


class Summary(NamedTuple):
    window_s: float
    device: List[Event]  # device events that overlap the window
    busy_s: float
    idle_by_label: List[Tuple[str, float]]  # seconds idle, by the host's range, longest first
    top_ops: List[Tuple[str, float]]  # device seconds by operation name, longest first

    def kernels(self) -> List[Event]:
        return [e for e in self.device if not is_copy(e.name)]

    def time_of(self, part: str) -> float:
        """Device seconds of the events whose name holds ``part``."""
        return sum(e.end - e.start for e in self.device if part in e.name)


def _label_gaps(gaps: Sequence[Tuple[float, float]], labels: List[Event]) -> Dict[str, float]:
    """Sum each gap's length under the innermost label range open at its
    middle (the ranges of one thread nest)."""
    labels = sorted(labels, key=lambda e: (e.start, -e.end))
    out: Dict[str, float] = defaultdict(float)
    stack: List[Event] = []
    j = 0
    for lo, hi in sorted(gaps, key=lambda g: g[0] + g[1]):
        t = 0.5 * (lo + hi)
        while j < len(labels) and labels[j].start <= t:
            while stack and stack[-1].end <= labels[j].start:
                stack.pop()
            stack.append(labels[j])
            j += 1
        while stack and stack[-1].end <= t:
            stack.pop()
        out[stack[-1].name if stack else OUTSIDE] += hi - lo
    return out


def summarize(trace: Iterable[Event], label_names: Iterable[str]) -> Summary:
    """The window (the ``WINDOW`` range) and what the card did in it."""
    trace = list(trace)
    names = set(label_names)
    window = [e for e in trace if not e.device and e.name == WINDOW]
    if len(window) != 1:
        raise ValueError(f"the trace holds {len(window)} '{WINDOW}' ranges, not one")
    lo, hi = window[0].start, window[0].end
    # a range's device-side copy is no operation, whatever the profiler flags
    device = [e for e in trace if e.device and e.name not in names and e.end > lo and e.start < hi]
    merged = stats.union((max(e.start, lo), min(e.end, hi)) for e in device)
    busy = sum(e - s for s, e in merged)
    labels = [e for e in trace if not e.device and e.name in names and e.end > lo and e.start < hi]
    idle = _label_gaps(stats.gaps(merged, lo, hi), labels)
    by_op: Dict[str, float] = defaultdict(float)
    for e in device:
        by_op[e.name[:160]] += e.end - e.start
    ranked = lambda d: sorted(d.items(), key=lambda kv: kv[1], reverse=True)[:TOP]  # noqa: E731
    return Summary(hi - lo, device, busy, ranked(idle), ranked(by_op))
