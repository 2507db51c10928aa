"""One run of one cell: set-up and warm-up, the measured window under the
cell's loop, the output check, and the result line."""

from __future__ import annotations

import gc
import sys
import time
from contextlib import ExitStack, nullcontext
from types import SimpleNamespace
from typing import List

from bench.harness import check, spec, stats, trace as trace_lib

WARMUP_CALLS = 2  # calls before the window, with keys the window never uses
WARM_KEYS = 0xFFFFFFFF  # warm-up call j has the index WARM_KEYS - j
CALL = "session.call"  # the range around each call of the window
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level names no run may load


def loaded_forbidden(modules=None) -> List[str]:
    """The names of ``FORBIDDEN`` that are the whole top-level name of a
    module in ``modules`` (default: the loaded ones, ``sys.modules``)."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _sync(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str, t0: float) -> dict:
    """Run ``cell`` once on ``device``; ``t0`` is the process's start on the
    ``time.perf_counter`` clock.  Returns the result line as a dict."""
    import torch

    cuda = device.startswith("cuda")
    work = spec.builder(cell)(cell.config, cell.traffic, seed, device)
    # warm up with keys the window never uses: at least warmup_calls calls,
    # and calls until warmup_seconds have passed
    warm_start, j = time.perf_counter(), 0
    while j < int(cell.traffic.get("warmup_calls", WARMUP_CALLS)) or (
        time.perf_counter() - warm_start < float(cell.traffic.get("warmup_seconds", 0))
    ):
        work.call(WARM_KEYS - j)
        j += 1
    _sync(device)
    setup_s = time.perf_counter() - t0

    kept = check.Reservoir(int(cell.traffic.get("check_calls", 3)), seed)
    units = 0

    def done(i, out):
        nonlocal units
        units += work.units(out)
        kept.offer(i, out)

    launches: List[dict] = []
    prof = None
    with ExitStack() as stack:
        if traced:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = stack.enter_context(profile(activities=acts))
            stack.enter_context(work.ranges(launches))
            span = record_function
        else:
            span = lambda name: nullcontext()  # noqa: E731

        def call(i):
            with span(CALL):
                return work.call(i)

        if cuda:
            torch.cuda.reset_peak_memory_stats()
        before = work.counters()
        with span(trace_lib.WINDOW):
            call_ms, window_s = spec.loop(cell).drive(call, seconds, cell.traffic, seed, done)
        after = work.counters()
    ms = sorted(call_ms)
    tenths = [call_ms[len(call_ms) * k // 10 : len(call_ms) * (k + 1) // 10] for k in range(10)]
    print(f"calls {len(ms)} after {j} warm-up calls: ms min {ms[0]:.2f} p50 {stats.percentile(ms, 50):.2f} "
          f"p90 {stats.percentile(ms, 90):.2f} max {ms[-1]:.2f}; mean by tenth of the window "
          f"{[round(sum(t) / len(t), 1) for t in tenths if t]}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    labels = work.labels + (CALL, trace_lib.WINDOW)
    summary = trace_lib.summarize(trace_lib.events(prof), labels) if traced else None
    del prof
    work.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = spec.reference(cell.config, cell.traffic, seed, device, root=cell.root)
    compared, failed = ref.compare(kept.kept)
    correct = check.holds(compared) and bool(kept.kept)
    # what the run measured, as the metric readers see it
    r = SimpleNamespace(
        calls=len(call_ms), call_ms=call_ms, units=units, window_s=window_s, setup_s=setup_s, peak_bytes=peak,
        trace=summary, launches=launches, work=ref.work() if hasattr(ref, "work") else None,
        counters={k: after[k] - before.get(k, 0) for k in after},
    )
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = m.reader.read(r)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    line = {"correct": correct, "attempted": r.calls, "failed": failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in summary.top_ops],
            "idle_gaps": [[f"idle in {n}", s] for n, s in summary.idle_by_label],
        }
    line["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return line
