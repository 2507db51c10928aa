"""Per-device cost of one traced step, counted op by op (the counterpart of
the reference's ``repro.analysis.hlo_cost``, which reads compiled HLO
text; this module reads the aten ops that eager PyTorch runs).

The model, per device, in the reference's :class:`Cost` fields:

  flops       — ``torch.utils.flop_counter``'s registered formulas (2MNK
                for every mm / bmm; elementwise ops count nothing, as the
                reference counts only dots).
  bytes       — operands plus results of every op that is not a view.  In
                eager PyTorch every op materialises its result, so this is
                eager execution's HBM traffic, not an approximation of a
                fused program's.
  collectives — result bytes of every collective, mapped onto the
                reference's five kinds (all-gather, all-reduce,
                reduce-scatter, all-to-all, collective-permute).

Python loops run every iteration, so layer stacks and chunk loops are
counted in full: the reference's trip-count weighting has no counterpart.

Per-device numbers under DTensor.  A dispatch mode entered above DTensor
sees the DTensor-level op first, with GLOBAL shapes (``FlopCounterMode``
counts an unsharded product there).  :class:`Counter` declines those
calls (it returns ``NotImplemented``), so DTensor's sharding propagation
runs and hands each LOCAL op (a shard's computation, a redistribution's
functional collective) back through the mode, which counts it.  The
dry-run's shards are ``meta`` tensors (shapes, dtypes and storages, no
memory, no arithmetic), and the counter counts only ops whose tensors all
lie on its ``device_type``: so DTensor's own bookkeeping (small CPU and
fake tensors of its propagation) stays out of the count.  A real step
(plain tensors, the card check) counts with ``device_type="cuda"``, by the
same rules.

Peak bytes per device (the counterpart of ``memory_analysis``): the live
bytes of the storages that the counted ops create, each counted at
creation and released by a weakref finalizer when its storage dies; the
tally's ``peak`` is their high-water mark, ``temp_peak`` its part above
the bytes live at the last ``reset`` (the step's inputs).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.roofline import KINDS

# op name (either collective namespace) -> the reference's kind
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}
_NOT_COLLECTIVES = {"wait_tensor", "barrier", "_wrap_tensor_autograd"}
# allocations that read and write nothing
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(default_factory=lambda: {k: 0.0 for k in KINDS})

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors in nested tuples, lists and dicts (order irrelevant)."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Tally:
    """The running cost of the ops :meth:`account` is given, and the live
    and peak bytes of the storages they create."""

    def __init__(self) -> None:
        self.cost = Cost()
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.base = 0  # live bytes at the last reset
        self._sizes: Dict[int, int] = {}

    def reset(self) -> None:
        """Zero the counts; the peak restarts from the bytes live now."""
        self.cost, self.ops = Cost(), 0
        self.peak = self.base = self.live

    @property
    def temp_peak(self) -> int:
        """The peak's bytes above those live at the last reset."""
        return self.peak - self.base

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def account(self, func, args, kwargs, out, inputs=None) -> None:
        """Count one op; ``inputs`` are its tensor operands, if known."""
        self.ops += 1
        name = func.__name__.split(".")[0]
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d") and name not in _NOT_COLLECTIVES:
            if name not in _COLLECTIVES:
                raise ValueError(f"op_cost: collective {func} has no kind")
            self.cost.coll[_COLLECTIVES[name]] += sum(_nbytes(t) for t in _tensors(out))
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.cost.flops += formula(*args, **kwargs, out_val=out)
        returns = func._schema.returns
        outs = out if isinstance(out, (tuple, list)) else (out,)
        fresh = [t for r, t in zip(returns, outs) if r.alias_info is None and isinstance(t, torch.Tensor)]
        if isinstance(out, (tuple, list)) and len(returns) == 1:  # one Tensor[] return
            fresh = _tensors(out) if returns[0].alias_info is None else []
        if not fresh and all(r.alias_info is not None and not r.alias_info.is_write for r in returns):
            return  # a view: no traffic, no storage
        if name not in _NO_TRAFFIC:
            inputs = _tensors((args, kwargs)) if inputs is None else inputs
            self.cost.bytes += sum(_nbytes(t) for t in inputs) + sum(_nbytes(t) for t in fresh)
        for t in fresh:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._sizes:
                continue
            self._sizes[key] = st.nbytes()
            self.live += self._sizes[key]
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor

    return issubclass(t, DTensor)


class Counter(TorchDispatchMode):
    """Tallies every local op whose tensors all lie on ``device_type``
    (every op for None); declines DTensor-level calls (module docstring)."""

    def __init__(self, tally: Tally, device_type: Optional[str] = None) -> None:
        super().__init__()
        self.tally, self.device_type = tally, device_type

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inputs = _tensors((args, kwargs))
        dt = self.device_type
        if dt is None or all(t.device.type == dt for t in inputs + _tensors(out)):
            self.tally.account(func, args, kwargs, out, inputs)
        return out


def count(fn, *args, device_type: Optional[str] = None, **kwargs):
    """``(fn(*args, **kwargs), tally)``: one real call, counted."""
    tally = Tally()
    with Counter(tally, device_type):
        out = fn(*args, **kwargs)
    return out, tally
