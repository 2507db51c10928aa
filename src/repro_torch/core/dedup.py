"""Segmented first-occurrence dedup of the quilting round's candidates.

Every candidate of every block-pair graph is packed into one int64

    graph_id << (2*node_bits + arrival_bits)
        | src << (node_bits + arrival_bits)
        | dst << arrival_bits
        | arrival

so one sort groups duplicates while the low ``arrival`` bits keep a strict
total order and carry the permutation; a second sort of
``(arrival << 1) | is_first`` brings the flags back to arrival order.  The
keys are distinct, so neither sort needs to be stable.  When the packed key
does not fit 63 bits the same order comes from two stable sorts, of
``(dst, arrival)`` and then of ``(graph, src)``.

Arrival order matters: per graph, the FIRST ``target`` distinct pairs of the
stream are kept (Algorithm 1), never the smallest ids.

Also the host helpers of the ranked rounds: the geometric batch-size grid
(:func:`bucket_size`), how one batch is split across the graphs that need
edges (:func:`plan_asks`, :func:`uniform_ask`), the first-occurrence dedup
of an edge array (:func:`dedup_edges`), and the fixed-size chunking of a
stream of edges (:func:`rechunk_edges`, :func:`iter_edge_chunks`); and
the one-shot host entry point :func:`segmented_unique` with its numpy
oracle :func:`host_unique_reference`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device


def bucket_size(x: int, tile: int = 1) -> int:
    """``x`` rounded up to the grid {8..15} * 2^k (ratio <= 1.125), then to
    a multiple of ``tile``: the candidate-batch sizes of the ranked rounds."""
    x = max(int(x), 1)
    if x <= 16:
        b = 16
    else:
        k = x.bit_length() - 4  # so that 8 * 2^k <= x < 16 * 2^k
        base = 1 << k
        b = 16 * base
        for mult in range(8, 16):
            if mult * base >= x:
                b = mult * base
                break
    return b + (-b) % max(int(tile), 1)


def plan_asks(needs: np.ndarray, oversample: float, tile: int = 1) -> Tuple[np.ndarray, int]:
    """Split one bucketed candidate batch across the graphs that need edges.

    Every graph with ``needs[g] > 0`` gets ~``needs[g] * oversample + 16``
    slots and the rest of the bucket is spread over those graphs.  Returns
    ``(asks, N)`` with ``asks.sum() == N``, N a bucket multiple of ``tile``.
    """
    needs = np.maximum(np.asarray(needs, dtype=np.int64), 0)
    raw = np.where(needs > 0, (needs * oversample).astype(np.int64) + 16, 0)
    total = int(raw.sum())
    if total == 0:
        return np.zeros_like(needs), 0
    n = bucket_size(total, tile)
    asks = raw * n // total
    idx = np.nonzero(needs > 0)[0]
    deficit = int(n - asks.sum())
    q, r = divmod(deficit, idx.size)
    asks[idx] += q
    asks[idx[:r]] += 1
    return asks, n


def uniform_ask(needs: np.ndarray, oversample: float, tile: int = 1) -> int:
    """One per-graph slot count covering the largest shortfall,
    ``bucket_size(max(needs) * oversample + 16)`` (0 when nothing is
    needed): every graph of a ranked round gets the same number of slots."""
    needs = np.maximum(np.asarray(needs, dtype=np.int64), 0)
    top = int(needs.max(initial=0))
    if top == 0:
        return 0
    return bucket_size(int(top * oversample) + 16, tile)


def dedup_edges(edges: np.ndarray) -> np.ndarray:
    """First-occurrence unique rows of an ``(E, 2)`` edge array, in stream
    order (node ids below 2^31).

    >>> dedup_edges(np.array([[3, 1], [0, 2], [3, 1], [0, 0]]))
    array([[3, 1],
           [0, 2],
           [0, 0]])
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if edges.shape[0] == 0:
        return edges
    key = (edges[:, 0] << 32) | edges[:, 1]
    _, first_idx = np.unique(key, return_index=True)
    return edges[np.sort(first_idx)]


def rechunk_edges(pieces, chunk_edges: int):
    """Re-chunk a stream of ``(E_i, 2)`` edge pieces into ``(chunk_edges,
    2)`` int64 chunks; only the last may be shorter.  Empty pieces are
    skipped and at most one chunk is buffered.

    >>> pieces = [np.arange(6).reshape(3, 2), np.arange(4).reshape(2, 2)]
    >>> [c.shape for c in rechunk_edges(pieces, 2)]
    [(2, 2), (2, 2), (1, 2)]
    """
    chunk_edges = int(chunk_edges)
    if chunk_edges <= 0:
        raise ValueError(f"chunk_edges must be positive, got {chunk_edges}")
    buf: list = []
    have = 0
    for piece in pieces:
        p = np.asarray(piece, dtype=np.int64).reshape(-1, 2)
        while p.shape[0]:
            take = min(chunk_edges - have, p.shape[0])
            buf.append(p[:take])
            have += take
            p = p[take:]
            if have == chunk_edges:
                yield np.concatenate(buf, axis=0)
                buf, have = [], 0
    if have:
        yield np.concatenate(buf, axis=0)


def iter_edge_chunks(src: torch.Tensor, dst: torch.Tensor, keep: torch.Tensor, chunk_edges: int, tail=()):
    """The kept ``(src, dst)`` rows of a round's candidate buffers, then the
    ``tail`` pieces, as ``(chunk_edges, 2)`` int64 host chunks (the last may
    be shorter).

    The kept positions are found once on the buffers' device; each chunk
    gathers its rows there and copies only those to the host, so the whole
    edge list never sits on the host at once.
    """
    chunk_edges = int(chunk_edges)
    if chunk_edges <= 0:
        raise ValueError(f"chunk_edges must be positive, got {chunk_edges}")

    def pieces():
        idx = torch.nonzero(keep).reshape(-1)
        for lo in range(0, idx.numel(), chunk_edges):
            sel = idx[lo : lo + chunk_edges]
            yield torch.stack([src[sel], dst[sel]], dim=1).to(torch.int64).cpu().numpy()
        yield from tail

    return rechunk_edges(pieces(), chunk_edges)


def _packed_bits(node_bits: int, num_graphs: int, n: int) -> Tuple[int, int, bool]:
    glog = max(int(num_graphs - 1).bit_length(), 1) if num_graphs > 1 else 1
    abits = max(int(n - 1).bit_length(), 1) if n > 1 else 1
    fits = glog + 2 * node_bits + abits <= 63
    return glog, abits, fits


def _first_flags(*cols: torch.Tensor) -> torch.Tensor:
    """True where a sorted row differs from its predecessor in any column."""
    first = torch.ones_like(cols[0], dtype=torch.bool)
    if cols[0].numel() > 1:
        diff = cols[0][1:] != cols[0][:-1]
        for c in cols[1:]:
            diff = diff | (c[1:] != c[:-1])
        first[1:] = diff
    return first


def segmented_unique_mask(
    graph_id: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    cum_asks: torch.Tensor,
    targets: torch.Tensor,
    *,
    node_bits: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-graph first-occurrence mask with arrival-order target capping.

    ``graph_id`` is non-decreasing; graph g's candidates are the contiguous
    chunk ``[cum_asks[g-1], cum_asks[g])``.  Returns ``(take, counts)``:
    ``take[i]`` marks candidate i as one of the first ``targets[g]``
    distinct ``(src, dst)`` pairs of its graph in stream order, and
    ``counts[g]`` is the number taken in graph g (int32).

    ``valid`` excludes rows from the ranking and the output: they are
    remapped to the sentinel pair ``(2^node_bits, 2^node_bits)`` before
    packing (one more bit per id), so they never collide with a real pair,
    and are never fresh.
    """
    n = src.shape[0]
    dev = src.device
    num_graphs = targets.shape[0]
    if valid is not None:
        sentinel = torch.full((), 1 << node_bits, dtype=torch.int32, device=dev)
        src = torch.where(valid, src.to(torch.int32), sentinel)
        dst = torch.where(valid, dst.to(torch.int32), sentinel)
        node_bits = node_bits + 1
    _, abits, fits = _packed_bits(node_bits, num_graphs, n)
    arrival = torch.arange(n, dtype=torch.int64, device=dev)
    g64, s64, d64 = (x.to(torch.int64) for x in (graph_id, src, dst))

    if fits:
        key = (
            (g64 << (2 * node_bits + abits))
            | (s64 << (node_bits + abits))
            | (d64 << abits)
            | arrival
        )
        ks = torch.sort(key).values
        first = _first_flags(ks >> abits)
        arr_sorted = ks & ((1 << abits) - 1)
    else:
        # signed int32 columns: x * 2^k + y keeps (x, y) order for y in range
        order = torch.sort(d64 * (1 << 31) + arrival, stable=True).indices
        lead = (g64 * (1 << 32) + s64)[order]
        order = order[torch.sort(lead, stable=True).indices]
        first = _first_flags(g64[order], s64[order], d64[order])
        arr_sorted = order

    # a second sort un-permutes the flags back to arrival order
    restore = torch.sort((arr_sorted << 1) | first.to(torch.int64)).values
    fresh = (restore & 1) > 0
    if valid is not None:
        fresh = fresh & valid

    gid = graph_id.to(torch.int64)
    cum_asks = cum_asks.to(torch.int64)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    offs_ex = torch.cat([zero, cum_asks[:-1]])
    ends = torch.clamp_min(cum_asks - 1, 0)

    def _before(c: torch.Tensor) -> torch.Tensor:
        # inclusive prefix count just before each graph's chunk
        if n == 0:
            return torch.zeros_like(offs_ex)
        prev = c[torch.clamp_min(offs_ex - 1, 0)]
        return torch.where(offs_ex > 0, prev, torch.zeros_like(prev))

    c = torch.cumsum(fresh.to(torch.int64), 0)
    rank = c - _before(c)[gid]  # 1-based rank among fresh, per graph
    take = fresh & (rank <= targets.to(torch.int64)[gid])

    ct = torch.cumsum(take.to(torch.int64), 0)
    if n:
        counts = ct[torch.clamp_max(ends, n - 1)] - _before(ct)
    else:
        counts = torch.zeros_like(offs_ex)
    counts = torch.where(cum_asks > offs_ex, counts, torch.zeros_like(counts))
    return take, counts.to(torch.int32)


def segmented_unique(
    src: np.ndarray,
    dst: np.ndarray,
    asks: np.ndarray,
    targets: np.ndarray,
    *,
    node_bits: int,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot convenience wrapper: dedup a host candidate stream per graph
    through :func:`segmented_unique_mask` on ``device`` (default ``"cuda"``;
    raises without a card).

    ``asks.sum()`` must equal ``len(src)``.  Returns host ``(take, counts)``
    (bool, int32).
    """
    dev = resolve_device(device)
    src_t = torch.from_numpy(np.asarray(src, dtype=np.int32)).to(dev)
    dst_t = torch.from_numpy(np.asarray(dst, dtype=np.int32)).to(dev)
    cum_asks = torch.from_numpy(np.cumsum(np.asarray(asks, dtype=np.int64))).to(dev)
    graph_id = torch.searchsorted(cum_asks, torch.arange(src_t.shape[0], device=dev), right=True)
    take, counts = segmented_unique_mask(
        graph_id, src_t, dst_t, cum_asks, torch.from_numpy(np.asarray(targets, dtype=np.int64)).to(dev),
        node_bits=node_bits,
    )
    return take.cpu().numpy(), counts.cpu().numpy()


def host_unique_reference(
    src: np.ndarray,
    dst: np.ndarray,
    asks: np.ndarray,
    targets: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """The host semantics (np.unique in arrival order, capped), as a
    reference oracle for the device path."""
    take = np.zeros(src.shape[0], dtype=bool)
    counts = np.zeros(len(asks), dtype=np.int64)
    off = 0
    for g, ask in enumerate(np.asarray(asks, dtype=np.int64)):
        chunk = slice(off, off + int(ask))
        flat = src[chunk].astype(np.int64) << 32 | dst[chunk].astype(np.int64)
        _, first_idx = np.unique(flat, return_index=True)
        keep_local = np.sort(first_idx)[: int(targets[g])]
        take[off + keep_local] = True
        counts[g] = keep_local.size
        off += int(ask)
    return take, counts
