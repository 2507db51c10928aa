"""segmented_unique_mask: port vs reference on the packed-key branch and on
the multi-key branch, with and without ``valid``; take and counts equal."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_reference import ref  # noqa: F401  (fixture)

from repro_torch.core import dedup


def _stream(seed, num_graphs=6, span=5):
    """A candidate stream with many duplicates, ragged per-graph chunks,
    binding and non-binding targets and one empty graph."""
    rng = np.random.default_rng(seed)
    asks = rng.integers(40, 400, num_graphs)
    asks[2] = 0
    n = int(asks.sum())
    cum = np.cumsum(asks).astype(np.int32)
    graph = np.repeat(np.arange(num_graphs), asks).astype(np.int32)
    src = rng.integers(0, span, n).astype(np.int32)
    dst = rng.integers(0, span, n).astype(np.int32)
    targets = rng.integers(0, 30, num_graphs).astype(np.int32)
    targets[0] = 10_000
    valid = rng.random(n) < 0.7
    return graph, src, dst, cum, targets, valid


def _reference(ref, graph, src, dst, cum, targets, valid, node_bits):
    import jax
    import jax.numpy as jnp

    def run(g, s, d, c, t, v):
        return ref.dedup.segmented_unique_mask(g, s, d, c, t, node_bits=node_bits, valid=v)

    args = [jnp.asarray(x) for x in (graph, src, dst, cum, targets)]
    with jax.enable_x64(True):
        take, counts = jax.jit(run)(*args, None if valid is None else jnp.asarray(valid))
        return np.asarray(take), np.asarray(counts)


@pytest.mark.parametrize("use_valid", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("node_bits", [4, 28], ids=["packed", "multikey"])
def test_segmented_unique_mask_matches_reference(ref, node_bits, use_valid):
    for seed in range(3):
        graph, src, dst, cum, targets, valid = _stream(seed)
        valid = valid if use_valid else None
        fits = ref.dedup._packed_bits(
            node_bits + (valid is not None), targets.size, src.size
        )[2]
        assert fits == (node_bits == 4)
        want = _reference(ref, graph, src, dst, cum, targets, valid, node_bits)
        take, counts = dedup.segmented_unique_mask(
            *(torch.from_numpy(x) for x in (graph, src, dst, cum, targets)),
            node_bits=node_bits,
            valid=None if valid is None else torch.from_numpy(valid),
        )
        assert np.array_equal(take.numpy(), want[0])
        assert np.array_equal(counts.numpy(), want[1])
        assert take.any()


def test_packed_bits_match_reference(ref):
    for node_bits in (1, 5, 16, 28):
        for graphs in (1, 2, 49, 1225):
            for n in (1, 2, 1000, 25_885_867):
                assert dedup._packed_bits(node_bits, graphs, n) == ref.dedup._packed_bits(
                    node_bits, graphs, n
                )
    # the full-size main path (n = 2^15: 49 graphs, 25.9 M rows, d + 1 bits
    # per id with valid=) lands exactly on the 63-bit budget
    assert dedup._packed_bits(16, 49, 49 * 528_283) == (6, 25, True)


def test_all_invalid_and_empty_graphs():
    graph = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    src = torch.tensor([1, 1, 2, 2], dtype=torch.int32)
    cum = torch.tensor([2, 4], dtype=torch.int32)
    tg = torch.tensor([5, 5], dtype=torch.int32)
    take, counts = dedup.segmented_unique_mask(
        graph, src, src, cum, tg, node_bits=3, valid=torch.zeros(4, dtype=torch.bool)
    )
    assert not take.any() and counts.tolist() == [0, 0]
    take, counts = dedup.segmented_unique_mask(graph, src, src, cum, tg, node_bits=3)
    assert take.tolist() == [True, False, True, False] and counts.tolist() == [1, 1]
