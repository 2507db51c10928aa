"""The sampler's public helpers against the reference (under ``ref``), and
the H100 bounds of ``analysis.roofline``:

- ``partition.occurrence_ranks`` (tensor), ``is_valid_partition``,
  ``min_partition_size``;
- ``kpgm.expected_edges``, ``kpgm.edge_prob_matrix``;
- ``magm.config_counts``;
- ``dedup.segmented_unique`` bit for bit against the reference's (x64) and
  against ``host_unique_reference``, with targets below the distinct count,
  empty graphs and an empty stream;
- each kernel bound function at the shapes ``PERF.md`` section 6 quotes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.analysis import roofline
from repro_torch.api import MAGMSampler, SamplerConfig
from repro_torch.configs.magm_paper import DEFAULT_MU, THETA_1, THETA_2
from repro_torch.core import dedup, kpgm, magm, partition, prng, quilt
from test_torch_reference import ref  # noqa: F401  (fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """6 test workers share the host's cores: one intra-op thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _lam(n, d, seed):
    """Configurations of n nodes with d attributes: many repeats."""
    return np.random.default_rng(seed).integers(0, 1 << d, n).astype(np.int32)


# --- partition ---------------------------------------------------------------


@pytest.mark.parametrize("n,d", [(1, 3), (17, 2), (1000, 4), (4096, 12)])
def test_occurrence_ranks_matches_reference(ref, n, d):
    import jax
    import jax.numpy as jnp

    lam = _lam(n, d, seed=n)
    got = partition.occurrence_ranks(torch.from_numpy(lam))
    want = np.asarray(jax.jit(ref.partition.occurrence_ranks)(jnp.asarray(lam)))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), partition.occurrence_ranks_np(lam))
    assert partition.occurrence_ranks(torch.empty(0, dtype=torch.int32)).numel() == 0


@pytest.mark.parametrize("n,d", [(0, 3), (1, 3), (300, 3), (2048, 11)])
def test_partition_checks_match_reference(ref, n, d):
    lam = _lam(n, d, seed=n + 1)
    assert partition.min_partition_size(lam) == ref.partition.min_partition_size(lam)
    if n == 0:
        return
    sets = partition.build_partition(lam).sets
    assert partition.is_valid_partition(lam, sets) is ref.partition.is_valid_partition(lam, sets) is True
    assert len(sets) == partition.min_partition_size(lam)  # Theorem 2: B is the pigeon-hole bound
    broken = [sets[0][:-1]] + list(sets[1:])  # a node left out
    assert partition.is_valid_partition(lam, broken) is ref.partition.is_valid_partition(lam, broken)
    if len(sets) > 1:  # a set with a repeated configuration
        clash = [np.concatenate([sets[0], sets[1][:1]])] + [sets[1][1:]] + list(sets[2:])
        assert partition.is_valid_partition(lam, clash) is ref.partition.is_valid_partition(lam, clash) is False


# --- KPGM / MAGM --------------------------------------------------------------


def _thetas(case):
    if case == "random":
        return np.random.default_rng(3).uniform(0.05, 0.95, (7, 2, 2)).astype(np.float32)
    theta, d = {"theta1": (THETA_1, 10), "theta2": (THETA_2, 5)}[case]
    return np.broadcast_to(theta, (d, 2, 2)).copy()


@pytest.mark.parametrize("case", ["theta1", "theta2", "random"])
def test_expected_edges_matches_reference(ref, case):
    import jax.numpy as jnp

    th = _thetas(case)
    assert kpgm.expected_edges(torch.from_numpy(th)) == ref.kpgm.expected_edges(jnp.asarray(th))


@pytest.mark.parametrize("d", [1, 3, 5])
def test_edge_prob_matrix_matches_reference(ref, d):
    import jax.numpy as jnp

    th = _thetas("random")[:d]
    got = kpgm.edge_prob_matrix(torch.from_numpy(th)).numpy()
    want = np.asarray(ref.kpgm.edge_prob_matrix(jnp.asarray(th)))
    assert got.shape == (1 << d, 1 << d) and np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n,d", [(0, 2), (500, 3), (4096, 12)])
def test_config_counts_matches_reference(ref, n, d):
    lam = _lam(n, d, seed=7)
    for got, want in zip(magm.config_counts(torch.from_numpy(lam)), ref.magm.config_counts(lam)):
        assert np.array_equal(got, want) and got.dtype == want.dtype


# --- segmented_unique -----------------------------------------------------------


def _stream(seed, asks, span, targets):
    rng = np.random.default_rng(seed)
    n = int(np.sum(asks))
    src = rng.integers(0, span, n).astype(np.int32)
    dst = rng.integers(0, span, n).astype(np.int32)
    return src, dst, np.asarray(asks, np.int32), np.asarray(targets, np.int32)


STREAMS = {
    # (asks, span of ids, targets): distinct counts ~ span^2 per graph
    "below-distinct": ([300, 200, 250], 6, [5, 1, 17]),
    "above-distinct": ([300, 200, 250], 6, [10_000, 36, 999]),
    "empty-graphs": ([0, 120, 0, 80, 0], 4, [3, 3, 3, 100, 0]),
    "zero-targets": ([50, 60], 5, [0, 0]),
    # the reference's jitted gather rejects a zero-length stream: held to
    # the host oracle alone
    "empty-stream": ([0, 0], 5, [4, 4]),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_segmented_unique_matches_reference(ref, name):
    asks, span, targets = STREAMS[name]
    src, dst, asks, targets = _stream(len(name), asks, span, targets)
    take, counts = dedup.segmented_unique(src, dst, asks, targets, node_bits=3, device="cpu")
    if src.size:
        r_take, r_counts = ref.dedup.segmented_unique(src, dst, asks, targets, node_bits=3)
        assert take.dtype == r_take.dtype and counts.dtype == r_counts.dtype
        assert np.array_equal(take, r_take) and np.array_equal(counts, r_counts)
    h_take, h_counts = dedup.host_unique_reference(src, dst, asks, targets)
    assert np.array_equal(take, h_take) and np.array_equal(counts, h_counts)
    for got, want in zip((h_take, h_counts), ref.dedup.host_unique_reference(src, dst, asks, targets)):
        assert np.array_equal(got, want) and got.dtype == want.dtype


def test_segmented_unique_default_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, dst, asks, targets = _stream(0, [4], 3, [2])
    with pytest.raises(RuntimeError, match="is_available"):
        dedup.segmented_unique(src, dst, asks, targets, node_bits=2)


# --- the H100 bounds ------------------------------------------------------------


def _plan(log2_n):
    """The paper configuration's plan as chip_smoke.py builds it."""
    cfg = SamplerConfig(params=magm.make_params(THETA_1, DEFAULT_MU, log2_n), num_nodes=1 << log2_n,
                        attribute_key=prng.PRNGKey(0), device="cpu")
    return MAGMSampler(cfg).plan


def _quoted(got, ms, by):
    """A bound equals the number PERF.md quotes, to the digits quoted."""
    digits = len(repr(ms).split(".")[1].lstrip("0"))
    assert got[1] == by and round(got[0], -int(np.floor(np.log10(ms))) + digits - 1) == ms, (got, ms)


def test_kernel_bounds_are_the_quoted_numbers():
    p15 = _plan(15)
    rows = p15.num_graphs * quilt._exact_budget(p15.p_max, p15.mean_edges)
    assert rows == 25_885_867
    _quoted(roofline.kernel_bound_ms(p15, rows), 0.716, "operations")  # kernel 1
    _quoted(roofline.descent_bound_ms(1 << 25, 15), 0.537, "operations")  # kernel 2
    _quoted(roofline.tile_bound_ms(2048, 2048, 15, 4), 0.00508, "bytes")  # kernel 3
    _quoted(roofline.tile_bound_ms(8192, 8192, 15, 4), 0.0804, "bytes")
    _quoted(roofline.tile_bound_ms(2048, 2048, 15, 5), 0.00633, "bytes")  # kernel 4
    _quoted(roofline.tile_bound_ms(8192, 8192, 15, 5), 0.1005, "bytes")
    _quoted(roofline.uniform_bound_ms(kpgm.DRAW_CHUNK_ELEMS // 20, 20), 0.0881, "bytes")  # 5a
    _quoted(roofline.uniform_bound_ms(4_194_304, 16, _plan(16).table_cfg), 0.111, "bytes")  # 5b
    _quoted(roofline.native_bound_ms(1 << 25, 15), 0.647, "operations")  # kernel 6
    # exact_accept at the exact cell, 539,984 of its rows hitting both lookups (chip_smoke --accept)
    _quoted(roofline.accept_bound_ms(rows, 539_984, 15), 0.0708, "bytes")
