"""The section-5 split sampler in the port against the reference: the B'
cost model, the split plan and its heavy-round arrays, the numpy stream of
a key, the host binomials, ``split_run`` on every heavy path, the split
session, and the deprecated shims ``quilt_sample`` / ``quilt_sample_fast``.

Edges are held to bit equality.  The plan's edge probabilities come from
the reference's eager CPU log Q, whose row and column terms are Eigen
matrix-vector products (the port sums them in the same order,
``magm._gemv_sum``) and whose interaction term is a matrix product that
XLA hands to oneDNN's sgemm.  That product adds the d terms from attribute
0 up for most shapes, and in 4-float lanes for some (on an 8-core
AVX-512 x86-64 host: (333, 333) and (3000, 333) at d = 12, the THETA_1
mu = 0.5 plan below); where it takes the lanes, the
reference's log Q can differ from the port's in the last bit, and so can
everything built on it.  The plan test pins that cause, matrix by matrix;
where it occurs the run tests start from the reference's probabilities,
so they hold ``split_run`` itself to bit equality.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from test_torch_reference import cuda_device, ref  # noqa: F401  (fixtures)

from repro_torch import interop
from repro_torch.api import MAGMSampler, SamplerConfig
from repro_torch.configs import magm_paper
from repro_torch.core import magm, prng, quilt

# (theta, mu, log2 n): heavy groups R and light nodes |W| at attribute key 0
CONFIGS = {
    "theta1_mu05": (magm_paper.THETA_1, 0.5, 12),  # R = 333, |W| = 3000
    "theta1_mu08": (magm_paper.THETA_1, 0.8, 12),  # R = 895, W empty
    "theta2_mu05": (magm_paper.THETA_2, 0.5, 12),  # R = 74, |W| = 3777
}


class _Pair:
    """Reference and port split sessions over the reference's attributes."""

    def __init__(self, ref, theta, mu, lg):
        p = ref.magm.make_params(theta, mu, lg)
        self.rp = p
        self.rs = ref.api.MAGMSampler(ref.api.SamplerConfig(params=p, num_nodes=1 << lg, split=True))
        self.params, self.F, _ = interop.from_reference(np.asarray(p.thetas), self.rs.F, np.zeros(2), np.asarray(p.mu))
        self.ps = MAGMSampler(SamplerConfig(params=self.params, F=self.F, split=True, device="cpu"))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes on one host: one intra-op
    thread a worker keeps the port's CPU ops from spinning against each
    other (results do not depend on it)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def pairs(ref):
    return {name: _Pair(ref, *cfg) for name, cfg in CONFIGS.items()}


@pytest.fixture(scope="module")
def small(ref):
    """A cheaper split for the shims: THETA_2, mu = 0.5, n = 2^9."""
    return _Pair(ref, magm_paper.THETA_2, 0.5, 9)


def _keys(seed):
    import jax

    key = jax.random.PRNGKey(seed)
    return key, interop._key(np.asarray(jax.random.key_data(key)))


def _lane4_log_q(Fa, Fb, thetas):
    """The port's host log Q with the interaction term summed in four
    lanes (attribute k into lane k mod 4, lanes added as (0 + 1) + (2 +
    3)): the order of oneDNN's 4-float sgemm kernel."""
    c0, u, v, w = (t.numpy() for t in magm.bilinear_decompose(thetas))
    fs, ft = np.asarray(Fa, np.float32), np.asarray(Fb, np.float32)
    lanes = []
    for lane in range(4):
        acc = np.zeros((fs.shape[0], ft.shape[0]), np.float32)
        for k in range(lane, fs.shape[1], 4):
            acc += np.multiply.outer(fs[:, k] * w[k], ft[:, k])
        lanes.append(acc)
    inter = (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])
    row, col = magm._gemv_sum(fs * u[None, :]), magm._gemv_sum(ft * v[None, :])
    return (c0 + row[:, None] + col[None, :]) + inter


def _with_reference_probs(rsp, psp: quilt.SplitPlan) -> quilt.SplitPlan:
    """The port's plan with the reference's probability matrices and the
    heavy-round arrays derived from them."""
    p_hh, p_wh, p_hw = (np.asarray(getattr(rsp, k)) for k in ("p_hh", "p_wh", "p_hw"))
    state = quilt._heavy_device_state(
        psp.n, psp.W, psp.sizes, psp.offs, psp.cat, p_hh, p_wh, p_hw, torch.device("cpu")
    )
    return psp._replace(p_hh=p_hh, p_wh=p_wh, p_hw=p_hw, **state)


# --- the cost model ---


@pytest.mark.parametrize(
    "counts,n,d,e,want",
    [([1, 1, 4], 8, 2, 4.0, (1, 18.0)), ([9], 16, 1, 100.0, (0, 2.0)), ([], 4, 2, 1.0, (0, 0.0))],
    ids=["hand", "all_heavy", "empty"],
)
def test_choose_bprime_hand_examples(ref, counts, n, d, e, want):
    assert quilt.choose_bprime(counts, n, d, e) == ref.quilt.choose_bprime(counts, n, d, e) == want


def test_choose_bprime_random_counts(ref):
    rng = np.random.default_rng(0)
    for _ in range(50):
        counts = rng.integers(1, 400, size=int(rng.integers(1, 300)))
        n, d, e = int(counts.sum()), int(rng.integers(2, 16)), float(rng.uniform(0, 1e6))
        assert quilt.choose_bprime(counts, n, d, e) == ref.quilt.choose_bprime(counts, n, d, e)


# --- the plan ---


@pytest.mark.parametrize("name", list(CONFIGS))
def test_build_split_plan_matches_reference(pairs, name):
    pr = pairs[name]
    rsp, psp = pr.rs.split_plan, pr.ps.split_plan
    assert psp.bprime == rsp.bprime and psp.R == rsp.R
    for k in ("W", "heavy_cfgs", "sizes", "offs", "cat"):
        a, b = np.asarray(getattr(rsp, k)), getattr(psp, k)
        assert np.array_equal(a, b) and a.dtype == b.dtype, k
    assert psp.heavy_budget == rsp.heavy_budget
    assert (psp.light_plan is None) == (rsp.light_plan is None)
    if psp.light_plan is not None:
        assert psp.light_plan.B == rsp.light_plan.B
    heavy_attr = magm.attributes_from_configs(torch.from_numpy(psp.heavy_cfgs), psp.d).numpy()
    FW = pr.F[psp.W]
    exact = True
    for k, (Fa, Fb) in {"p_hh": (heavy_attr, heavy_attr), "p_wh": (FW, heavy_attr), "p_hw": (heavy_attr, FW)}.items():
        want, got = np.asarray(getattr(rsp, k)), getattr(psp, k)
        assert want.dtype == got.dtype and want.shape == got.shape, k
        if np.array_equal(want, got):
            continue
        # the only other order the reference's product takes: its 4-lane
        # kernel, chosen by oneDNN for the shape, the host's vector width
        # and the thread count (so which matrices take it is not pinned)
        exact = False
        lane4 = np.minimum(np.exp(_lane4_log_q(Fa, Fb, pr.params.thetas)), 1.0)
        assert np.array_equal(want, lane4), k
    for k in ("pool", "blk_rows", "blk_cols", "blk_src_base", "blk_dst_base"):
        assert np.array_equal(np.asarray(getattr(rsp, k)), getattr(psp, k).numpy()), k
    if exact:
        assert psp.heavy_mean == rsp.heavy_mean
        for k in ("blk_alpha", "blk_cumw"):
            want, got = np.asarray(getattr(rsp, k)), getattr(psp, k).numpy()
            assert want.dtype == got.dtype and np.array_equal(want, got), k
    # the reference's probabilities give the reference's heavy-round arrays
    full = _with_reference_probs(rsp, psp)
    assert full.heavy_mean == rsp.heavy_mean
    for k in ("blk_alpha", "blk_cumw"):
        assert np.array_equal(np.asarray(getattr(rsp, k)), getattr(full, k).numpy()), k


def test_probability_matrices_at_the_chip_configuration(ref):
    """n = 2^15, THETA_1, mu = 0.5 (B' = 3, R = 635, |W| = 30,088): the
    three matrices equal the reference's bit for bit, as its host code
    computes them (``build_split_plan``'s own lines)."""
    import jax
    import jax.numpy as jnp

    p = ref.magm.make_params(magm_paper.THETA_1, 0.5, 15)
    F = np.asarray(ref.magm.sample_attributes(jax.random.PRNGKey(0), 1 << 15, p.mu))
    lam = np.asarray(ref.magm.configs_from_attributes(jnp.asarray(F)))
    uniq, counts = np.unique(lam, return_counts=True)
    bp, _ = ref.quilt.choose_bprime(counts, 1 << 15, 15, ref.magm.expected_edges(p, 1 << 15))
    heavy = uniq[counts > bp]
    W = np.nonzero(~np.isin(lam, heavy))[0]
    assert (bp, heavy.size, W.size) == (3, 635, 30088)
    ha = ref.magm.attributes_from_configs(jnp.asarray(heavy), 15)
    th = torch.from_numpy(np.array(p.thetas))
    hn = np.asarray(ha)
    for Fa, Fb, a, b in ((ha, ha, hn, hn), (jnp.asarray(F[W]), ha, F[W], hn), (ha, jnp.asarray(F[W]), hn, F[W])):
        want = np.minimum(np.exp(np.asarray(ref.magm.log_edge_prob(Fa, Fb, p.thetas))), 1.0)
        got = quilt._edge_probs(a, b, th)
        assert want.dtype == got.dtype and np.array_equal(want, got)


@pytest.mark.parametrize("rows", [1, 3, 7, 13, 300])
@pytest.mark.parametrize("d", [4, 9, 12, 15, 20])
def test_gemv_order_matches_reference(rows, d):
    """The row and column terms: the reference's matrix-vector product's
    order in every block of rows (8, 4, 2, 1) and packet layout of d."""
    import jax.numpy as jnp

    rng = np.random.default_rng(rows * 100 + d)
    F = (rng.random((rows, d)) < 0.5).astype(np.float32)
    u = (rng.standard_normal(d) * np.exp(rng.uniform(-3, 3, d))).astype(np.float32)
    want = np.asarray(jnp.asarray(F) @ jnp.asarray(u))
    assert np.array_equal(magm._gemv_sum(F * u[None, :]), want)


# --- the numpy stream and the host binomials ---


@pytest.mark.parametrize("seed", [0, 42, 43, 2**31 - 1])
def test_rng_from_key_matches_reference(ref, seed):
    import jax

    rkey, pkey = _keys(seed)
    want = ref.quilt.rng_from_key(rkey)
    got = quilt.rng_from_key(pkey)
    assert np.array_equal(want.integers(0, 1 << 30, 16), got.integers(0, 1 << 30, 16))
    assert np.array_equal(want.random(8), got.random(8))
    typed = jax.random.wrap_key_data(rkey)
    assert np.array_equal(ref.quilt.rng_from_key(typed).random(4), quilt.rng_from_key(pkey).random(4))


@pytest.mark.parametrize(
    "counts,sizes",
    [
        ([5, 0, 9, 3], [8, 4, 10, 6]),  # dense rows
        ([3, 1, 40, 7], [1000, 50, 5000, 30]),  # sparse rows
        ([40, 60, 2], [100, 150, 3]),  # sparse rows with collisions, a dense row
        ([300] * 6, [700] * 6),  # many collision rounds
    ],
    ids=["dense", "sparse", "mixed", "resample"],
)
def test_sample_cells_matches_reference(ref, counts, sizes):
    for seed in range(3):
        want_rng, got_rng = np.random.default_rng(seed), np.random.default_rng(seed)
        want = ref.quilt._sample_cells(want_rng, np.array(counts), np.array(sizes))
        got = quilt._sample_cells(got_rng, np.array(counts), np.array(sizes))
        assert np.array_equal(want, got) and want.dtype == got.dtype
        assert want_rng.random() == got_rng.random()  # the streams stayed in step


def test_sample_cells_exact_fallback_and_helpers(ref, monkeypatch):
    monkeypatch.setattr(ref.quilt, "_RESAMPLE_ROUNDS", 1)
    monkeypatch.setattr(quilt, "_RESAMPLE_ROUNDS", 1)
    counts, sizes = np.array([30, 45]), np.array([64, 100])
    a, b = ref.quilt._sample_cells(np.random.default_rng(1), counts, sizes), quilt._sample_cells(
        np.random.default_rng(1), counts, sizes
    )
    assert np.array_equal(a, b)
    group = np.arange(10, 50)
    assert np.array_equal(
        ref.quilt._sample_cols(np.random.default_rng(2), np.array([3, 30, 0]), group),
        quilt._sample_cols(np.random.default_rng(2), np.array([3, 30, 0]), group),
    )
    for ns, nt, p in ((7, 9, 0.3), (40, 3, 0.9), (0, 5, 0.5), (4, 4, 0.0)):
        assert np.array_equal(
            ref.quilt._er_block(np.random.default_rng(3), ns, nt, p), quilt._er_block(np.random.default_rng(3), ns, nt, p)
        )


# --- split_run ---


def _run_pair(ref, pr, seed, **kw):
    rkey, pkey = _keys(seed)
    rsp, psp = pr.rs.split_plan, pr.ps.split_plan
    if not all(np.array_equal(np.asarray(getattr(rsp, k)), getattr(psp, k)) for k in ("p_hh", "p_wh", "p_hw")):
        # the reference's product took its 4-lane order here: start from its p
        psp = _with_reference_probs(rsp, psp)
    if kw.pop("no_budget", False):
        rsp, psp = rsp._replace(heavy_budget=None), psp._replace(heavy_budget=None)
    rng_seed = kw.pop("rng_seed", None)
    want = ref.quilt.split_run(rkey, rsp, None if rng_seed is None else np.random.default_rng(rng_seed))
    got = quilt.split_run(pkey, psp, None if rng_seed is None else np.random.default_rng(rng_seed))
    return want, got


def _same(want, got):
    assert got[0].dtype == want[0].dtype
    assert np.array_equal(want[0], got[0])
    assert tuple(want[1]) == tuple(got[1])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_split_run_device_heavy_round_matches_reference(ref, pairs, name):
    want, got = _run_pair(ref, pairs[name], 7)
    _same(want, got)
    st = got[1]
    assert st.heavy_groups > 0 and st.kept_edges == got[0].shape[0] > 0
    n = pairs[name].ps.n
    assert np.unique(got[0][:, 0] * n + got[0][:, 1]).size == got[0].shape[0]


def test_split_run_numpy_generator_matches_reference(ref, pairs):
    _same(*_run_pair(ref, pairs["theta2_mu05"], 8, rng_seed=11))


def test_split_run_without_heavy_budget_matches_reference(ref, pairs):
    """heavy_budget=None: the host binomials from rng_from_key(key)."""
    _same(*_run_pair(ref, pairs["theta2_mu05"], 9, no_budget=True))


# --- the session, the shims and the stream ---


def test_split_session_and_stream_match_reference(ref, pairs):
    """The session's sample, and its stream: the reference's split stream
    re-chunks its sample's edges (``dedup.rechunk_edges``)."""
    pr = pairs["theta2_mu05"]
    rkey, pkey = _keys(12)
    want, got = pr.rs.sample(rkey), pr.ps.sample(pkey)
    assert np.array_equal(want.edges, got.edges) and tuple(want.stats) == tuple(got.stats)
    assert got.stats.bprime == pr.ps.split_plan.bprime and got.n == pr.ps.n
    chunks = list(pr.ps.sample_stream(pkey, chunk_edges=5000))
    want_chunks = list(ref.dedup.rechunk_edges([want.edges], 5000))
    assert len(chunks) == len(want_chunks) > 1
    assert all(np.array_equal(a, b) for a, b in zip(want_chunks, chunks))


def test_explicit_bprime_matches_reference(ref, pairs):
    pr = pairs["theta2_mu05"]
    rsp = ref.quilt.build_split_plan(pr.rs.F, pr.rp, 6)
    psp = quilt.build_split_plan(pr.F, pr.params, 6, device="cpu")
    assert psp.bprime == rsp.bprime == 6 and psp.R == rsp.R
    assert np.array_equal(np.asarray(rsp.W), psp.W) and psp.heavy_budget == rsp.heavy_budget
    ps = MAGMSampler(SamplerConfig(params=pr.params, F=pr.F, split=True, bprime=6, device="cpu"))
    assert ps.split_plan.bprime == 6 and np.array_equal(ps.split_plan.cat, psp.cat)


def _warned(fn):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn()
    return out, sorted(x.category.__name__ for x in w)


@pytest.mark.parametrize("seed", [None, 5])
def test_quilt_sample_fast_matches_reference(ref, small, seed):
    pr = small
    rkey, pkey = _keys(14)
    kw = {} if seed is None else {"seed": seed}
    want, wwarn = _warned(lambda: ref.quilt.quilt_sample_fast(rkey, pr.rp, pr.rs.F, return_stats=True, **kw))
    got, gwarn = _warned(lambda: quilt.quilt_sample_fast(pkey, pr.params, pr.F, return_stats=True, device="cpu", **kw))
    assert gwarn == wwarn == ["DeprecationWarning"] * (1 if seed is None else 2)
    _same(want, got)
    if seed is None:
        assert np.array_equal(got[0], pr.ps.sample(pkey).edges)


def test_quilt_sample_shim_and_plan_cache(ref, small):
    pr = small
    rkey, pkey = _keys(15)
    want, wwarn = _warned(lambda: ref.quilt.quilt_sample(rkey, pr.rp, pr.rs.F, return_stats=True))
    quilt.clear_plan_cache()
    got, gwarn = _warned(lambda: quilt.quilt_sample(pkey, pr.params, pr.F, return_stats=True, device="cpu"))
    assert gwarn == wwarn == ["DeprecationWarning"]
    _same(want, got)
    hits = quilt.PLAN_STATS["plan_hits"]
    plan = quilt.get_quilt_plan(pr.F, pr.params.thetas, device="cpu")
    assert quilt.PLAN_STATS["plan_hits"] == hits + 1
    assert plan is quilt.get_quilt_plan(pr.F, pr.params.thetas, device="cpu")
    empty = quilt.quilt_sample(pkey, pr.params, pr.F[:0], return_stats=True, device="cpu")
    assert empty[0].shape == (0, 2) and tuple(empty[1]) == (0, 0, 0, 0, 0, 0, None)


@pytest.mark.cuda
def test_split_session_card_matches_cpu(cuda_device):
    """The split on the card equals the split on the CPU, heavy round and
    light quilt (kernel 1) alike, with and without a light part."""
    for theta, mu, lg in (CONFIGS["theta1_mu05"], CONFIGS["theta1_mu08"]):
        cfg = SamplerConfig(params=magm.make_params(theta, mu, lg), num_nodes=1 << lg, split=True)
        cpu, card = MAGMSampler(cfg.replace(device="cpu")), MAGMSampler(cfg.replace(device=cuda_device))
        key = prng.PRNGKey(16)
        want, got = cpu.sample(key), card.sample(key)
        assert np.array_equal(want.edges, got.edges) and tuple(want.stats) == tuple(got.stats)
