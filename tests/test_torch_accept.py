"""The exact round's acceptance (``kernels/exact_accept.py``): the wrapper's
plain arm against the reference's ``repro.core.quilt._exact_cell_valid``
in both hash units (the config pair, ball dropping's node pair), the
plan's constants, the launch count, and on the card the CUDA kernel
against its plain version bit for bit (``torch.equal``) at the benchmark's
exact cell, other thetas and depths, and edge inputs.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from test_torch_reference import cuda_device, ref  # noqa: F401  (fixtures)

from repro_torch.api import MAGMSampler, SamplerConfig
from repro_torch.configs import magm_paper
from repro_torch.core import kpgm, magm, prng, quilt
from repro_torch.kernels import exact_accept as ea
from repro_torch.kernels import ops


def _plan(theta, mu, lg, device="cpu", key=0):
    params = magm.make_params(theta, mu, lg)
    cfg = SamplerConfig(params=params, num_nodes=1 << lg, attribute_key=prng.PRNGKey(key), device=device)
    return MAGMSampler(cfg).plan


def _round(plan, seed, *, node_pair=False, graphs=None):
    """A round's acceptance inputs as the engines pass them: rkey, budget,
    gids, the four lookup rows, log_extra and node_bits."""
    key, _ = prng.split(prng.PRNGKey(seed))
    _, rkey = prng.split(key)
    mean = plan.mean_edges * (float(plan.B) ** 2 if node_pair else 1.0)
    budget = quilt._exact_budget(plan.p_max, mean)
    gids = torch.arange(plan.num_graphs if graphs is None else graphs, dtype=torch.int32, device=plan.device)
    rows = ops.quilt_prng_descent_lookup(
        ops.counter_seed(rkey), gids, plan.cum, plan.table_cfg, plan.table_node,
        a_tot=budget, num_blocks=plan.B, ranks=node_pair,
    )
    extra = dict(log_extra=2.0 * math.log(plan.B), node_bits=quilt._node_bits(plan.n)) if node_pair else {}
    return rkey, budget, gids, rows, extra


def _accept(fn, plan, rkey, budget, gids, rows, extra):
    salt = quilt.accept_salt(rkey, gids.device)
    return fn(salt, gids, *rows, plan.thetas, plan.logt, plan.log_level_sum, a_tot=budget, budget=budget, **extra)


def _reference_mask(ref, plan, rkey, budget, gids, rows, extra):
    import jax
    import jax.numpy as jnp

    scfg, dcfg, snode, dnode = (jnp.asarray(t.numpy()) for t in rows)
    gid = jnp.asarray(np.repeat(gids.numpy(), budget))
    k = jnp.asarray(rkey.numpy().astype(np.uint32))
    th = jnp.asarray(plan.thetas.numpy())
    log_extra, node_bits = extra.get("log_extra", 0.0), extra.get("node_bits")

    def mask_fn(k, g, s, d, sn, dn, th):
        cell = None
        if node_bits is not None:
            cell = sn.astype(jnp.int64) * jnp.int64(1 << node_bits) + dn.astype(jnp.int64)
        ok = ref.quilt._exact_cell_valid(k, g, s, d, th, budget, log_extra, cell)
        return (sn >= 0) & (dn >= 0) & ok

    with jax.enable_x64(True):
        return np.asarray(jax.jit(mask_fn)(k, gid, scfg, dcfg, snode, dnode, th))


CASES = [
    ("THETA_1", 0.5, 10, False),
    ("THETA_2", 0.5, 10, False),
    ("THETA_1", 0.6, 11, False),
    ("THETA_1", 0.5, 10, True),
    ("THETA_2", 0.5, 11, True),
]


@pytest.mark.parametrize("theta, mu, lg, node_pair", CASES,
                         ids=[f"{t}-mu{m}-n2^{g}-{'node' if b else 'cfg'}" for t, m, g, b in CASES])
def test_plain_arm_matches_reference_mask(ref, theta, mu, lg, node_pair):
    """On the CPU the wrapper runs the plain version, whose mask (misses
    folded in) is the reference's, in either hash unit; no launch counts."""
    plan = _plan(getattr(magm_paper, theta), mu, lg)
    rkey, budget, gids, rows, extra = _round(plan, 3, node_pair=node_pair, graphs=3 if node_pair else None)
    before = ops.kernel_launches()["exact_accept"]
    got = _accept(ops.exact_accept, plan, rkey, budget, gids, rows, extra)
    assert ops.kernel_launches()["exact_accept"] == before
    want = _reference_mask(ref, plan, rkey, budget, gids, rows, extra)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


def test_plain_arm_is_the_engines_composition():
    """The plain version is the composition the engines ran before the
    kernel: hits, then _accept_u01 < _exact_alpha per candidate."""
    plan = _plan(magm_paper.THETA_1, 0.5, 10)
    rkey, budget, gids, (scfg, dcfg, snode, dnode), _ = _round(plan, 4)
    local = torch.arange(scfg.numel()) // budget
    cell = scfg.long() * (1 << plan.d) + dcfg.long()
    u = quilt._accept_u01(quilt.accept_salt(rkey, "cpu"), gids.long()[local], cell)
    want = (snode >= 0) & (dnode >= 0) & (u < quilt._exact_alpha(scfg, dcfg, plan.thetas, budget))
    got = _accept(ops.exact_accept_plain, plan, rkey, budget, gids, (scfg, dcfg, snode, dnode), {})
    assert torch.equal(got, want)


@pytest.mark.parametrize("theta", ["THETA_1", "THETA_2"])
def test_plan_holds_the_acceptance_constants(theta):
    """The plan's logt and log_level_sum are log_prob_pairs' table and
    log_level_sum of its thetas, bit for bit."""
    plan = _plan(getattr(magm_paper, theta), 0.5, 9)
    assert plan.logt.dtype == torch.float32 and plan.logt.shape == (4 * plan.d,) and plan.logt.device.type == "cpu"
    assert torch.equal(plan.logt, kpgm.level_log_table(plan.thetas))
    assert plan.log_level_sum == float(kpgm.log_level_sum(plan.thetas))
    src = torch.tensor([0, 5, (1 << plan.d) - 1], dtype=torch.int32)
    dst = torch.tensor([3, 0, (1 << plan.d) - 2], dtype=torch.int32)
    d = plan.d
    bit = lambda x, k: (int(x) >> (d - 1 - k)) & 1  # noqa: E731
    for s, t, lp in zip(src, dst, kpgm.log_prob_pairs(plan.thetas, src, dst)):
        acc = plan.logt[2 * bit(s, 0) + bit(t, 0)]
        for k in range(1, d):
            acc = acc + plan.logt[4 * k + 2 * bit(s, k) + bit(t, k)]
        assert acc.item() == lp.item()
    kplan = quilt.build_kpgm_plan(np.broadcast_to(magm_paper.THETA_1, (6, 2, 2)), device="cpu")
    assert kplan.logt.shape == (24,) and kplan.log_level_sum == float(kpgm.log_level_sum(kplan.thetas))


def test_cpu_samples_launch_no_kernel():
    """The new launch count is listed, reset, and stays 0 through exact
    samples on the CPU (quilting and ball dropping)."""
    ops.reset_kernel_launches()
    assert ops.kernel_launches()["exact_accept"] == 0
    params = magm.make_params(magm_paper.THETA_1, 0.5, 9)
    for backend in ("auto", "balldrop"):
        cfg = SamplerConfig(params=params, num_nodes=512, attribute_key=prng.PRNGKey(0), device="cpu",
                            backend=backend)
        assert MAGMSampler(cfg).sample(prng.PRNGKey(1)).num_edges > 0
    assert ops.kernel_launches()["exact_accept"] == 0


def test_wrapper_raises_on_other_devices():
    plan = _plan(magm_paper.THETA_1, 0.5, 8)
    rkey, budget, gids, rows, _ = _round(plan, 1)
    meta = [t.to("meta") for t in (gids, *rows)]
    salt = torch.zeros((), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.exact_accept(salt, meta[0], *meta[1:], plan.thetas, plan.logt, plan.log_level_sum,
                         a_tot=budget, budget=budget)


# --- on the card -------------------------------------------------------------


def _equal_on_card(plan, rkey, budget, gids, rows, extra):
    args = (plan, rkey, budget, gids, rows, extra)
    got = _accept(ops.exact_accept, *args)
    want = _accept(ops.exact_accept_plain, *args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bool and got.shape == want.shape
    assert torch.equal(got, want), f"{int((got != want).sum())} of {got.numel()} rows differ"
    return want


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_at_the_exact_cell(cuda_device):
    """The benchmark's exact cell: THETA_1, mu = 0.5, n = 2^15, attributes
    of PRNGKey(0); a full round of 49 x 528,283 candidates."""
    plan = _plan(magm_paper.THETA_1, 0.5, 15, device=cuda_device)
    rkey, budget, gids, rows, extra = _round(plan, 7)
    assert gids.numel() * budget == 25_885_867
    kept = _equal_on_card(plan, rkey, budget, gids, rows, extra)
    assert 0 < int(kept.sum()) < kept.numel()


CARD_CASES = [("THETA_2", 0.5, 12, False), ("THETA_1", 0.5, 10, False), ("THETA_2", 0.6, 10, False),
              ("THETA_1", 0.5, 12, True), ("THETA_2", 0.5, 10, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("theta, mu, lg, node_pair", CARD_CASES,
                         ids=[f"{t}-mu{m}-n2^{g}-{'node' if b else 'cfg'}" for t, m, g, b in CARD_CASES])
def test_cuda_kernel_equals_plain(cuda_device, theta, mu, lg, node_pair):
    """Other thetas and depths, and ball dropping's node pairs with
    log_extra = 2 log B, over a few rank-chunk graph ids."""
    plan = _plan(getattr(magm_paper, theta), mu, lg, device=cuda_device)
    rkey, budget, gids, rows, extra = _round(plan, 8, node_pair=node_pair, graphs=5 if node_pair else None)
    _equal_on_card(plan, rkey, budget, gids[1:] if node_pair else gids,
                   tuple(t[budget:] for t in rows) if node_pair else rows, extra)


def _edge_thetas(d, near_one=False):
    """Levels that reach the edges of alpha: a theta of 0 (clamped to
    1e-30), tiny entries whose products underflow pi below the normals and
    to 0; or, ``near_one``, levels whose one large entry puts pi near 1."""
    if near_one:
        return torch.tensor([[[0.999999, 1e-7], [1e-7, 1e-7]]] * d, dtype=torch.float32)
    levels = [[[0.0, 1.0], [1.0, 1.0]], [[1e-13, 1.0], [0.5, 0.25]], [[0.15, 0.7], [0.7, 0.85]]]
    return torch.tensor([levels[k % len(levels)] for k in range(d)], dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("d, graphs, a_tot, budget, node_bits, near_one", [
    (1, 2, 501, 1, None, False), (3, 3, 1001, 1, None, False), (4, 2, 777, 5000, None, False),
    (8, 4, 3333, 20, 9, False), (15, 2, 65537, 7, None, False), (1, 2, 999, 1, None, True), (2, 3, 4099, 3, 4, True),
])
def test_cuda_kernel_equals_plain_at_edge_inputs(cuda_device, d, graphs, a_tot, budget, node_bits, near_one):
    """Random rows over edge thetas: budget 1, pi near 1, below the normals
    and 0, theta 0, lookup misses (about a third of the rows) and ragged
    last blocks (row counts off any block size)."""
    gen = torch.Generator().manual_seed(d * 1000 + a_tot)
    th = _edge_thetas(d, near_one)
    n = graphs * a_tot
    cfg = lambda: torch.randint(0, 1 << d, (n,), generator=gen, dtype=torch.int32)  # noqa: E731
    top = 1 << (node_bits or d)
    node = lambda: torch.where(torch.rand(n, generator=gen) < 0.2, -1,  # noqa: E731
                               torch.randint(0, top, (n,), generator=gen)).to(torch.int32)
    rows = tuple(t.to(cuda_device) for t in (cfg(), cfg(), node(), node()))
    gids = torch.arange(7, 7 + graphs, dtype=torch.int32, device=cuda_device)
    salt = torch.tensor(-0x1234_5678_9ABC_DEF0, dtype=torch.int64, device=cuda_device)
    kw = dict(a_tot=a_tot, budget=budget, log_extra=0.0 if node_bits is None else 2.0 * math.log(3),
              node_bits=node_bits)
    args = (salt, gids, *rows, th.to(cuda_device), kpgm.level_log_table(th), float(kpgm.log_level_sum(th)))
    got, want = ops.exact_accept(*args, **kw), ops.exact_accept_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"{int((got != want).sum())} of {n} rows differ"
    assert 0 < int(want.sum()) < n


@pytest.mark.cuda
def test_cuda_launch_count_per_round(cuda_device):
    """One launch per exact round (quilting and ball dropping); none in a
    ranked sample or the device backend's fused batch."""
    params = magm.make_params(magm_paper.THETA_1, 0.5, 15)
    cfg = SamplerConfig(params=params, num_nodes=1 << 15, attribute_key=prng.PRNGKey(0), device=cuda_device)
    exact = MAGMSampler(cfg)
    rounds = quilt.DISPATCH_COUNTERS["device_rounds"]
    ops.reset_kernel_launches()
    for i in range(3):
        exact.sample(prng.PRNGKey(i))
    assert quilt.DISPATCH_COUNTERS["device_rounds"] - rounds == 3
    assert ops.kernel_launches()["exact_accept"] == 3
    ops.reset_kernel_launches()
    MAGMSampler(cfg.replace(backend="balldrop")).sample(prng.PRNGKey(3))
    assert ops.kernel_launches()["exact_accept"] == 1
    ops.reset_kernel_launches()
    MAGMSampler(cfg.replace(exact_cells=False)).sample(prng.PRNGKey(4))
    MAGMSampler(cfg.replace(backend="device")).sample_batch(4, prng.PRNGKey(5))
    launches = ops.kernel_launches()
    assert launches["exact_accept"] == 0 and launches["quilt_prng_descent_lookup"] >= 2


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    plan = _plan(magm_paper.THETA_1, 0.5, 8, device=cuda_device)
    rkey, budget, gids, rows, _ = _round(plan, 2)
    salt = quilt.accept_salt(rkey, cuda_device)
    kw = dict(a_tot=budget, budget=budget)

    def call(*, salt=salt, gids=gids, rows=rows, logt=plan.logt, lls=plan.log_level_sum, **over):
        return ea.exact_accept(salt, gids, *rows, plan.thetas, logt, lls, **{**kw, **over})

    with pytest.raises(TypeError, match="scfg"):
        call(rows=(rows[0].long(), *rows[1:]))
    with pytest.raises(ValueError, match="rows"):
        call(rows=(rows[0][1:], *rows[1:]))
    with pytest.raises(ValueError, match="logt"):
        call(logt=plan.logt[:-1])
    with pytest.raises(ValueError, match="logt is on"):
        call(logt=plan.logt.to(cuda_device))
    with pytest.raises(ValueError, match="logt and log_level_sum"):
        call(lls=None)
    with pytest.raises(ValueError, match="salt"):
        call(salt=torch.zeros(2, dtype=torch.int64, device=cuda_device))
    with pytest.raises(ValueError, match="scfg is on"):
        call(rows=(rows[0].cpu(), *rows[1:]))
