"""The port's AdamW (``repro_torch.train.optimizer``) against the reference's
``repro.train.optimizer``: the schedule over warmup, cosine and its 0.1
floor; the global norm in the reference's leaf order; ``init`` and
``abstract_state``; and a run of updates with and without clipping and
weight decay, on nested dicts and bfloat16 parameters.

Tolerance: ``rtol=1e-6`` (float32 ``cos``, ``sqrt`` and ``pow`` of the two
libraries may differ in the last ulp; every other step is the same IEEE
operation in the same order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_reference import ref  # noqa: F401  (fixture)

from repro_torch.train import optimizer as opt

RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker: the suite runs in several processes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _ref_opt():
    import importlib

    return importlib.import_module("repro.train.optimizer")


def _tree(seed: int):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((5, 3)).astype(np.float32),
        "b": {"z": rng.standard_normal(4).astype(np.float32), "a": rng.standard_normal(()).astype(np.float32)},
    }


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _to_jax(tree):
    import jax.numpy as jnp

    return {k: _to_jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _flat(tree) -> list:
    return [x for k in sorted(tree) for x in (_flat(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(lr=0.08, warmup_steps=0, total_steps=4, weight_decay=0.0, clip_norm=10.0),
    dict(lr=1e-2, warmup_steps=3, total_steps=12),
])
def test_schedule_matches_reference(ref, cfg):
    import jax.numpy as jnp

    r = _ref_opt()
    rc, pc = r.OptConfig(**cfg), opt.OptConfig(**cfg)
    w, t = pc.warmup_steps, pc.total_steps
    steps = sorted({0, 1, 2, w - 1, w, w + 1, (w + t) // 3, (w + t) // 2, t - 1, t, t + 1, 2 * t} - {-1})
    for s in steps:
        want = float(r.schedule(rc, jnp.asarray(s, jnp.int32)))
        got = opt.schedule(pc, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=RTOL, abs=1e-12), s


def test_global_norm_and_init_match_reference(ref):
    r = _ref_opt()
    tree = _tree(0)
    assert float(opt.global_norm(_to_torch(tree))) == pytest.approx(float(r.global_norm(_to_jax(tree))), rel=RTOL)
    st = opt.init(_to_torch(tree))
    rs = r.init(_to_jax(tree))
    assert st.step.dtype == torch.int32 and int(st.step) == int(rs.step) == 0
    for got, want in zip(_flat(st.master), _flat(rs.master)):
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), np.asarray(want))
    assert all(float(x.abs().max()) == 0.0 for x in _flat(st.mu) + _flat(st.nu))
    ab = opt.abstract_state(_to_torch(tree))
    ra = r.abstract_state(_to_jax(tree))
    for got, want in zip(_flat(ab.master) + _flat(ab.mu), _flat(ra.master) + _flat(ra.mu)):
        assert got.device.type == "meta" and tuple(got.shape) == tuple(want.shape) and got.dtype == torch.float32
    assert ab.step.device.type == "meta" and ab.step.dtype == torch.int32


@pytest.mark.parametrize("cfg", [
    dict(lr=0.08, warmup_steps=0, total_steps=6, weight_decay=0.0, clip_norm=10.0),  # the M-step's
    dict(lr=3e-2, warmup_steps=2, total_steps=6, weight_decay=0.1, clip_norm=0.5),  # clipping every step
])
def test_update_matches_reference(ref, cfg):
    """Six updates on a nested tree: new params, moments, masters and
    metrics equal the reference's to ``rtol=1e-6``."""
    r = _ref_opt()
    rc, pc = r.OptConfig(**cfg), opt.OptConfig(**cfg)
    rp, pp = _to_jax(_tree(1)), _to_torch(_tree(1))
    rs, ps = r.init(rp), opt.init(pp)
    for step in range(6):
        g = _tree(10 + step)
        g = {k: (v * 5.0 if not isinstance(v, dict) else {kk: vv * 5.0 for kk, vv in v.items()}) for k, v in g.items()}
        rp, rs, rm = r.update(rc, _to_jax(g), rs, rp)
        pp, ps, pm = opt.update(pc, _to_torch(g), ps, pp)
        assert int(ps.step) == int(rs.step) == step + 1
        for key in ("grad_norm", "lr"):
            assert float(pm[key]) == pytest.approx(float(rm[key]), rel=RTOL)
        for tree_p, tree_r in ((pp, rp), (ps.mu, rs.mu), (ps.nu, rs.nu), (ps.master, rs.master)):
            for got, want in zip(_flat(tree_p), _flat(tree_r)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-7)
    if cfg["clip_norm"] < 1.0:
        assert float(pm["grad_norm"]) > cfg["clip_norm"]  # the clip was active


def test_update_keeps_param_dtype_and_float32_masters():
    params = {"x": torch.ones(3, dtype=torch.bfloat16)}
    state = opt.init(params)
    new, state, _ = opt.update(opt.OptConfig(warmup_steps=0), {"x": torch.full((3,), 0.5)}, state, params)
    assert new["x"].dtype == torch.bfloat16 and state.master["x"].dtype == torch.float32
    assert float(state.master["x"][0]) < 1.0


def test_update_in_chunks_is_bit_equal(monkeypatch):
    """A leaf larger than ``UPDATE_CHUNK`` is updated in pieces (the update
    is elementwise): the same bits as one pass, in every dtype and shape."""
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(3, 1000, 7, generator=gen).bfloat16(), "b": {"c": torch.randn(5, 9, generator=gen)},
              "z": torch.tensor(0.5)}
    grads = {"a": torch.randn(3, 1000, 7, generator=gen).bfloat16(), "b": {"c": torch.randn(5, 9, generator=gen)},
             "z": torch.tensor(0.1)}
    state = opt.init(params)
    cfg = opt.OptConfig(lr=1e-2, warmup_steps=1)
    whole = opt.update(cfg, grads, state, params)
    monkeypatch.setattr(opt, "UPDATE_CHUNK", 1000)  # 21 pieces of "a", one ending mid-row
    pieces = opt.update(cfg, grads, state, params)
    for a, b in ((whole[0], pieces[0]), (whole[1].mu, pieces[1].mu), (whole[1].nu, pieces[1].nu),
                 (whole[1].master, pieces[1].master)):
        for t1, t2 in zip(opt._leaves(a), opt._leaves(b)):
            assert t1.dtype == t2.dtype and torch.equal(t1, t2)
