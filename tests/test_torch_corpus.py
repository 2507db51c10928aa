"""The port's random-walk corpus (``repro_torch.data.pipeline.MAGMCorpus``)
against the reference's ``repro.data.pipeline.MAGMCorpus``, on the CPU.

At the reference test's n = 256 (``tests/test_data.py``) the graph
(``num_edges``, ``quilt_stats``, the CSR) and ``batch(0..3)`` equal the
reference's bit for bit.  At n = 2^12 the split plan's edge probabilities
come from the reference's eager CPU log Q, whose interaction term oneDNN
sums from attribute 0 up or in 4-float lanes depending on the host and the
shape (``tests/test_torch_split.py``); where it takes the lanes the
reference's graph is not the port's.  The test pins that cause matrix by
matrix and then holds the port's split run, given the reference's
probabilities, to the reference's graph and batches bit for bit.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from test_torch_reference import ref  # noqa: F401  (fixture)
from test_torch_split import _lane4_log_q, _with_reference_probs

from repro_torch.api import MAGMSampler, SamplerConfig
from repro_torch.configs import magm_paper
from repro_torch.core import magm, prng
from repro_torch.data.pipeline import MAGMCorpus

KW = dict(vocab_size=512, seq_len=16, batch_size=4, seed=3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """6 test workers share the host's cores: one intra-op thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _same_batches(port: MAGMCorpus, reference, steps=range(4)) -> None:
    for s in steps:
        got, want = port.batch(s), reference.batch(s)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32 and got[k].device == port.device, k
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), (s, k)


def test_corpus_matches_reference_at_256(ref):
    want = ref.pipeline.MAGMCorpus(num_nodes=256, **KW)
    got = MAGMCorpus(num_nodes=256, device="cpu", **KW)
    assert got.num_edges == want.num_edges > 0
    assert got.quilt_stats == want.quilt_stats and got.quilt_stats.B >= 1
    assert np.array_equal(got.indptr, want.indptr) and np.array_equal(got.adj, want.adj)
    _same_batches(got, want)


def test_corpus_matches_reference_at_4096(ref):
    """The reference's own split session over the corpus's attributes,
    probability matrix by matrix, then the port's split run given the
    reference's probabilities: the reference corpus's graph and batches."""
    import jax

    n, d = 1 << 12, 12
    want = ref.pipeline.MAGMCorpus(num_nodes=n, **KW)
    got = MAGMCorpus(num_nodes=n, device="cpu", **KW)
    assert got.quilt_stats.B == want.quilt_stats.B

    rp = ref.magm.make_params(magm_paper.THETA_1, 0.5, d)
    f_key, q_key = jax.random.split(jax.random.PRNGKey(KW["seed"]))
    F = np.asarray(ref.magm.sample_attributes(f_key, n, rp.mu))
    rs = ref.api.MAGMSampler(ref.api.SamplerConfig(params=rp, F=F, split=True))
    params = magm.make_params(magm_paper.THETA_1, 0.5, d)
    ps = MAGMSampler(SamplerConfig(params=params, F=F, split=True, device="cpu"))
    rsp, psp = rs.split_plan, ps.split_plan
    heavy = magm.attributes_from_configs(torch.from_numpy(psp.heavy_cfgs), d).numpy()
    exact = True
    for k, (Fa, Fb) in {"p_hh": (heavy, heavy), "p_wh": (F[psp.W], heavy), "p_hw": (heavy, F[psp.W])}.items():
        r, p = np.asarray(getattr(rsp, k)), getattr(psp, k)
        if not np.array_equal(r, p):  # the reference took oneDNN's 4-lane order here
            exact = False
            assert np.array_equal(r, np.minimum(np.exp(_lane4_log_q(Fa, Fb, params.thetas)), 1.0)), k
    print(f"n = 2^12: the reference's probabilities {'equal' if exact else 'are the 4-lane sums of'} the port's")
    if exact:
        assert np.array_equal(got.indptr, want.indptr) and np.array_equal(got.adj, want.adj)
        _same_batches(got, want)
        return
    ps.split_plan = _with_reference_probs(rsp, psp)
    edges = ps.sample(prng.split(prng.PRNGKey(KW["seed"]))[1]).edges
    assert np.array_equal(edges, rs.sample(q_key).edges)
    given = copy.copy(got)  # the same corpus, rebuilt on the reference's graph
    given._build_csr(edges)
    assert given.num_edges == want.num_edges
    assert np.array_equal(given.indptr, want.indptr) and np.array_equal(given.adj, want.adj)
    _same_batches(given, want)


def test_deterministic_cursor_and_shapes():
    c1, c2 = MAGMCorpus(num_nodes=256, device="cpu", **KW), MAGMCorpus(num_nodes=256, device="cpu", **KW)
    b1, b2 = c1.batch(5), c2.batch(5)
    assert torch.equal(b1["tokens"], b2["tokens"]) and torch.equal(b1["labels"], b2["labels"])
    assert not torch.equal(b1["tokens"], c1.batch(6)["tokens"])
    assert tuple(b1["tokens"].shape) == (4, 16) and b1["tokens"].is_contiguous()
    assert 0 <= int(b1["tokens"].min()) and int(b1["tokens"].max()) < 512
    # labels are the walks shifted by one
    walks = c1._tok(np.stack([c1._walk(np.random.default_rng((3 << 20) ^ 5)) for _ in range(1)]))
    assert np.array_equal(b1["tokens"][0].numpy(), walks[0, :16]) and np.array_equal(b1["labels"][0].numpy(), walks[0, 1:])


def test_corpus_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        MAGMCorpus(num_nodes=256, **KW)
