"""Resumable streams and the engines' chaos sites in the port against the
reference, for the default MAGM session, the section-5 split and a KPGM
session with ``num_edges``:

- ``_stream_config_digest`` is bit-equal to the reference's, so a
  checkpoint directory written by either package resumes in the other;
- a stream killed at chunk k (``stream.chunk``) and resumed by a fresh
  session equals ``sample(key).edges`` and the reference's uninterrupted
  stream; its checkpoint files are byte-equal to the reference's killed at
  the same chunk; repeated kills, alternating packages, splice exactly;
- a finished stream yields nothing, a wrong config raises ValueError, a
  changed ``exact_cells`` (outside the digest, as in the reference) raises
  RuntimeError at replay, and the cursor tracks delivery;
- a ``DeviceLoss`` at ``quilt.dispatch`` with no mesh is fatal in both
  packages, and one schedule on ``quilt.round`` kills the same round in
  both.

Sizes are small (n = 128, d = 7, chunks of 64); every quantity is
deterministic, so equality is exact.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from test_torch_reference import ref  # noqa: F401  (fixture)

from repro_torch.api import KPGMSampler, MAGMSampler, SamplerConfig
from repro_torch.api import stream as stream_mod
from repro_torch.configs.magm_paper import THETA_1
from repro_torch.core import kpgm, magm, prng
from repro_torch.dist import chaos
from repro_torch.dist import checkpoint as ckpt

LG = 7
CHUNK = 64
KPGM_EDGES = 300
KINDS = ["magm", "split", "kpgm"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several worker processes share one host: one intra-op thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _port(kind: str, **kw):
    """A fresh port session of ``kind`` on the CPU (the attributes drawn
    from PRNGKey(0), as the reference's are)."""
    if kind == "kpgm":
        return KPGMSampler(SamplerConfig(params=kpgm.make_params(THETA_1, LG), device="cpu", **kw))
    cfg = SamplerConfig(params=magm.make_params(THETA_1, 0.5, LG), num_nodes=1 << LG, device="cpu",
                        split=kind == "split", **kw)
    return MAGMSampler(cfg)


def _ref(ref, kind: str):
    if kind == "kpgm":
        return ref.api.KPGMSampler(ref.api.SamplerConfig(params=ref.kpgm.make_params(THETA_1, LG)))
    cfg = ref.api.SamplerConfig(params=ref.magm.make_params(THETA_1, 0.5, LG), num_nodes=1 << LG,
                                split=kind == "split")
    return ref.api.MAGMSampler(cfg)


def _stream_kw(kind: str) -> dict:
    return {"num_edges": KPGM_EDGES} if kind == "kpgm" else {}


def _keys(seed: int):
    import jax

    return prng.PRNGKey(seed), jax.random.PRNGKey(seed)


_REF_CHUNKS: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _drop_cache(ref):
    yield
    _REF_CHUNKS.clear()


def _ref_chunks(ref, kind: str, seed: int):
    """The reference's uninterrupted stream, once a module per (kind, seed)."""
    if (kind, seed) not in _REF_CHUNKS:
        key = _keys(seed)[1]
        _REF_CHUNKS[kind, seed] = [
            np.asarray(c) for c in _ref(ref, kind).sample_stream(key, chunk_edges=CHUNK, **_stream_kw(kind))
        ]
    return _REF_CHUNKS[kind, seed]


def _killed(faults, chunks, visit: int) -> list:
    """Consume ``chunks`` under a schedule that kills ``stream.chunk`` at
    ``visit``; returns the chunks delivered before the fault."""
    got = []
    with faults.active(faults.FaultSchedule([faults.FaultSpec("stream.chunk", (visit,))])):
        with pytest.raises(faults.InjectedFault):
            for c in chunks:
                got.append(np.asarray(c))
    return got


def _port_stream(kind: str, key, directory: str, **kw):
    return _port(kind, **kw).sample_stream(key, chunk_edges=CHUNK, checkpoint_dir=directory, **_stream_kw(kind))


def _files(directory: str) -> dict:
    out = {}
    for step in sorted(os.listdir(directory)):
        for name in sorted(os.listdir(os.path.join(directory, step))):
            with open(os.path.join(directory, step, name), "rb") as f:
                out[step, name] = f.read()
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_config_digest_matches_reference(ref, kind):
    port, theirs = _port(kind), _ref(ref, kind)
    ne = _stream_kw(kind).get("num_edges")
    mine = port._stream_config_digest(CHUNK, ne)
    assert mine.dtype == np.uint8 and mine.shape == (20,)
    assert np.array_equal(mine, theirs._stream_config_digest(CHUNK, ne))
    assert not np.array_equal(mine, port._stream_config_digest(CHUNK + 1, ne))


@pytest.mark.parametrize("kind", KINDS)
def test_killed_stream_resumes_bit_identical(ref, kind, tmp_path):
    key, _ = _keys(7)
    want = _ref_chunks(ref, kind, 7)
    assert len(want) > 3  # the kill is mid-stream
    got = _killed(chaos, _port_stream(kind, key, str(tmp_path)), 2)
    assert len(got) == 2
    rest = list(_port(kind).resume_stream(str(tmp_path)))  # a fresh session
    whole = _port(kind).sample(key, **_stream_kw(kind)).edges
    assert np.array_equal(np.concatenate(got + rest), whole)
    assert len(got + rest) == len(want) and all(np.array_equal(a, b) for a, b in zip(got + rest, want))


@pytest.mark.parametrize("kind", KINDS)
def test_checkpoints_resume_across_packages(ref, kind, tmp_path):
    """Both packages killed at chunk 2 write byte-equal checkpoint files;
    each resumes the other's directory to the other's remaining chunks."""
    key, rkey = _keys(7)
    want = _ref_chunks(ref, kind, 7)
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    _killed(chaos, _port_stream(kind, key, mine), 2)
    rs = _ref(ref, kind)
    _killed(ref.chaos, rs.sample_stream(rkey, chunk_edges=CHUNK, checkpoint_dir=theirs, **_stream_kw(kind)), 2)
    assert sorted(os.listdir(mine)) == ["step_1", "step_2"]
    assert _files(mine) == _files(theirs)
    from_ref = list(_port(kind).resume_stream(theirs))
    from_port = [np.asarray(c) for c in _ref(ref, kind).resume_stream(mine)]
    for rest in (from_ref, from_port):
        assert len(rest) == len(want) - 2 and all(np.array_equal(a, b) for a, b in zip(rest, want[2:]))
    assert _files(mine) == _files(theirs)  # both finished: the same done markers


@pytest.mark.parametrize("kind", KINDS)
def test_repeated_kills_alternating_packages(ref, kind, tmp_path):
    """Killed in the port at chunk 1, resumed in the reference and killed
    at visit 3 of that replay (chunk 3), finished in the port."""
    key, _ = _keys(11)
    want = _ref_chunks(ref, kind, 11)
    d = str(tmp_path)
    got = _killed(chaos, _port_stream(kind, key, d), 1)
    got += _killed(ref.chaos, _ref(ref, kind).resume_stream(d), 3)
    assert len(got) == 3
    got += list(_port(kind).resume_stream(d))
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("kind", KINDS)
def test_finished_stream_yields_nothing(kind, tmp_path):
    key, _ = _keys(1)
    chunks = list(_port_stream(kind, key, str(tmp_path)))
    assert chunks and list(_port(kind).resume_stream(str(tmp_path))) == []
    state = stream_mod.load_state(str(tmp_path), ckpt.latest_step(str(tmp_path)), key)
    assert int(state["done"]) == 1 and int(state["chunks_emitted"]) == len(chunks)


@pytest.mark.parametrize(
    "other",
    [
        lambda: _port("magm", max_rounds=3),
        lambda: _port("magm", oversample=1.1),
        lambda: _port("magm", use_kernel=True),
        lambda: _port("split"),
        lambda: _port("kpgm"),
    ],
    ids=["max_rounds", "oversample", "use_kernel", "split", "kpgm"],
)
def test_resume_rejects_a_wrong_config(other, tmp_path):
    _killed(chaos, _port_stream("magm", _keys(1)[0], str(tmp_path)), 1)
    with pytest.raises(ValueError, match="different sampler config"):
        list(other().resume_stream(str(tmp_path)))
    with pytest.raises(ValueError, match="no stream checkpoint"):
        list(_port("magm").resume_stream(str(tmp_path / "nope")))


def test_changed_exact_cells_is_refused_at_replay(tmp_path):
    """``exact_cells`` is not in the reference's digest: the config check
    passes and the replay's digest check refuses the splice."""
    _killed(chaos, _port_stream("magm", _keys(1)[0], str(tmp_path)), 2)
    ranked = _port("magm", exact_cells=False)
    with pytest.raises(RuntimeError, match="resume replay diverged"):
        list(ranked.resume_stream(str(tmp_path)))


def test_cursor_tracks_delivery(tmp_path):
    """Checkpoint N is written only after chunk N-1's yield returned."""
    d = str(tmp_path)
    key, _ = _keys(7)
    stream = _port_stream("magm", key, d)
    edges = 0
    for k, chunk in enumerate(stream):
        assert ckpt.latest_step(d) == k  # chunk k is out, not yet acknowledged
        state = stream_mod.load_state(d, k, key)
        assert (int(state["chunks_emitted"]), int(state["edges_emitted"])) == (k, edges)
        edges += chunk.shape[0]
        if k == 3:
            break
    stream.close()
    state = stream_mod.load_state(d, ckpt.latest_step(d), key)
    assert (int(state["chunks_emitted"]), int(state["done"]), int(state["chunk_edges"])) == (3, 0, CHUNK)
    assert int(state["round_slots"]) > 0 and np.array_equal(state["key_data"], np.array([0, 7], np.uint32))
    assert int(state["key_typed"]) == 0


@pytest.mark.parametrize("kind", KINDS)
def test_device_loss_at_dispatch_is_fatal_in_both(ref, kind):
    key, rkey = _keys(2)
    out = []
    for faults, sampler, k in ((chaos, _port(kind), key), (ref.chaos, _ref(ref, kind), rkey)):
        sched = faults.FaultSchedule([faults.FaultSpec("quilt.dispatch", (0,), "device_loss", 3)])
        with faults.active(sched):
            with pytest.raises(faults.DeviceLoss) as info:
                sampler.sample(k, **_stream_kw(kind))
        out.append((info.value.device, sched.counters, sched.fired))
    assert out[0] == out[1] and out[0][0] == 3


def _round_sessions(ref, mode: str):
    """(port session, reference session, sample kwargs) of a mode: the
    exact round, the ranked rounds with top-ups (KPGM with a target near
    saturation, no oversampling), or ball dropping."""
    if mode == "ranked":
        port = KPGMSampler(SamplerConfig(params=kpgm.make_params(THETA_1, LG), oversample=1.0, device="cpu"))
        theirs = ref.api.KPGMSampler(ref.api.SamplerConfig(params=ref.kpgm.make_params(THETA_1, LG), oversample=1.0))
        return port, theirs, {"num_edges": 9000}
    change = {"backend": "balldrop"} if mode == "balldrop" else {}
    port = MAGMSampler(SamplerConfig(params=magm.make_params(THETA_1, 0.5, LG), num_nodes=1 << LG,
                                     device="cpu", **change))
    theirs = ref.api.MAGMSampler(ref.api.SamplerConfig(params=ref.magm.make_params(THETA_1, 0.5, LG),
                                                       num_nodes=1 << LG, **change))
    return port, theirs, {}


@pytest.mark.parametrize("visit", [0, 1, 3])
@pytest.mark.parametrize("mode", ["exact", "ranked", "balldrop"])
def test_one_round_schedule_kills_the_same_round_in_both(ref, mode, visit):
    """Samples drawn one after another under one ``quilt.round`` schedule:
    the same sample dies at the same visit in both packages."""
    port, theirs, kw = _round_sessions(ref, mode)
    out = []
    for faults, sampler, mk in ((chaos, port, 0), (ref.chaos, theirs, 1)):
        sched = faults.FaultSchedule([faults.FaultSpec("quilt.round", (visit,))])
        done = []
        with faults.active(sched):
            try:
                for seed in range(4):
                    done.append(np.asarray(sampler.sample(_keys(seed)[mk], **kw).edges))
            except faults.InjectedFault:
                pass
        out.append((len(done), sched.counters, sched.fired, done))
    assert out[0][:3] == out[1][:3]
    assert out[0][0] < 4  # the schedule fired
    assert all(np.array_equal(a, b) for a, b in zip(out[0][3], out[1][3]))
