"""The port's training supervisor and straggler monitor
(``repro_torch.dist.fault``): the reference's cases
(``tests/test_checkpoint.py``, ``tests/test_chaos.py``) mirrored on the
port's train step, a supervised run with an injected fault equal to an
uninterrupted one bit for bit, and the reference's system test
(``tests/test_system.py``: a MAGM walk corpus, a reduced olmo, a fault at
step 9 with checkpoints every 5) run in both packages: the port's per-step
losses within SYSTEM_LOSS_ATOL of the reference's (the same init bits,
graph and walks; bf16 arithmetic, whose roundings differ where XLA keeps
float32 intermediates, over 14 steps).
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import pytest
import torch

from test_torch_reference import ref  # noqa: F401  (fixture)

from repro_torch import configs
from repro_torch.core import prng
from repro_torch.data.pipeline import MAGMCorpus
from repro_torch.dist import chaos, fault
from repro_torch.dist import checkpoint as ckpt
from repro_torch.models.model import build
from repro_torch.models.transformer import tree_leaves
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import steps

SYSTEM_LOSS_ATOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """6 test workers share the host's cores: one intra-op thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _smoke(opt_cfg=None):
    cfg = configs.get_smoke("olmo_1b")
    model = build(cfg)
    params = model.init(prng.PRNGKey(0), device="cpu")
    return cfg, params, opt_lib.init(params), steps.make_train_step(model, opt_cfg)


def _random_batches(vocab: int, shape=(2, 16)):
    def batch_fn(step):
        toks = prng.randint(prng.fold_in(prng.PRNGKey(99), step), shape, 0, vocab)
        return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}

    return batch_fn


def _fault_at(step: int, cls=fault.InjectedFault):
    fired = {"n": 0}

    def hook(s):
        if s == step and not fired["n"]:
            fired["n"] = 1
            raise cls(f"simulated node failure at step {step}")

    return hook, fired


def test_faults_are_chaos_classes():
    assert fault.InjectedFault is chaos.InjectedFault and fault.DeviceLoss is chaos.DeviceLoss


def test_supervisor_restarts_after_fault(tmp_path):
    """Inject a fault mid-run; training restores and reaches the target
    step (tests/test_checkpoint.py)."""
    cfg, params, opt_state, step_fn = _smoke()
    hook, fired = _fault_at(7)
    sup = fault.TrainSupervisor(step_fn, _random_batches(cfg.vocab_size), str(tmp_path), ckpt_every=5,
                                fault_hook=hook)
    params, opt_state, metrics = sup.run(params, opt_state, num_steps=12)
    assert fired["n"] == 1 and sup.restarts == 1
    assert metrics[-1]["step"] == 11
    seen = [m["step"] for m in metrics]  # replayed steps 5, 6 appear twice
    assert seen.count(5) == 2 and seen.count(6) == 2
    assert ckpt.latest_step(str(tmp_path)) == 12
    assert all(isinstance(v, float) for m in metrics for k, v in m.items() if k != "step")
    assert int(opt_state.step) == 12 and params["embed"].dtype == torch.bfloat16


def test_supervised_replay_equals_an_uninterrupted_run(tmp_path):
    """The restore loads the bf16 params and the OptState back bit for bit,
    so 14 supervised steps with a fault at step 9 (restored from step 5)
    end on the uninterrupted run's bits; keep=2 prunes as it goes."""
    cfg, params, opt_state, step_fn = _smoke()
    batch_fn = _random_batches(cfg.vocab_size)
    p0, s0 = params, opt_state
    for s in range(14):
        p0, s0, _ = step_fn(p0, s0, batch_fn(s))
    hook, fired = _fault_at(9)
    sup = fault.TrainSupervisor(step_fn, batch_fn, str(tmp_path), ckpt_every=5, fault_hook=hook, keep=2)
    p1, s1, metrics = sup.run(params, opt_state, 14)
    assert fired["n"] == 1 and len(metrics) == 14 + 4
    for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(ckpt._flatten(s0)[0], ckpt._flatten(s1)[0]):
        assert torch.equal(a, b)
    assert ckpt.available_steps(str(tmp_path)) == [10, 14]


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    cfg, params, opt_state, step_fn = _smoke()

    def always(step):
        if step == 2:
            raise fault.InjectedFault("again")

    sup = fault.TrainSupervisor(step_fn, _random_batches(cfg.vocab_size), str(tmp_path), ckpt_every=1,
                                fault_hook=always, max_restarts=2)
    with pytest.raises(fault.InjectedFault):
        sup.run(params, opt_state, 4)
    assert sup.restarts == 3
    hook, _ = _fault_at(1, RuntimeError)
    with pytest.raises(RuntimeError):  # only ``recoverable`` faults are retried
        fault.TrainSupervisor(step_fn, _random_batches(cfg.vocab_size), str(tmp_path / "b"),
                              fault_hook=hook).run(params, opt_state, 2)


def test_deterministic_replay():
    """batch_fn(step) purity: same step -> identical batch after restart."""
    batch_fn = _random_batches(100, (2, 4))
    assert torch.equal(batch_fn(3)["tokens"], batch_fn(3)["tokens"])
    assert not torch.equal(batch_fn(3)["tokens"], batch_fn(4)["tokens"])


def test_straggler_monitor():
    mon = fault.StragglerMonitor(window=16, factor=2.0)
    for i in range(10):
        mon.observe(i, 0.1)
    assert mon.observe(10, 0.5)  # 5x median -> flagged
    assert not mon.observe(11, 0.11)
    assert mon.flagged[0]["step"] == 10


def test_on_straggler_callback_fires_with_context():
    mon = fault.StragglerMonitor(window=16, factor=2.0)
    events = []
    mon.on_straggler(lambda step, secs, median: events.append((step, secs, median)))
    for i in range(8):
        mon.observe(i, 0.1)
    mon.observe(8, 0.5)
    mon.observe(9, 0.11)  # not a straggler: no event
    assert len(events) == 1
    step, secs, median = events[0]
    assert step == 8 and secs == 0.5 and median == pytest.approx(0.1)


def test_supervisor_feeds_straggler_monitor(tmp_path):
    """TrainSupervisor(straggler_monitor=) times every step through the
    monitor, so a slow step fires the registered eviction hook."""
    mon = fault.StragglerMonitor(window=16, factor=3.0, min_history=4)
    flagged = []
    mon.on_straggler(lambda step, secs, median: flagged.append(step))

    def step_fn(params, opt_state, batch):
        time.sleep(0.1 if batch == 8 else 0.002)  # a steady baseline
        return params, opt_state, {"loss": 0.0}

    sup = fault.TrainSupervisor(step_fn, lambda step: step, str(tmp_path), ckpt_every=100, straggler_monitor=mon)
    _, _, metrics = sup.run({"w": torch.zeros(2)}, {}, 12)
    assert len(metrics) == 12
    assert flagged == [8]
    assert mon.flagged[0]["step"] == 8


def test_end_to_end_train_on_magm_graph_follows_the_reference(ref, tmp_path):
    """tests/test_system.py in both packages: the same corpus and init,
    a fault at step 9, checkpoints every 5, 14 steps; the loss falls and
    the port's executed-step losses follow the reference's."""
    import jax

    rconfigs = importlib.import_module("repro.configs")
    rmodel = importlib.import_module("repro.models.model")
    rsteps = importlib.import_module("repro.train.steps")
    ropt = importlib.import_module("repro.train.optimizer")
    rfault = importlib.import_module("repro.dist.fault")
    ropts = dict(lr=1e-3, warmup_steps=2, total_steps=30)

    losses = {}
    for pkg in ("ref", "port"):
        hook, fired = _fault_at(9, rfault.InjectedFault if pkg == "ref" else fault.InjectedFault)
        if pkg == "ref":
            cfg = rconfigs.get_smoke("olmo_1b")
            model = rmodel.build(cfg)
            corpus = ref.pipeline.MAGMCorpus(num_nodes=256, vocab_size=cfg.vocab_size, seq_len=32, batch_size=4,
                                             seed=0)
            params = model.init(jax.random.PRNGKey(0))
            step_fn = jax.jit(rsteps.make_train_step(model, ropt.OptConfig(**ropts)))
            sup = rfault.TrainSupervisor(step_fn, corpus.batch, str(tmp_path / pkg), ckpt_every=5, fault_hook=hook)
            _, _, metrics = sup.run(params, ropt.init(params), num_steps=14)
        else:
            cfg = configs.get_smoke("olmo_1b")
            model = build(cfg)
            corpus = MAGMCorpus(num_nodes=256, vocab_size=cfg.vocab_size, seq_len=32, batch_size=4, seed=0,
                                device="cpu")
            params = model.init(prng.PRNGKey(0), device="cpu")
            step_fn = steps.make_train_step(model, opt_lib.OptConfig(**ropts))
            sup = fault.TrainSupervisor(step_fn, corpus.batch, str(tmp_path / pkg), ckpt_every=5, fault_hook=hook)
            _, _, metrics = sup.run(params, opt_lib.init(params), num_steps=14)
        assert fired["n"] == 1
        losses[pkg] = np.array([m["loss"] for m in metrics])
        assert losses[pkg][-1] < losses[pkg][0] and np.isfinite(losses[pkg]).all(), (pkg, losses[pkg])
    err = float(np.abs(losses["ref"] - losses["port"]).max())
    print(f"system test losses: reference {losses['ref']}, port {losses['port']}; max diff {err} "
          f"(bound {SYSTEM_LOSS_ATOL})")
    assert losses["ref"].shape == losses["port"].shape == (18,) and err <= SYSTEM_LOSS_ATOL
