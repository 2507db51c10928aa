"""Step checkpoints in the port (``repro_torch.dist.checkpoint``) against
the reference's ``repro.dist.checkpoint``: the same tree saved by either
package gives byte-equal files (``NNNNN.bin`` leaves and ``meta.json``)
and restores through the other's ``restore``; a crash at
``checkpoint.write``, at ``checkpoint.rename`` or between the two renames
leaves a restorable step in both; mismatched targets raise ValueError;
``prune`` keeps the newest steps.  Equality is exact.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from test_torch_reference import ref  # noqa: F401  (fixture)

from repro_torch.dist import chaos
from repro_torch.dist import checkpoint as ckpt


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several worker processes share one host: one intra-op thread each."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


class Pair(NamedTuple):
    lo: np.ndarray
    hi: np.ndarray


def _tree(scale: int = 1):
    """Nested dicts (keys out of order), a list, a tuple, a named tuple and
    a None, over float32/int32/uint8/int64/float64 leaves."""
    return {
        "z": np.arange(6, dtype=np.float32).reshape(2, 3) * scale,
        "b": [np.int32(5 * scale), (np.arange(4, dtype=np.uint8) * scale, None)],
        "a": {"y": np.asarray(-3 * scale, dtype=np.int64), "x": Pair(np.ones(2) * scale, np.zeros((1, 2), np.int32))},
    }


def _leaves(tree):
    return [np.asarray(x) for x in ckpt._flatten(tree)[0]]


def _files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def test_flatten_order_is_jax_tree_order(ref):
    import jax

    t = _tree()
    ours = _leaves(t)
    theirs = [np.asarray(x) for x in jax.tree.leaves(t)]
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_leaf_files_are_byte_equal(ref, tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path / "port"), 4, t)
    ref.ckpt.save(str(tmp_path / "ref"), 4, t)
    got, want = _files(tmp_path / "port" / "step_4"), _files(tmp_path / "ref" / "step_4")
    assert sorted(got) == [f"{i:05d}.bin" for i in range(6)] + ["meta.json"]
    assert got == want


@pytest.mark.parametrize("direction", ["port-to-ref", "ref-to-port"])
def test_saved_tree_restores_in_the_other_package(ref, tmp_path, direction):
    src, dst = (ckpt, ref.ckpt) if direction == "port-to-ref" else (ref.ckpt, ckpt)
    t = _tree(3)
    src.save(str(tmp_path), 9, t)
    assert dst.latest_step(str(tmp_path)) == 9
    back, meta = dst.restore(str(tmp_path), 9, _tree())
    assert meta["step"] == 9
    for a, b in zip(_leaves(back), _leaves(t)):
        assert np.array_equal(a, b)  # the reference's restore may narrow int64 without x64
    if dst is ckpt:
        assert isinstance(back["a"]["x"], Pair) and back["b"][1][1] is None
        assert all(a.dtype == b.dtype for a, b in zip(_leaves(back), _leaves(t)))


def _crash(package, faults, site, directory, step, tree, monkeypatch):
    """One save of ``tree`` killed at ``site``: a chaos site, or
    ``between-renames`` (after ``final -> final.old``, before
    ``tmp -> final``)."""
    if site == "between-renames":
        real = os.rename

        def rename(a, b):
            if str(a).endswith(".tmp"):
                raise OSError("killed between the renames")
            real(a, b)

        monkeypatch.setattr(os, "rename", rename)
        with pytest.raises(OSError):
            package.save(directory, step, tree)
        monkeypatch.setattr(os, "rename", real)
        return
    with faults.active(faults.FaultSchedule([faults.FaultSpec(site, (0,))])):
        with pytest.raises(faults.InjectedFault):
            package.save(directory, step, tree)


@pytest.mark.parametrize("package", ["port", "ref"])
@pytest.mark.parametrize("site", ["checkpoint.write", "checkpoint.rename", "between-renames"])
def test_crash_inside_a_save_leaves_a_restorable_step(ref, tmp_path, monkeypatch, package, site):
    pkg, faults = (ckpt, chaos) if package == "port" else (ref.ckpt, ref.chaos)
    d = str(tmp_path)
    old, new = _tree(1), _tree(2)
    pkg.save(d, 1, old)
    # the crashed save rewrites step 1 itself between the renames, else step 2
    step = 1 if site == "between-renames" else 2
    _crash(pkg, faults, site, d, step, new, monkeypatch)
    assert pkg.latest_step(d) == 1
    back, _ = pkg.restore(d, 1, _tree())
    # between the renames the complete new copy is promoted; otherwise the
    # previous checkpoint is untouched
    want = new if site == "between-renames" else old
    for a, b in zip(_leaves(back), _leaves(want)):
        assert np.array_equal(a, b)
    assert pkg.available_steps(d) == [1]


@pytest.mark.parametrize(
    "target, match",
    [
        ({"a": np.zeros(3, np.float32)}, "shape"),
        ({"a": np.zeros((2, 2), np.float64)}, "dtype"),
        ({"a": np.zeros((2, 2), np.float32), "b": np.zeros(1)}, "leaves"),
    ],
    ids=["shape", "dtype", "count"],
)
def test_restore_rejects_a_mismatched_target(tmp_path, target, match):
    ckpt.save(str(tmp_path), 1, {"a": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match=match):
        ckpt.restore(str(tmp_path), 1, target)


def test_restore_of_a_missing_step_and_shardings(tmp_path):
    with pytest.raises(ValueError, match="no checkpoint at step 3"):
        ckpt.restore(str(tmp_path), 3, {})
    saved = str(tmp_path / "saved")
    ckpt.save(saved, 1, {"a": np.arange(4, dtype=np.float32)})
    with pytest.raises(ValueError, match="shardings tree structure"):
        ckpt.restore(saved, 1, {"a": np.zeros(4, np.float32)}, shardings={"b": None})
    tree, _ = ckpt.restore(saved, 1, {"a": np.zeros(4, np.float32)}, shardings={"a": None})
    assert np.array_equal(tree["a"], np.arange(4, dtype=np.float32))  # None: the default placement
    assert ckpt.available_steps(str(tmp_path / "absent")) == [] and ckpt.latest_step(str(tmp_path)) is None


def test_prune_keeps_the_newest(tmp_path):
    for s in (1, 5, 3, 8):
        ckpt.save(str(tmp_path), s, {"s": np.asarray(s)})
    ckpt.prune(str(tmp_path), keep=2)
    assert ckpt.available_steps(str(tmp_path)) == [5, 8]
    ckpt.prune(str(tmp_path), keep=0)
    assert ckpt.available_steps(str(tmp_path)) == [5, 8]


# --- training states: torch leaves, bf16, an OptState ---------------------------


def _train_state(device="cpu"):
    """bf16 and float32 params and an OptState, as torch tensors."""
    from repro_torch.train import optimizer as opt_lib

    g = torch.Generator().manual_seed(0)
    params = {
        "embed": torch.randn(8, 4, generator=g).to(torch.bfloat16),
        "blocks": {"w": torch.randn(2, 4, 4, generator=g).to(torch.bfloat16), "ln": {}},
        "scale": torch.randn(4, generator=g),
    }
    state = opt_lib.init(params)
    return params, state._replace(step=state.step + 3)


def _torch_leaves(tree):
    return ckpt._flatten(tree)[0]


def test_torch_training_state_round_trips(tmp_path):
    params, state = _train_state()
    ckpt.save(str(tmp_path), 7, {"params": params, "opt_state": state})
    with open(tmp_path / "step_7" / "meta.json") as f:
        dtypes = [e["dtype"] for e in __import__("json").load(f)["leaves"]]
    # sorted keys: opt_state (step, mu, nu, master) before params (blocks, embed, scale)
    assert dtypes[0] == "int32" and dtypes[-3:] == ["bfloat16", "bfloat16", "float32"]
    target = {"params": {k: torch.zeros_like(v) if isinstance(v, torch.Tensor) else v for k, v in params.items()},
              "opt_state": state._replace(step=torch.zeros((), dtype=torch.int32))}
    back, meta = ckpt.restore(str(tmp_path), 7, target)
    assert meta["step"] == 7 and type(back["opt_state"]).__name__ == "OptState"
    for a, b in zip(_torch_leaves(back), _torch_leaves({"params": params, "opt_state": state})):
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    assert int(back["opt_state"].step) == 3
    with pytest.raises(ValueError, match="dtype bfloat16 != target dtype float32"):
        ckpt.restore(str(tmp_path), 7, {"params": {**target["params"], "embed": torch.zeros(8, 4)},
                                        "opt_state": target["opt_state"]})


def test_torch_state_bytes_equal_the_reference_save(ref, tmp_path):
    """The same training state saved by the port (torch, bf16) and by the
    reference (jax arrays, bf16 through ml_dtypes): byte-equal files."""
    import jax.numpy as jnp

    params, state = _train_state()

    def to_jax(t):
        a = t.float().numpy()
        return jnp.asarray(a).astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy())

    ropt = __import__("importlib").import_module("repro.train.optimizer")
    def tree(x):
        return {k: tree(v) for k, v in x.items()} if isinstance(x, dict) else to_jax(x)

    rtree = {"params": tree(params), "opt_state": ropt.OptState(*(tree(x) for x in state))}
    ckpt.save(str(tmp_path / "port"), 2, {"params": params, "opt_state": state})
    ref.ckpt.save(str(tmp_path / "ref"), 2, rtree)
    got, want = _files(tmp_path / "port" / "step_2"), _files(tmp_path / "ref" / "step_2")
    assert len(got) == 1 + 1 + 4 * len(_torch_leaves(params)) and got == want
    # and a numpy bf16 target (ml_dtypes' dtype) gets numpy bf16 back
    np_target = {"params": {"embed": np.asarray(rtree["params"]["embed"])}}
    ckpt.save(str(tmp_path / "np"), 1, {"params": {"embed": params["embed"]}})
    back, _ = ckpt.restore(str(tmp_path / "np"), 1, np_target)
    assert back["params"]["embed"].dtype.name == "bfloat16"
    assert np.array_equal(back["params"]["embed"].view(np.int16), params["embed"].view(torch.int16).numpy())


def test_reference_training_checkpoint_restores_in_the_port_and_continues(ref, tmp_path):
    """The reference trains the olmo smoke model one step under its
    supervisor and checkpoints; the port restores that checkpoint into its
    own live state (bf16 params, OptState) and takes the next step, whose
    loss is the reference's next step's within 2e-3 (bf16); the port's
    checkpoint of the result restores in the reference."""
    import importlib

    import jax

    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.models.model import build
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import steps

    rconfigs, rmodel = importlib.import_module("repro.configs"), importlib.import_module("repro.models.model")
    rsteps, ropt = importlib.import_module("repro.train.steps"), importlib.import_module("repro.train.optimizer")
    rfault = importlib.import_module("repro.dist.fault")
    cfgs = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    toks = np.random.default_rng(5).integers(0, 256, (2, 16), dtype=np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}

    rm = rmodel.build(rconfigs.get_smoke("olmo_1b"))
    rp = rm.init(jax.random.PRNGKey(0))
    rstep = jax.jit(rsteps.make_train_step(rm, ropt.OptConfig(**cfgs)))
    sup = rfault.TrainSupervisor(rstep, lambda s: batch, str(tmp_path / "ref"), ckpt_every=1)
    rparams, rstate, rmetrics = sup.run(rp, ropt.init(rp), 2)  # saves step_0, step_1, step_2

    pm = build(configs.get_smoke("olmo_1b"))
    live = pm.init(prng.PRNGKey(1), device="cpu")  # another init: the restore must replace it
    target = {"params": live, "opt_state": opt_lib.init(live)}
    state, meta = ckpt.restore(str(tmp_path / "ref"), 1, target)
    assert meta["step"] == 1 and int(state["opt_state"].step) == 1
    assert state["params"]["embed"].dtype == torch.bfloat16
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    params, opt_state, m = steps.make_train_step(pm, opt_lib.OptConfig(**cfgs))(
        state["params"], state["opt_state"], pbatch)
    print(f"continued step: port loss {float(m['loss'])}, reference {rmetrics[1]['loss']}")
    assert abs(float(m["loss"]) - rmetrics[1]["loss"]) <= 2e-3 and int(opt_state.step) == 2

    ckpt.save(str(tmp_path / "port"), 2, {"params": params, "opt_state": opt_state})
    back, _ = ref.ckpt.restore(str(tmp_path / "port"), 2, jax.eval_shape(lambda: {"params": rparams,
                                                                                  "opt_state": rstate}))
    assert int(back["opt_state"].step) == 2
    assert back["params"]["embed"].dtype == rparams["embed"].dtype
    diff = float(np.abs(np.asarray(back["opt_state"].master["embed"]) - np.asarray(rstate.master["embed"])).max())
    assert diff <= 2 * cfgs["lr"] + 1e-6  # one AdamW step of each package from the same state
