"""End-to-end trainer: MAGM-graph corpus -> LM training with
checkpoint/restart supervision (the reference's ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \
        --steps 50 --batch 8 --seq 128 [--device cuda]

Runs on ``--device`` (default ``cuda``; raises without a card and never
falls back to the CPU).  The data source is the paper's sampler: random
walks over a quilted MAGM graph sampled on the device
(``data/pipeline.py``).  The weights are the reference's ``init_model``
bits for ``--seed``, trained in the config's dtype by AdamW under
:class:`repro_torch.dist.fault.TrainSupervisor`.  ``--mesh production``
raises ``NotImplementedError`` (ROADMAP queue 1 item 7b: meshes).
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Any, Dict, List, NamedTuple

from repro_torch import configs
from repro_torch.core import prng
from repro_torch.core.device import resolve_device
from repro_torch.data import pipeline as data_pipeline
from repro_torch.dist import fault, hints, sharding
from repro_torch.models.model import build as build_model
from repro_torch.models.transformer import tree_leaves
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import steps as steps_lib


class TrainRun(NamedTuple):
    """What :func:`train` trained: the model, the final params and
    optimizer state, one metrics dict per executed step, the corpus and
    the checkpoint directory."""

    model: Any
    params: Dict[str, Any]
    opt_state: opt_lib.OptState
    metrics: List[Dict[str, float]]
    source: data_pipeline.MAGMCorpus
    ckpt_dir: str


def train(args) -> TrainRun:
    """Sample the corpus, init the model and train ``args.steps`` steps on
    ``args.device``; asserts that the loss fell."""
    if args.mesh == "production":
        raise NotImplementedError("--mesh production (ROADMAP queue 1 item 7b: meshes) is not ported yet")
    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    model = build_model(cfg)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="qkg_train_")

    # --- data: random walks over a quilted MAGM graph ------------------
    source = data_pipeline.MAGMCorpus(
        num_nodes=args.graph_nodes,
        vocab_size=cfg.vocab_size,
        seq_len=args.seq,
        batch_size=args.batch,
        seed=args.seed,
        device=device,
    )
    print(
        f"[data] MAGM graph: n={source.num_nodes} |E|={source.num_edges} "
        f"B(partition)={source.quilt_stats.B}"
    )

    # --- params / optimizer --------------------------------------------
    params = model.init(prng.PRNGKey(args.seed), device=device)
    opt_cfg = opt_lib.OptConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    opt_state = opt_lib.init(params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[model] {cfg.name}: {n_params/1e6:.1f}M params")
    # the reference's placement by the sharding rules: on the 1-device host
    # mesh every spec is replicated, so the params stay where they are
    specs = sharding.param_specs(cfg, params, hints.MeshShape(("data",), (1,)))
    if any(any(e is not None for e in s) for s in tree_leaves(specs)):
        raise AssertionError("the host mesh shards a param")

    step_fn = steps_lib.make_train_step(model, opt_cfg)
    sup = fault.TrainSupervisor(step_fn, source.batch, ckpt_dir, ckpt_every=args.ckpt_every)
    params, opt_state, metrics = sup.run(params, opt_state, args.steps)
    first, last = metrics[0], metrics[-1]
    print(
        f"[train] step {first['step']}: loss={first['loss']:.4f} -> "
        f"step {last['step']}: loss={last['loss']:.4f} "
        f"(acc {last['acc']:.3f}, ckpts in {ckpt_dir})"
    )
    if not last["loss"] < first["loss"]:
        raise AssertionError("loss did not decrease")
    print("[train] OK — loss decreased")
    return TrainRun(model, params, opt_state, metrics, source, ckpt_dir)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", choices=["host", "production"], default="host")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--graph-nodes", type=int, default=1 << 12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="device of the corpus and the model (default: cuda)")
    return ap


def main(argv=None) -> TrainRun:
    return train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
