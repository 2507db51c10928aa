"""The quilting engine of ``repro_torch``: a ``MAGMSampler`` (``model``
``magm``) or ``KPGMSampler`` (``model`` ``kpgm``) session built from the
configuration file, driven by one client's ``sample`` or ``sample_batch``
calls.  Call ``i`` of a run with seed ``s`` samples with key
``fold_in(PRNGKey(s), i)``.

This and the other engines are the benchmark's only modules that import
the program (inside their functions: importing one loads nothing of it).
"""

from __future__ import annotations

from typing import List

import numpy as np

from bench.harness.workload import Work, ranges

# the program functions the traced run wraps in ranges: the layers of PERF.md
SPANS = (
    ("repro_torch.core.quilt", "quilt_run", "engine.run"),
    ("repro_torch.core.quilt", "_round_body", "engine.round"),
    ("repro_torch.core.quilt", "accept_salt", "engine.salt"),
    ("repro_torch.core.quilt", "_exact_alpha", "engine.alpha"),
    ("repro_torch.core.quilt", "_accept_u01", "engine.accept_hash"),
    ("repro_torch.core.dedup", "segmented_unique_mask", "engine.dedup"),
    ("repro_torch.core.prng", "normal", "engine.targets"),
    ("repro_torch.core.quilt:QuiltRun", "edges", "result.edges"),
    ("repro_torch.core.quilt:QuiltRun", "edges_per_sample", "result.edges"),
)
LOOKUP = ("repro_torch.kernels.ops", "quilt_prng_descent_lookup", "kernels.lookup")
LABELS = tuple(dict.fromkeys(s[2] for s in SPANS + (LOOKUP,)))


def _session(config: dict, traffic: dict, device: str):
    from repro_torch.api import KPGMSampler, MAGMSampler, SamplerConfig
    from repro_torch.core import kpgm, magm, prng

    d = int(config["d"])
    theta = np.asarray(config["theta"], dtype=np.float32)
    kw = dict(backend=traffic.get("backend", "auto"), exact_cells=traffic.get("exact_cells"), device=device,
              oversample=float(config["oversample"]))
    if config["model"] == "magm":
        return MAGMSampler(SamplerConfig(
            params=magm.make_params(theta, config["mu"], d), num_nodes=int(config["num_nodes"]),
            attribute_key=prng.PRNGKey(int(config["attribute_seed"])), **kw,
        ))
    if config["model"] == "kpgm":
        return KPGMSampler(SamplerConfig(params=kpgm.make_params(theta, d), **kw))
    raise ValueError(f"unknown model {config['model']!r}")


def _counters():
    """The program's dispatch counters (rounds, top-ups, fallbacks)."""
    from repro_torch.core import quilt

    return dict(quilt.DISPATCH_COUNTERS)


def _ranges(launches: List[dict]):
    """The ranges of ``SPANS``, and kernel 1's ranges, which also log each
    launch's shapes in ``launches``."""

    def log_launch(seed, gids, cum, table_cfg, table_node, *, a_tot, num_blocks, **_):
        launches.append(dict(rows=int(gids.numel()) * int(a_tot), d=int(cum.shape[0]),
                             table_rows=int(table_cfg.shape[0]), table_width=int(table_cfg.shape[1]),
                             num_graphs=int(num_blocks) ** 2))

    return ranges([s + (None,) for s in SPANS] + [LOOKUP + (log_launch,)])


def build(config: dict, traffic: dict, seed: int, device: str) -> Work:
    """The session of ``config`` on ``device`` and the call of ``traffic``."""
    from repro_torch.core import prng

    session = _session(config, traffic, device)
    root = prng.PRNGKey(seed)
    per = int(traffic.get("graphs_per_call", 1))
    if traffic["call"] == "sample":
        def call(i):
            return [session.sample(prng.fold_in(root, i)).edges]
    elif traffic["call"] == "sample_batch":
        def call(i):
            return [g.edges for g in session.sample_batch(per, prng.fold_in(root, i))]
    else:
        raise ValueError(f"unknown call {traffic['call']!r}")

    def close():
        nonlocal session
        session = None

    return Work(call, lambda out: sum(int(e.shape[0]) for e in out), close, _counters, _ranges, LABELS)
