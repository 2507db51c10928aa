"""The port's cost model and dry-run (``repro_torch.analysis.op_cost``,
``analysis.roofline``'s step terms, ``launch.dryrun``), on the CPU:

- ``op_cost`` on one matmul: 2MNK FLOPs and its operands' and result's
  bytes; a view counts nothing;
- one Megatron MLP (column- then row-parallel) on a 2x2 fake mesh: each
  device's FLOPs are its shards', and the only collective is the
  all-reduce of its (B/2, D) partial output;
- smoke-config cells of each family (dense, moe, ssm, hybrid, vlm, audio)
  x {train, prefill, decode} end ``ok`` on a 2x2 fake mesh and on a 2x2x2
  ``(pod, data, model)`` one, at small shapes;
- a smoke dense train step's per-device FLOPs on one device against the
  reference's ``hlo_cost.analyze`` of its compiled 1-device module: the
  port counts exactly 2 b s^2 (h hd) more per layer, one score-sized
  product (XLA merges the remat's recomputed q k^T of each block with the
  backward's identical one; eager PyTorch computes both);
- ``SKIPS`` and ``Roofline.row()``'s keys equal the reference's (its
  ``launch.dryrun`` imported in a subprocess: it pins 512 host devices);
- the unit-cell extrapolation against a deeper trace.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch import configs
from repro_torch.analysis import op_cost, roofline
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from test_torch_reference import SRC, ref  # noqa: F401  (fixture)

TESTS = os.path.dirname(os.path.abspath(__file__))
SMALL = {"train": ShapeConfig("train_s", 64, 4, "train"), "prefill": ShapeConfig("prefill_s", 64, 4, "prefill"),
         "decode": ShapeConfig("decode_s", 64, 4, "decode")}
FAMILIES = {"dense": "yi_9b", "moe": "phi3_5_moe_42b", "ssm": "falcon_mamba_7b", "hybrid": "zamba2_2_7b",
            "vlm": "llama_3_2_vision_90b", "audio": "whisper_base"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread_and_world():
    """One intra-op thread (6 test workers share the cores); the module's
    fake world is torn down at its end."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
    mesh_lib.release()


@pytest.mark.parametrize("m,k,n", [(7, 5, 3), (64, 128, 32)])
def test_matmul_cost(m, k, n):
    a, b = torch.randn(m, k), torch.randn(k, n)
    out, tally = op_cost.count(lambda: (a @ b).t())
    assert tally.cost.flops == 2 * m * n * k
    assert tally.cost.bytes == 4 * (m * k + k * n + m * n)  # the transpose is a view
    assert tally.cost.coll_bytes == 0 and tally.peak == 4 * m * n
    assert out.shape == (n, m)


def test_megatron_mlp_collectives():
    from torch.distributed.tensor import DTensor, Replicate, Shard

    B, D, F = 8, 16, 32
    dmesh = mesh_lib.make_fake_mesh((2, 2), ("data", "model"))
    tally = op_cost.Tally()

    def put(shape, pl):
        local = [s // (2 if any(p == Shard(i) for p in pl) else 1) for i, s in enumerate(shape)]
        return DTensor.from_local(torch.empty(local, device="meta"), dmesh, pl, run_check=False, shape=shape,
                                  stride=torch.empty(shape, device="meta").stride())

    with op_cost.Counter(tally, "meta"):
        x = put((B, D), [Shard(0), Replicate()])
        w1 = put((D, F), [Replicate(), Shard(1)])  # column-parallel
        w2 = put((F, D), [Replicate(), Shard(0)])  # row-parallel
        tally.reset()
        y = ((x @ w1) @ w2).redistribute(dmesh, [Shard(0), Replicate()])
    assert tuple(y.to_local().shape) == (B // 2, D)
    assert tally.cost.flops == 2 * (B // 2) * D * (F // 2) * 2
    assert tally.cost.coll == {"all-gather": 0, "all-reduce": (B // 2) * D * 4, "reduce-scatter": 0,
                               "all-to-all": 0, "collective-permute": 0}


def _smoke_cell_ok(family: str, kind: str, sizes, names) -> None:
    rec = dryrun.lower_cell(FAMILIES[family], SMALL[kind], mesh=(sizes, names), smoke=True, verbose=False)
    assert rec["status"] == "ok" and rec["chips"] == math.prod(sizes) and rec["mesh"] == "x".join(map(str, sizes))
    assert rec["hlo_gflops_per_chip"] > 0 and rec["hlo_gbytes_per_chip"] > 0
    assert rec["peak_bytes_per_chip"] >= rec["arg_bytes_per_chip"] > 0
    assert set(rec["coll_breakdown"]) == set(roofline.KINDS) and rec["coll_gbytes_per_chip"] > 0
    assert rec["t_step_s"] >= rec["t_ideal_s"] and rec["bottleneck"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("kind", list(SMALL))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_smoke_cells_on_2x2(family, kind):
    _smoke_cell_ok(family, kind, (2, 2), ("data", "model"))


@pytest.mark.parametrize("kind", list(SMALL))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_smoke_cells_on_2x2x2(family, kind):
    """The multi-pod mesh's axes at size 2: the batch over both ``pod`` and
    ``data`` (the placements torch 2.11's DTensor refused for the
    embedding's gather), the vocab over ``model``."""
    _smoke_cell_ok(family, kind, (2, 2, 2), ("pod", "data", "model"))


def test_dense_train_flops_match_reference_hlo(ref):
    import jax

    from repro.analysis import hlo_cost
    from repro.train import optimizer as ropt
    from repro.train import steps as rsteps

    arch, b, s = "olmo_1b", 2, 64
    cfg = ref.lm_configs.get_smoke(arch)
    m = ref.lm.build(cfg)
    p = m.abstract_params()
    inputs = m.input_specs(ref.lm_configs.base.ShapeConfig("t", s, b, "train"))
    compiled = jax.jit(rsteps.make_train_step(m)).lower(p, jax.eval_shape(ropt.init, p), inputs).compile()
    want = hlo_cost.analyze(compiled.as_text()).flops
    rec = dryrun.lower_cell(arch, ShapeConfig("t", s, b, "train"), mesh="host", smoke=True, verbose=False)
    got = rec["hlo_gflops_per_chip"] * 1e9
    extra = 2 * b * s * s * cfg.num_heads * cfg.head_dim * cfg.num_layers
    assert got - want == extra, (got, want, extra)


_REFERENCE = """
import sys, json
sys.path[:0] = [{tests!r}, {src!r}]
from test_torch_reference import reference_package
with reference_package() as ref:
    import importlib
    dr = importlib.import_module("repro.launch.dryrun")
    print(json.dumps({{"skips": {{"|".join(k): v for k, v in dr.SKIPS.items()}},
                      "units": {{a: dr.pattern_unit(ref.lm_configs.get(a)) for a in ref.lm_configs.ARCHS}}}}))
"""


def test_skips_units_and_row_keys_match_reference(ref):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    script = textwrap.dedent(_REFERENCE.format(tests=TESTS, src=os.path.abspath(SRC)))
    proc = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"|".join(k): v for k, v in dryrun.SKIPS.items()} == want["skips"]
    assert {a: dryrun.pattern_unit(configs.get(a)) for a in configs.ARCHS} == want["units"]

    cfg, shape = configs.get("olmo_1b"), configs.get_shape("train_4k")
    port = roofline.build("olmo_1b", shape, cfg, "16x16", 256, {"flops": 1e12, "bytes accessed": 1e9},
                          {"all-gather": 5.0}, None)
    reference = ref.roofline.build("olmo_1b", ref.lm_configs.get_shape("train_4k"), ref.lm_configs.get("olmo_1b"),
                                   "16x16", 256, {"flops": 1e12, "bytes accessed": 1e9}, "", None)
    assert list(port.row()) == list(reference.row())
    assert port.row()["model_gflops_per_chip"] == reference.row()["model_gflops_per_chip"]
    assert port.coll_breakdown == {k: (5 if k == "all-gather" else 0) for k in roofline.KINDS}


def test_extrapolation_reproduces_full_depth():
    """Depths 2u and 3u extrapolated to 4u against the 4u trace (a dense
    smoke config): FLOPs and the arguments' bytes
    exactly (every layer of a stack past the first costs the same); the
    bytes and each collective kind within 10% (DTensor's choice between
    two redistributions may turn with a stack's size)."""
    for arch in ("yi_9b",):
        cfg = configs.get_smoke(arch)
        u = dryrun.pattern_unit(cfg)
        spec = ((2, 2), ("data", "model"))
        a, b, full = (dryrun.trace_cell(dataclasses.replace(cfg, num_layers=n * u), SMALL["train"], spec)
                      for n in (2, 3, 4))
        ex = dryrun._extrapolate(a, b, 4)
        assert (ex["cost"].flops, ex["arg_bytes"]) == (full["cost"].flops, full["arg_bytes"]), arch
        assert abs(ex["cost"].bytes - full["cost"].bytes) <= 0.1 * full["cost"].bytes, arch
        for k, v in full["cost"].coll.items():
            assert abs(ex["cost"].coll[k] - v) <= 0.1 * v, (arch, k)
