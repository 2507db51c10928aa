"""The plain reference at a tiny size: equal to the program on the CPU for
every kind of call the cells make, and its bfloat16 control unequal (the
control's test at a size a test run holds; on the card it runs at the
cells' own sizes through ``bench/control.py``)."""

import pytest

from bench.harness import check, spec
from bench.tests.conftest import THETA_1

BASE = {"engine": "quilt", "theta": THETA_1, "oversample": 1.05}
MAGM = dict(BASE, model="magm", mu=0.5, d=8, num_nodes=256, attribute_seed=0)
KPGM = dict(BASE, model="kpgm", d=9, num_nodes=512)
CASES = {
    "magm-exact": (MAGM, {"call": "sample"}),
    "magm-ranked": (MAGM, {"call": "sample", "exact_cells": False}),
    "magm-batch4-device": (MAGM, {"call": "sample_batch", "graphs_per_call": 4, "backend": "device"}),
    "magm-batch4-ranked": (MAGM, {"call": "sample_batch", "graphs_per_call": 4, "backend": "device", "exact_cells": False}),
    "kpgm-ranked": (KPGM, {"call": "sample", "exact_cells": False}),
    "magm-mu0.3": (dict(MAGM, mu=0.3, attribute_seed=5), {"call": "sample"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [7, 2**31 + 4093])
def test_reference_equals_the_program(case, seed):
    config, traffic = CASES[case]
    work = spec.plugin("engines", "quilt").build(config, traffic, seed, "cpu")
    ref = spec.reference(config, traffic, seed, "cpu")
    for i in (0, 5):
        got, want = work.call(i), ref.outputs(i)
        assert sum(e.shape[0] for e in want) > 0
        assert check.rows_differing(got, want) == 0


@pytest.mark.parametrize("case", ["magm-exact", "kpgm-ranked", "magm-batch4-ranked"])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_bfloat16_control_fails_the_check(case, seed):
    config, traffic = CASES[case]
    exact = spec.reference(config, traffic, seed, "cpu")
    low = spec.reference(config, traffic, seed, "cpu", precision="bfloat16")
    assert check.rows_differing(low.outputs(3), exact.outputs(3)) > check.LIMIT
    numbers, failed = exact.compare([(3, low.outputs(3))])
    assert not check.holds(numbers) and failed == 1


def test_rows_differing_counts_rows_lengths_and_graphs():
    import numpy as np

    a = np.arange(10).reshape(5, 2)
    b = a.copy()
    b[2, 1] += 1
    assert check.rows_differing([a], [a]) == 0
    assert check.rows_differing([b], [a]) == 1
    assert check.rows_differing([a[:3]], [a]) == 2
    assert check.rows_differing([a, a], [a]) == 5
    assert check.rows_differing([], [a]) == 5


def test_reservoir_keeps_k_calls_drawn_from_the_seed():
    picks = []
    for seed in (1, 1, 2):
        r = check.Reservoir(3, seed)
        for i in range(100):
            r.offer(i, [i])
        picks.append(sorted(i for i, _ in r.kept))
    assert len(picks[0]) == 3 and picks[0] == picks[1] and picks[0] != picks[2]


def test_control_script_reads_every_call_as_failing():
    from bench import control

    readings = control.control(MAGM, {"call": "sample"}, 21, 2, "cpu")
    assert len(readings) == 2
    for _, numbers in readings:
        assert numbers["rows_differing"][0] > numbers["rows_differing"][1] and not check.holds(numbers)


# the most units in the last place by which each float32 function of the
# reference lies from float64's value rounded to float32 (their measured
# worst cases on these inputs)
ULPS = {"exp": 1, "log": 1, "log1p": 2, "expm1": 5, "sqrt": 0}


@pytest.mark.parametrize("name", sorted(ULPS))
def test_f32_functions_against_float64(name):
    """``reference/f32.py`` copies the program's ``core/f32math.py`` bit for
    bit (the port's tests hold that against the JAX package), so a fault
    common to both would pass the check: float64 is the witness that shares
    no code with either."""
    import numpy as np
    import torch

    from bench.reference import f32

    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(-1, 1, 50_000), rng.uniform(-80, 80, 50_000),
                        np.exp(rng.uniform(-80, 80, 50_000))]).astype(np.float32)
    x = {"exp": x[np.abs(x) < 85], "expm1": x[np.abs(x) < 85], "log1p": x[(x > -1) & (x < 1e6)]}.get(
        name, np.abs(x[np.abs(x) > 1e-37]))
    got = getattr(f32, name)(torch.from_numpy(x.copy())).numpy()
    want = getattr(np, name)(x.astype(np.float64)).astype(np.float32)
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite)
    ulps = np.abs(got[finite].view(np.int32).astype(np.int64) - want[finite].view(np.int32).astype(np.int64))
    assert ulps.max() <= ULPS[name]


def test_f32_fma_rounds_the_exact_sum_once():
    from fractions import Fraction

    import numpy as np
    import torch

    from bench.reference import f32

    a, b, c = np.random.default_rng(6).uniform(-10, 10, (3, 2000)).astype(np.float32)
    got = f32.fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    exact = [Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)) for x, y, z in zip(a, b, c)]
    assert np.array_equal(got, np.array([float(e) for e in exact]).astype(np.float32))
