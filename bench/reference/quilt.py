"""The plain reference of the quilting engine's cells (``bench/engines/quilt.py``):
the sampler of ``sampler.py``, built from the configuration file and the
run's seed, recomputes the calls the check keeps, and every edge row is
compared with the program's (``harness/check.py::compare_rows``)."""

from __future__ import annotations

from typing import List

import numpy as np

from bench.harness import check
from bench.reference import prng, sampler


class Reference:
    """The reference sampler of one cell on ``device``."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str, precision: str = "float32"):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.precision = precision
        d = int(config["d"])
        thetas = sampler.thetas_of(config["theta"], d)
        if config["model"] == "magm":
            F = sampler.attributes(prng.key(int(config["attribute_seed"])), int(config["num_nodes"]), config["mu"], d, device)
            self.plan = sampler.plan(F, thetas, device)
        else:
            self.plan = sampler.kpgm_plan(thetas, device)
        flag = traffic.get("exact_cells")
        self.exact = (config["model"] == "magm") if flag is None else bool(flag)
        self.samples = int(traffic.get("graphs_per_call", 1))

    def outputs(self, i: int) -> List[np.ndarray]:
        """The edge arrays call ``i`` has to deliver."""
        k = prng.fold_in(prng.key(self.seed), i)
        return sampler.sample(
            k, self.plan, samples=self.samples, exact=self.exact, backend=self.traffic.get("backend", "auto"),
            oversample=float(self.config["oversample"]), precision=self.precision,
        )

    def compare(self, kept):
        """Every edge row of the kept calls against this reference's."""
        return check.compare_rows(self.outputs, kept, sampler.Unsupported)

    def work(self) -> dict:
        """One call's shapes for the roofline count: the candidate rows of
        its round (the exact budget per graph, or one ranked round at the
        mean edge count), the depth, and the lookup tables' shape (B rows,
        the widest block padded to a multiple of 8) with the B^2 block
        pairs."""
        return sampler.work(self.plan, self.samples, self.exact, float(self.config["oversample"]))
