"""Quickstart on PyTorch: sample a MAGM graph through the port's session
facade and inspect it.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]

One frozen SamplerConfig describes the draw; the MAGMSampler session
resolves it into owned device state once (attribute matrix, quilt plan,
PRNG stream) and every .sample() after that reuses it.  Runs on the card
unless ``--device cpu`` is given.
"""

import argparse

import numpy as np

from repro_torch.api import MAGMSampler, SamplerConfig
from repro_torch.core import magm, prng, stats

# the paper's Theta_1 (Kim & Leskovec 2010), mu = 0.5, n = 2^12
THETA = np.array([[0.15, 0.70], [0.70, 0.85]], dtype=np.float32)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--log2-n", type=int, default=12)
args = ap.parse_args()
D = args.log2_n
N = 2**D

config = SamplerConfig(
    params=magm.make_params(THETA, 0.5, D),
    num_nodes=N,
    attribute_key=prng.PRNGKey(0),
    split=True,  # Section-5 split sampler (heavy configs as ER blocks)
    device=args.device,
)
sampler = MAGMSampler(config)
gs = sampler.sample(prng.PRNGKey(1))
edges, info = gs.edges, gs.stats

out_deg, in_deg = stats.degree_counts(edges, N)
print(f"device                : {sampler.device}")
print(f"nodes                 : {gs.n}")
print(f"edges                 : {gs.num_edges}")
print(f"expected edges        : {magm.expected_edges(config.params, N):.0f}")
print(f"partition size B      : {info.B}  (log2 n = {D})")
print(f"KPGM draws quilted    : {info.num_kpgm_draws}")
print(f"heavy config groups   : {info.heavy_groups}")
print(f"max out-degree        : {out_deg.max()}")
print(f"largest SCC fraction  : {stats.largest_scc_fraction(edges, N):.3f}")

# warm repeats amortize the session state: no re-partition, no re-plan
for _ in range(2):
    again = sampler.sample()  # session key stream
    print(f"warm resample         : {again.num_edges} edges")
