"""Multi-rank MAGM quilting on PyTorch through the session facade.

    PYTHONPATH=src python examples/torch_distributed_sampling.py [--device cuda|cpu]

One SamplerConfig flows end to end: ``mesh="auto"`` places the B^2
block-pair streams along a ``graphs`` DeviceMesh over the ranks of the
running process group, every rank runs the fused descent -> block lookup
-> segmented dedup on its own chunk of graphs, and one all-gather of the
per-graph counts a round, then of the kept edges, are the only
cross-rank steps.  The graphs' streams never depend on the layout, so the
edge set is BIT-IDENTICAL to the single-device run on every rank, and the
streaming emission yields the same edges in fixed-size chunks, both
checked below.

On the card (the default) this runs in one process: a world of one rank
over NCCL, which the session starts.  With ``--device cpu`` it spawns
CPU_RANKS processes joined by gloo over a file store, so the multi-rank
path runs end to end without a card.
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.api import MAGMSampler, SamplerConfig
from repro_torch.core import magm, prng, quilt

THETA = np.array([[0.15, 0.70], [0.70, 0.85]], dtype=np.float32)
CPU_RANKS = 4
def sample_on_mesh(device: str, log2_n: int, chunk: int) -> None:
    """The unsharded run and the mesh run of one key, compared on this rank."""
    config = SamplerConfig(
        params=magm.make_params(THETA, 0.5, log2_n),
        num_nodes=2**log2_n,
        attribute_key=prng.PRNGKey(0),
        device=device,
    )
    key = prng.PRNGKey(1)
    edges_ref = MAGMSampler(config).sample(key).edges  # single device, same key

    sampler = MAGMSampler(config.replace(mesh="auto"))
    t0 = time.perf_counter()
    gs = sampler.sample(key)
    dt = time.perf_counter() - t0
    assert np.array_equal(gs.edges, edges_ref), "mesh path diverged from the unsharded run"
    assert quilt.DISPATCH_COUNTERS["host_topup_rounds"] == 0

    # streaming emission: fixed-size chunks, bit-identical concatenation
    chunks = list(sampler.sample_stream(key, chunk_edges=chunk))
    assert all(c.shape[0] == chunk for c in chunks[:-1])
    assert np.array_equal(np.concatenate(chunks), edges_ref)

    if sampler.world.rank == 0:
        info = gs.stats
        print(f"mesh           : {sampler.mesh}")
        print(f"world          : {sampler.world}")
        print(f"nodes          : {gs.n}")
        print(f"partition B    : {info.B}  ({info.num_kpgm_draws} block-pair graphs)")
        print(f"edges sampled  : {gs.num_edges}")
        print(f"expected edges : {magm.expected_edges(config.params, 2**log2_n):.0f}")
        print(f"single-device == {sampler.world.size}-rank edge set: exact")
        print(f"stream chunks  : {len(chunks)} x {chunk} (concat exact)")
        print(f"wall time      : {dt:.2f}s ({gs.num_edges / dt:.0f} edges/s)")


def _cpu_rank(rank: int, world: int, store: str, log2_n: int, chunk: int) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        sample_on_mesh("cpu", log2_n, chunk)
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log2-n", type=int, default=12)
    ap.add_argument("--chunk-edges", type=int, default=1 << 14)
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda":
        from repro_torch.launch import mesh as mesh_lib

        try:
            sample_on_mesh(args.device, args.log2_n, args.chunk_edges)
        finally:
            mesh_lib.release()
        return
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_cpu_rank, args=(CPU_RANKS, os.path.join(tmp, "store"), args.log2_n, args.chunk_edges),
                 nprocs=CPU_RANKS, join=True)


if __name__ == "__main__":
    main()
