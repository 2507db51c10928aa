"""Data pipeline: the paper's quilted MAGM sampler as a training corpus,
and the CSR form that edge ingest (``fit/ingest.py``) also builds — the
reference's ``repro.data.pipeline``.

:class:`MAGMCorpus` samples one MAGM graph with the section-5 split
(``MAGMSampler(split=True)`` on the corpus's device; its light quilt
launches ``quilt_prng_descent_lookup``), then turns it into token batches
by random walks over the graph: each sequence is a walk, each token a node
id hashed into the vocabulary.  The walks are numpy draws, so a corpus is
the reference's bit for bit wherever its graph is.

Deterministic cursor: ``batch(step)`` is a pure function of (seed, step),
so the fault supervisor's restart replays identical data
(``dist/fault.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.api import MAGMSampler, SamplerConfig
from repro_torch.configs import magm_paper
from repro_torch.core import magm, prng
from repro_torch.core.device import resolve_device


def build_csr(edges: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(E, 2) directed edge list -> CSR ``(indptr, adj)`` over n nodes.

    ``adj[indptr[i]:indptr[i+1]]`` are i's out-neighbours (stable source
    order preserved).
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if edges.size == 0:
        return np.zeros(n + 1, dtype=np.int64), np.zeros((0,), dtype=np.int64)
    if edges[:, 0].min() < 0 or edges[:, 0].max() >= n:
        raise ValueError(f"edge sources must lie in [0, {n})")
    order = np.argsort(edges[:, 0], kind="stable")
    adj = edges[order, 1].copy()
    counts = np.bincount(edges[:, 0], minlength=n)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return indptr, adj


@dataclasses.dataclass
class MAGMCorpus:
    """Random-walk token batches over one quilted MAGM graph of
    ``num_nodes`` nodes (d = log2 n levels of ``theta``, default THETA_1,
    and ``mu``), sampled on ``device`` (default ``"cuda"``; raises without a
    card)."""

    num_nodes: int
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    mu: float = 0.5
    theta: Optional[np.ndarray] = None
    restart_prob: float = 0.05  # teleport on dead ends / mixing
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        d = max(int(np.log2(self.num_nodes)), 1)
        theta = self.theta if self.theta is not None else magm_paper.THETA_1
        params = magm.make_params(theta, self.mu, d)
        f_key, q_key = prng.split(prng.PRNGKey(self.seed))
        F = magm.sample_attributes(f_key, self.num_nodes, params.mu, device=self.device).cpu().numpy()
        sampler = MAGMSampler(SamplerConfig(params=params, F=F, split=True, device=self.device))
        gs = sampler.sample(q_key)
        self.quilt_stats = gs.stats
        self._build_csr(gs.edges)

    # --- graph -> walk machinery ---------------------------------------
    def _build_csr(self, edges: np.ndarray) -> None:
        self.num_edges = edges.shape[0]
        self.indptr, self.adj = build_csr(edges, self.num_nodes)

    def _walk(self, rng: np.random.Generator) -> np.ndarray:
        n = self.num_nodes
        node = int(rng.integers(0, n))
        out = np.empty(self.seq_len + 1, dtype=np.int64)
        for t in range(self.seq_len + 1):
            out[t] = node
            lo, hi = self.indptr[node], self.indptr[node + 1]
            if hi <= lo or rng.random() < self.restart_prob:
                node = int(rng.integers(0, n))
            else:
                node = int(self.adj[rng.integers(lo, hi)])
        return out

    def _tok(self, nodes: np.ndarray) -> np.ndarray:
        # stable node-id -> vocab hash (splitmix-style) so token identity is
        # consistent across batches without a 2^d embedding table
        x = nodes.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        x ^= x >> np.uint64(31)
        return (x % np.uint64(self.vocab_size)).astype(np.int32)

    # --- public API ------------------------------------------------------
    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Deterministic batch for one step: int32 ``tokens`` and
        ``labels`` (B, S) on the corpus's device."""
        rng = np.random.default_rng((self.seed << 20) ^ step)
        walks = np.stack([self._walk(rng) for _ in range(self.batch_size)])
        toks = torch.from_numpy(self._tok(walks))
        return {
            "tokens": toks[:, : self.seq_len].contiguous().to(self.device),
            "labels": toks[:, 1 : self.seq_len + 1].contiguous().to(self.device),
        }
