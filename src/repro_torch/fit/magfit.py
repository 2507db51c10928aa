"""MAGFIT on PyTorch: variational-EM estimation of MAG parameters.

Given an observed edge list on n nodes and an attribute count d, estimate
the per-attribute affinity matrices ``thetas`` (d, 2, 2), the Bernoulli
means ``mu`` (d,) and a mean-field posterior q(F) = prod_{i,k}
Bernoulli(phi_ik) over the latent attribute bits, by maximising the
evidence lower bound

    ELBO = sum_{(i,j) in E}  E_q[log Q_ij]            (edge term)
         - sum_{(i,j) in E}  E_q[log(1 - Q_ij)]       (edge correction)
         + sum_{ALL (i,j)}   E_q[log(1 - Q_ij)]       (all-pairs penalty)
         + sum_{i,k} E_q[log P(f_ik | mu_k)] + H(q)   (prior + entropy)

``log Q`` is bilinear in the bits, so ``E_q[log Q_ij]`` is the same form on
phi; ``log(1 - Q)`` is the order-``order`` Taylor sum ``-sum_p Q^p / p``,
whose all-pairs expectation is the Kronecker quadratic form ``cbar^T P_p
cbar`` over the soft configuration counts (plus an exact self-pair
correction), O(order d n 2^d).  Only the edge-indexed terms touch the edge
list, in passes over whole fixed-shape shards (:func:`shard_edges`).

- E-step (:func:`estep`): Adam on the phi logits, the best visited point.
- M-step (:func:`mstep`): ``mu = mean(phi)``; one Gauss-Seidel sweep of
  per-cell Newton solves on the sufficient statistics (:func:`suff_stats`),
  refined by AdamW (``train/optimizer.py``); never worse than the input.
- Driver (:func:`magfit`): every candidate is re-scored by one ELBO and
  accepted only if it does not decrease it, so the trace is non-decreasing.

Beside them the dense scoring: :func:`dense_expected_logprob` runs the
``magm_logprob`` tile kernel (``csrc/magm_logprob.cu``) on phi with
``use_kernel=True``, and :func:`elbo_dense` is the O(n^2) reference ELBO.

Gradients follow the reference's: ``log`` differentiates as g / x, and
``clip`` as JAX's ``min(max(x, lo), hi)`` does, 1/2 at either bound
(:class:`_Clip`), which matters where phi saturates to exactly 0 or 1.  The
backward of the gathers ``phi[src]`` adds each node's gradients in a fixed
order (:class:`_Rows`), so a fit gives the same bits twice.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import f32math, magm, prng
from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.train import optimizer as _opt

# past this much soft-configuration state (n * 2^d float32 entries) the
# O(n 2^d) soft moments stop being E-step side work
FIT_STATE_CAP = 1 << 27
# edge rows gathered in one pass (whole shards): bounds the per-edge
# intermediates, as the reference's scan over shards does
EDGE_PASS_ROWS = 1 << 22

_THETA_EPS = 1e-3  # thetas are clipped to [eps, 1 - eps]
_LOG_EPS = 1e-12


class FitData(NamedTuple):
    """Observed edges padded into fixed-shape ``(S, K)`` shards on the
    fit's device.  ``wt`` is 1.0 on real edges and 0.0 on padding rows,
    which are (0, 0) self-pairs that every term multiplies by ``wt``."""

    src: torch.Tensor  # (S, K) int32
    dst: torch.Tensor  # (S, K) int32
    wt: torch.Tensor  # (S, K) float32


class FitOptions(NamedTuple):
    """Knobs of the EM loop (defaults tuned for n ~ 2^10..2^12)."""

    order: int = 3  # truncation order of the log(1-Q) expansion
    em_iters: int = 16  # max EM iterations
    estep_steps: int = 40  # Adam steps per E-step
    estep_lr: float = 0.4
    mstep_steps: int = 10  # optimizer.py refinement steps per M-step
    mstep_lr: float = 0.08
    tol: float = 1e-6  # relative ELBO gain under which EM stops
    # after latent EM, refit (thetas, mu) on the hardened posteriors (phi
    # thresholded at 1/2), the hard F that fitted_config samples with;
    # thetas tuned against soft phi overshoot edge counts once the soft
    # mass collapses.  No-op when fit_phi=False.
    harden: bool = True


class FitResult(NamedTuple):
    params: magm.MAGMParams  # fitted (thetas, mu), float32 on the CPU
    phi: np.ndarray  # (n, d) posterior P(f_ik = 1)
    elbo_trace: np.ndarray  # per-EM-iteration ELBO, non-decreasing
    iterations: int
    converged: bool

    @property
    def n(self) -> int:
        return int(self.phi.shape[0])

    @property
    def d(self) -> int:
        return int(self.phi.shape[1])


def _f32(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)  # lint: disable=host-sync-in-step -- estep/mstep's host inputs, one copy each a call (a no-op on the card)


def _on(data: FitData, dev: torch.device) -> FitData:
    return FitData(*(t.to(dev) for t in data))


# ---------------------------------------------------------------------------
# edge sharding
# ---------------------------------------------------------------------------


def shard_edges(
    edges: np.ndarray,
    n: int,
    *,
    shard_size: Optional[int] = None,
    mesh=None,
    device=None,
) -> FitData:
    """Pack an (E, 2) edge list into fixed-shape ``(S, K)`` shards on
    ``device`` (default ``"cuda"``; raises without a card).

    ``shard_size`` defaults to the least power of two >= E, at most 2^15
    rows.  With a ``mesh`` the shard count is rounded up to a multiple of
    the mesh's graphs-axis size (``dist.sharding.graph_shard_axes``), so a
    sharded E-step can split whole shards across ranks without
    re-padding; the extra shards hold zero-weight rows.
    """
    dev = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if edges.size and (edges.min() < 0 or edges.max() >= n):
        raise ValueError(
            f"edge endpoints must lie in [0, {n}); got [{edges.min()}, {edges.max()}]"
        )
    e = max(int(edges.shape[0]), 1)
    k = int(shard_size) if shard_size else min(1 << 15, 1 << (e - 1).bit_length())
    if k < 1:
        raise ValueError(f"shard_size must be >= 1, got {shard_size}")
    s = -(-e // k)
    if mesh is not None:
        from repro_torch.dist import sharding as _sharding

        _, nshards = _sharding.graph_shard_axes(mesh)
        s += (-s) % max(nshards, 1)
    src = np.zeros(s * k, dtype=np.int32)
    dst = np.zeros(s * k, dtype=np.int32)
    wt = np.zeros(s * k, dtype=np.float32)
    src[: edges.shape[0]] = edges[:, 0]
    dst[: edges.shape[0]] = edges[:, 1]
    wt[: edges.shape[0]] = 1.0
    return FitData(*(torch.from_numpy(x.reshape(s, k)).to(dev) for x in (src, dst, wt)))


def _passes(data: FitData) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """(src, dst, wt) rows of whole shards, at most EDGE_PASS_ROWS a pass."""
    s, k = data.src.shape
    step = max(1, EDGE_PASS_ROWS // max(k, 1))
    for lo in range(0, s, step):
        hi = lo + step
        yield data.src[lo:hi].reshape(-1).long(), data.dst[lo:hi].reshape(-1).long(), data.wt[lo:hi].reshape(-1)


# ---------------------------------------------------------------------------
# differentiable float32 pieces (the fitter's paths only)
# ---------------------------------------------------------------------------


def _flog(x: torch.Tensor) -> torch.Tensor:
    """log with the reference's float32 bits (``f32math.log``); float64,
    which only the tests' evaluations use, through ``torch.log``."""
    return f32math.log(x) if x.dtype == torch.float32 else torch.log(x)


class _Log(torch.autograd.Function):
    """:func:`_flog` with the derivative g / x."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _flog(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g / x


class _Clip(torch.autograd.Function):
    """``clamp(x, lo, hi)`` with JAX's derivative of ``min(max(x, lo),
    hi)``: 1 inside, 0 outside, and 1/2 at either bound, where JAX's max
    and min split a tie evenly (``torch.clamp`` gives 1 there)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        slope = ((x > lo) & (x < hi)).to(g.dtype) + 0.5 * ((x == lo) | (x == hi)).to(g.dtype)
        return g * slope, None, None


class _Rows(torch.autograd.Function):
    """``x[idx]`` whose backward adds each row's gradients in a fixed
    order, so a fit gives the same bits twice: on CUDA through
    ``index_put_(accumulate=True)``, which sorts the indices (no atomics),
    on the CPU through ``index_add_``, which runs serially (the CPU's
    ``index_put_`` accumulates from several threads)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[0]
        return x[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        out = g.new_zeros((ctx.rows,) + tuple(g.shape[1:]))
        if g.is_cuda:
            return out.index_put_((idx,), g, accumulate=True), None
        return out.index_add_(0, idx, g), None


def _log_clip(x: torch.Tensor, lo: float, hi: float = 1.0) -> torch.Tensor:
    return _Log.apply(_Clip.apply(x, lo, hi))


def _bilinear(thetas: torch.Tensor) -> magm.BilinearLogTheta:
    """``magm.bilinear_decompose`` (the same bits) with gradients."""
    return magm.bilinear_from_log(_log_clip(thetas, 1e-30))


def _xlogx(x: torch.Tensor) -> torch.Tensor:
    return x * _log_clip(x, _LOG_EPS)


def _prior_entropy(phi: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """``sum E_q[log P(f | mu)] + H(q)``."""
    prior = torch.sum(
        phi * _log_clip(mu, _LOG_EPS)[None, :] + (1.0 - phi) * _log_clip(1.0 - mu, _LOG_EPS)[None, :]
    )
    return prior - torch.sum(_xlogx(phi) + _xlogx(1.0 - phi))


def _prod_last(x: torch.Tensor) -> torch.Tensor:
    """Product over the last axis from index 0 up, as chained multiplies
    (``torch.prod``'s backward syncs the host to look for zeros)."""
    if x.shape[-1] == 0:
        return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc * x[..., k]
    return acc


# ---------------------------------------------------------------------------
# soft-attribute building blocks
# ---------------------------------------------------------------------------


def _soft_attr(phi: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n, d, 2) per-bit marginals [q(f=0), q(f=1)]."""
    return torch.stack([1.0 - phi, phi], dim=-1)


def _soft_configs(a: torch.Tensor) -> torch.Tensor:
    """(n, d, 2) -> (n, 2^d) product distribution over configurations,
    level 0 the most significant bit (``magm.configs_from_attributes``);
    its column sums are the soft configuration multiplicities."""
    n, d = a.shape[0], a.shape[1]
    b = a[:, 0, :]
    for k in range(1, d):
        b = (b[:, :, None] * a[:, k, None, :]).reshape(n, -1)
    return b


def _kron_matvec_rows(T: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    """Row-batched Kronecker matvec ``(P b_i^T)_i`` for ``P = kron(T_0 ..
    T_{d-1})``: level t mixes the two halves of axis t of the (n, 2, ..., 2)
    view, O(n d 2^d)."""
    n = b.shape[0]
    out = b
    for t in range(d):
        x = out.reshape(n << t, 2, -1)
        x0, x1 = x[:, 0], x[:, 1]
        out = torch.stack([T[t, 0, 0] * x0 + T[t, 0, 1] * x1, T[t, 1, 0] * x0 + T[t, 1, 1] * x1], dim=1)
    return out.reshape(n, -1)


def _soft_pair_moment(Tp: torch.Tensor, b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``sum over ALL ordered pairs (i, j) of E_q[Q_ij^p]`` given Tp =
    theta^p: ``cbar^T P_p cbar`` for the independent pairs, the diagonal
    corrected exactly (for i = j the bits coincide, so ``E[Q_ii^p]``
    contracts the per-level diagonal of Tp)."""
    d = Tp.shape[0]
    cbar = torch.sum(b, dim=0)
    s_indep = cbar @ _kron_matvec_rows(Tp, cbar[None, :], d)[0]
    pb = _kron_matvec_rows(Tp, b, d)
    s_self_indep = torch.sum(b * pb)
    diag = a[:, :, 0] * Tp[None, :, 0, 0] + a[:, :, 1] * Tp[None, :, 1, 1]
    s_self_exact = torch.sum(_prod_last(diag))
    return s_indep - s_self_indep + s_self_exact


def _edge_moment_shard(Tp, a_s, a_t, is_self, wt) -> torch.Tensor:
    """``sum over edge rows of E_q[Q_e^p]`` (exact on self-edges)."""
    m = a_s[..., 0] * (Tp[:, 0, 0] * a_t[..., 0] + Tp[:, 0, 1] * a_t[..., 1]) + a_s[..., 1] * (
        Tp[:, 1, 0] * a_t[..., 0] + Tp[:, 1, 1] * a_t[..., 1]
    )
    md = a_s[..., 0] * Tp[None, :, 0, 0] + a_s[..., 1] * Tp[None, :, 1, 1]
    mk = torch.where(is_self[:, None], md, m)
    return torch.sum(wt * _prod_last(mk))


def _edge_loglik_shard(bl: magm.BilinearLogTheta, phi_s, phi_t, is_self, wt) -> torch.Tensor:
    """``sum over edge rows of E_q[log Q_e]`` via the bilinear form; for
    i = j the interaction is linear (f^2 = f), so the value gets the exact
    correction ``sum_k w_k (phi_ik - phi_ik^2)``.  Row sums, not matrix
    products, so the gradients of u and v sum the edges as reductions."""
    base = (
        bl.c0 + torch.sum(phi_s * bl.u, dim=1) + torch.sum(phi_t * bl.v, dim=1)
        + torch.sum(phi_s * bl.w[None, :] * phi_t, dim=1)
    )
    corr = torch.sum(bl.w[None, :] * (phi_s - phi_s * phi_t), dim=1)
    return torch.sum(wt * (base + torch.where(is_self, corr, 0.0)))


def _edge_terms(phi, thetas, data: FitData, order: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(edge log-lik sum, edge sum of sum_p E[Q^p]/p) over all shards."""
    bl = _bilinear(thetas)
    tstack = [thetas**p for p in range(1, order + 1)]
    ll = em = 0.0
    for src, dst, wt in _passes(data):
        phi_s, phi_t = _Rows.apply(phi, src), _Rows.apply(phi, dst)
        a_s, a_t = _soft_attr(phi_s), _soft_attr(phi_t)
        is_self = src == dst
        ll = ll + _edge_loglik_shard(bl, phi_s, phi_t, is_self, wt)
        for p in range(order):
            em = em + _edge_moment_shard(tstack[p], a_s, a_t, is_self, wt) / (p + 1)
    return ll, em


# ---------------------------------------------------------------------------
# the objective
# ---------------------------------------------------------------------------


def _elbo(phi, thetas, mu, data: FitData, order: int) -> torch.Tensor:
    a = _soft_attr(phi)
    b = _soft_configs(a)
    ll, em = _edge_terms(phi, thetas, data, order)
    s = 0.0
    for p in range(1, order + 1):
        s = s + _soft_pair_moment(thetas**p, b, a) / p
    return ll + em - s + _prior_entropy(phi, mu)


def elbo(phi, thetas, mu, data: FitData, *, order: int = 3, device=None) -> torch.Tensor:
    """The order-``order`` truncated ELBO, a float32 scalar on ``device``
    (default ``"cuda"``; raises without a card), differentiable in
    ``phi``, ``thetas`` and ``mu``; equal up to float association to the
    O(n^2) :func:`elbo_dense`."""
    dev = resolve_device(device)
    return _elbo(_f32(phi, dev), _f32(thetas, dev), _f32(mu, dev), _on(data, dev), order)


def dense_expected_logprob(phi, thetas, *, use_kernel: bool = False, device=None) -> torch.Tensor:
    """(n, n) float32 matrix of ``E_q[log Q_ij]`` for i != j (dense, O(n^2 d))
    on ``device`` (default ``"cuda"``; raises without a card).

    ``use_kernel=True`` runs the ``magm_logprob`` tile kernel (its plain
    version on the CPU); otherwise the plain products of
    ``magm.log_edge_prob``.  Diagonal entries follow the independent-bits
    convention: add ``sum_k w_k (phi - phi^2)`` for exact self-pair values.
    """
    phi = torch.as_tensor(phi).to(device=resolve_device(device), dtype=torch.float32)
    if use_kernel:
        return ops.magm_logprob(phi, phi, thetas)
    return magm.log_edge_prob(phi, phi, thetas)


def elbo_dense(
    phi,
    thetas,
    mu,
    edges,
    n: int,
    *,
    order: int = 3,
    use_kernel: bool = False,
    device=None,
) -> torch.Tensor:
    """O(n^2) per-pair reference ELBO (tests and small-n scoring only), a
    float32 scalar on ``device`` (default ``"cuda"``; raises without a card).

    Materializes every pair's ``E[log Q]`` (through the tile kernel with
    ``use_kernel=True``) and ``E[Q^p]`` for the order-``order`` Taylor
    expansion of the non-edge term ``log(1 - Q)``.
    """
    dev = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    phi = torch.as_tensor(phi).to(device=dev, dtype=torch.float32)
    thetas = _f32(thetas, dev)
    mu = _f32(mu, dev)
    a = _soft_attr(phi)
    adj = torch.zeros((n, n), dtype=torch.float32, device=dev)
    if edges.size:
        e = torch.from_numpy(edges).to(dev)
        adj[e[:, 0], e[:, 1]] = 1.0

    bl = magm.bilinear_decompose(thetas)
    logq = dense_expected_logprob(phi, thetas, use_kernel=use_kernel, device=dev)
    self_corr = torch.sum(bl.w[None, :] * (phi - phi * phi), dim=1)
    logq = logq + torch.diag(self_corr)
    ll = torch.sum(adj * logq)

    eye = torch.eye(n, dtype=torch.bool, device=dev)
    neg1m = torch.zeros((n, n), dtype=torch.float32, device=dev)
    for p in range(1, order + 1):
        tp = thetas**p
        pair = torch.prod(torch.einsum("ida,dab,jdb->ijd", a, tp, a), dim=2)
        md = a[:, :, 0] * tp[None, :, 0, 0] + a[:, :, 1] * tp[None, :, 1, 1]
        pair = torch.where(eye, torch.prod(md, dim=1)[:, None], pair)
        neg1m = neg1m + pair / p
    penalty = torch.sum((1.0 - adj) * neg1m)
    return ll - penalty + _prior_entropy(phi, mu)


# ---------------------------------------------------------------------------
# M-step sufficient statistics and closed form
# ---------------------------------------------------------------------------


def _edge_cell_counts(phi, data: FitData) -> torch.Tensor:
    N = torch.zeros((phi.shape[1], 2, 2), dtype=phi.dtype, device=phi.device)
    for src, dst, wt in _passes(data):
        a_s, a_t = _soft_attr(phi[src]), _soft_attr(phi[dst])
        is_self = (src == dst).to(phi.dtype)
        # sums over the edges as reductions, not as a matrix product: a
        # product's long dot runs (K = E) lose ~1e-5 on the card
        w_pair = (wt * (1.0 - is_self))[:, None, None, None]
        outer = torch.sum(w_pair * a_s[:, :, :, None] * a_t[:, :, None, :], dim=0)
        diag = torch.sum((wt * is_self)[:, None, None] * a_s, dim=0)
        outer[:, 0, 0] += diag[:, 0]
        outer[:, 1, 1] += diag[:, 1]
        N = N + outer
    return N


def edge_cell_counts(phi, data: FitData, *, device=None) -> torch.Tensor:
    """Expected edge counts per attribute cell, ``N[k, a, b]``: the expected
    number of observed edges whose endpoint bits at attribute k are (a, b)
    (self-edges count exactly, on the diagonal).  Theta-free, so the M-step
    computes it once.  On ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    with torch.no_grad():
        return _edge_cell_counts(_f32(phi, dev), _on(data, dev))


def _penalty_coeffs(a, b, thetas, data: FitData, order: int) -> Tuple[torch.Tensor, ...]:
    """The gradients of the non-edge mass with respect to each ``theta^p``."""
    out = []
    with torch.enable_grad():
        for p in range(1, order + 1):
            tp = (thetas.detach() ** p).requires_grad_(True)
            e_sum = 0.0
            for src, dst, wt in _passes(data):
                e_sum = e_sum + _edge_moment_shard(tp, a[src], a[dst], src == dst, wt)
            (g,) = torch.autograd.grad(_soft_pair_moment(tp, b, a) - e_sum, tp)
            out.append(g)
    return tuple(out)


def penalty_coeffs(phi, thetas, data: FitData, *, order: int = 2, device=None) -> Tuple[torch.Tensor, ...]:
    """Non-edge penalty coefficients ``(C_1, ..., C_order)`` on ``device``
    (default ``"cuda"``).

    ``C_p[k, a, b]`` is the coefficient of ``theta_k[a,b]^p`` in the
    non-edge penalty: the gradient of the soft quadratic forms with respect
    to the entrywise power ``theta^p`` (the penalty is multilinear in those
    slices).  With ``N = edge_cell_counts(phi, data)`` the truncated ELBO
    reads, per attribute entry, ``N log t - sum_p C_p t^p / p + const``.
    """
    dev = resolve_device(device)
    with torch.no_grad():
        a = _soft_attr(_f32(phi, dev))
        b = _soft_configs(a)
    return _penalty_coeffs(a, b, _f32(thetas, dev), _on(data, dev), order)


def suff_stats(
    phi, thetas, data: FitData, *, order: int = 2, device=None
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """M-step sufficient statistics ``(N, (C_1, ..., C_order))``."""
    return (
        edge_cell_counts(phi, data, device=device),
        penalty_coeffs(phi, thetas, data, order=order, device=device),
    )


def closed_form_thetas(N, C1, C2=None, *, eps: float = _THETA_EPS) -> torch.Tensor:
    """Entrywise argmax of ``N log t - C1 t - C2 t^2 / 2`` on [eps, 1-eps]:
    ``N / C1`` at order 1, the positive root of ``C2 t^2 + C1 t - N = 0``
    at order 2.  On the inputs' device."""
    N, C1 = torch.as_tensor(N), torch.as_tensor(C1)
    t1 = N / torch.clamp_min(C1, _LOG_EPS)
    if C2 is None:
        return torch.clamp(t1, eps, 1.0 - eps)
    C2 = torch.as_tensor(C2)
    disc = f32math.sqrt(C1 * C1 + 4.0 * C2 * N)
    t2 = (disc - C1) / torch.clamp_min(2.0 * C2, _LOG_EPS)
    t = torch.where(C2 > 1e-8, t2, t1)
    return torch.clamp(t, eps, 1.0 - eps)


def newton_thetas(N, coeffs, t0, *, steps: int = 12, eps: float = _THETA_EPS) -> torch.Tensor:
    """Entrywise argmax of ``N log t - sum_p C_p t^p / p`` at any order: a
    few clipped Newton steps from ``t0`` on the strictly concave per-cell
    objective (every C_p >= 0).  On the inputs' device."""
    N = torch.as_tensor(N)
    t = torch.clamp(torch.as_tensor(t0), eps, 1.0 - eps)
    for _ in range(steps):
        g = N / t
        h = -N / (t * t)
        for p, C in enumerate(coeffs, start=1):
            g = g - C * t ** (p - 1)
            if p >= 2:
                h = h - (p - 1) * C * t ** (p - 2)
        t = torch.clamp(t - g / torch.clamp_max(h, -_LOG_EPS), eps, 1.0 - eps)
    return t


# ---------------------------------------------------------------------------
# E-step / M-step
# ---------------------------------------------------------------------------


def _logit(p: torch.Tensor) -> torch.Tensor:
    p = torch.clamp(p, _THETA_EPS, 1.0 - _THETA_EPS)
    log1p = f32math.log1p if p.dtype == torch.float32 else torch.log1p
    return _flog(p) - log1p(-p)


def _estep(pl, thetas, mu, data: FitData, steps: int, lr: float, order: int):
    def loss(x):
        return -_elbo(torch.sigmoid(x), thetas, mu, data, order)

    m = torch.zeros_like(pl)
    v = torch.zeros_like(pl)
    best_val = torch.full((), float("inf"), dtype=pl.dtype, device=pl.device)
    best_pl = pl
    for i in range(steps):
        with torch.enable_grad():
            x = pl.detach().requires_grad_(True)
            val = loss(x)
            (g,) = torch.autograd.grad(val, x)
        val = val.detach()
        better = val < best_val
        best_val = torch.where(better, val, best_val)
        best_pl = torch.where(better, pl, best_pl)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat = m / (1.0 - 0.9 ** (i + 1))
        vhat = v / (1.0 - 0.999 ** (i + 1))
        pl = pl - lr * mhat / (torch.sqrt(vhat) + 1e-8)
    final_val = loss(pl)
    better = final_val < best_val
    return torch.where(better, pl, best_pl), -torch.where(better, final_val, best_val)


def estep(
    phi_logits, thetas, mu, data: FitData, *, steps: int = 40, lr: float = 0.4, order: int = 3, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Variational E-step on ``device`` (default ``"cuda"``; raises without
    a card): ``steps`` Adam iterations on the phi logits with best-iterate
    tracking on the device (the returned logits are the best visited
    point, never worse than the input).  Returns ``(phi_logits, elbo)``."""
    dev = resolve_device(device)
    with torch.no_grad():
        return _estep(_f32(phi_logits, dev), _f32(thetas, dev), _f32(mu, dev), _on(data, dev),
                      int(steps), float(lr), int(order))


def _mstep(pl, thetas, mu, data: FitData, steps: int, lr: float, order: int):
    phi = torch.sigmoid(pl)
    mu_new = torch.clamp(torch.mean(phi, dim=0), _THETA_EPS, 1.0 - _THETA_EPS)

    # Gauss-Seidel over attributes: each slice's per-cell Newton solve is
    # exact given the other slices, so sequential updates with the
    # coefficients recomputed after every slice are coordinate ascent (a
    # simultaneous update of all slices overshoots).  N is theta-free.
    a = _soft_attr(phi)
    b = _soft_configs(a)
    N = _edge_cell_counts(phi, data)
    th = thetas
    for k in range(thetas.shape[0]):
        upd = newton_thetas(N, _penalty_coeffs(a, b, th, data, order), th)
        th = torch.cat([th[:k], upd[k : k + 1], th[k + 1 :]])

    def loss(x):
        return -_elbo(phi, torch.sigmoid(x), mu_new, data, order)

    params = {"theta_logits": _logit(th)}
    ocfg = _opt.OptConfig(lr=lr, warmup_steps=0, total_steps=max(steps, 1), weight_decay=0.0, clip_norm=10.0)
    state = _opt.init(params)
    best_val = -_elbo(phi, thetas, mu_new, data, order)  # the incoming thetas: never regress
    best_th = thetas
    for _ in range(max(steps, 1)):
        with torch.enable_grad():
            x = params["theta_logits"].detach().requires_grad_(True)
            val = loss(x)
            (g,) = torch.autograd.grad(val, x)
        val = val.detach()
        better = val < best_val
        best_val = torch.where(better, val, best_val)
        best_th = torch.where(better, torch.sigmoid(params["theta_logits"]), best_th)
        params, state, _ = _opt.update(ocfg, {"theta_logits": g}, state, params)
    final_th = torch.sigmoid(params["theta_logits"])
    final_val = -_elbo(phi, final_th, mu_new, data, order)
    better = final_val < best_val
    return torch.where(better, final_th, best_th), mu_new, -torch.where(better, final_val, best_val)


def mstep(
    phi_logits, thetas, mu, data: FitData, *, steps: int = 10, lr: float = 0.08, order: int = 3, device=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """M-step on ``device`` (default ``"cuda"``; raises without a card):
    ``mu = mean(phi)``, the exact prior argmax; thetas by one Gauss-Seidel
    sweep of per-attribute Newton solves (:func:`newton_thetas` on
    :func:`suff_stats` at the ELBO's order), refined on the joint objective
    by ``steps`` AdamW iterations of ``train/optimizer.py``; the best
    iterate, the incoming thetas included, wins.  Returns ``(thetas, mu,
    elbo)``."""
    dev = resolve_device(device)
    with torch.no_grad():
        return _mstep(_f32(phi_logits, dev), _f32(thetas, dev), _f32(mu, dev), _on(data, dev),
                      int(steps), float(lr), int(order))


def _elbo_logits(phi_logits, thetas, mu, data: FitData, order: int) -> torch.Tensor:
    """The driver's one acceptance evaluation (a 0-d tensor; the driver
    reads it back)."""
    with torch.no_grad():
        return _elbo(torch.sigmoid(phi_logits), thetas, mu, data, order)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def _em(phi_logits, thetas, mu, data: FitData, options: FitOptions, fit_phi: bool):
    """:func:`magfit`'s EM loop and hardening refit on prepared state in any
    float dtype: ``(phi_logits, thetas, mu, trace, iterations,
    converged)``; ``phi_logits`` are the soft posteriors' (the refit's hard
    ones are not returned)."""
    order = int(options.order)
    e_args = (int(options.estep_steps), float(options.estep_lr), order)
    m_args = (int(options.mstep_steps), float(options.mstep_lr), order)
    with torch.no_grad():
        val = float(_elbo_logits(phi_logits, thetas, mu, data, order))
        trace = []
        converged = False
        iterations = 0
        for it in range(int(options.em_iters)):
            iterations = it + 1
            moved = False
            if fit_phi:
                pl_cand, _ = _estep(phi_logits, thetas, mu, data, *e_args)
                v = float(_elbo_logits(pl_cand, thetas, mu, data, order))
                if v >= val:
                    phi_logits, val, moved = pl_cand, v, True
            th_cand, mu_cand, _ = _mstep(phi_logits, thetas, mu, data, *m_args)
            v = float(_elbo_logits(phi_logits, th_cand, mu_cand, data, order))
            if v >= val:
                thetas, mu, val, moved = th_cand, mu_cand, v, True
            prev = trace[-1] if trace else -np.inf
            trace.append(val)
            if not moved or (np.isfinite(prev) and val - prev <= float(options.tol) * (1.0 + abs(prev))):
                converged = True
                break

        if fit_phi and options.harden:
            # the conditional refit on the hardened posteriors: a few sweeps,
            # since one Gauss-Seidel pass leaves a cross-attribute residual
            pl_hard = _logit((torch.sigmoid(phi_logits) > 0.5).to(phi_logits.dtype))
            for _ in range(3):
                thetas, mu, _ = _mstep(pl_hard, thetas, mu, data, *m_args)
    return phi_logits, thetas, mu, trace, iterations, converged


def init_state(
    key: torch.Tensor,
    n: int,
    d: int,
    num_edges: int,
    *,
    init_params: Optional[magm.MAGMParams] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Initial ``(phi_logits, thetas, mu)`` on ``device`` (default
    ``"cuda"``), bit-equal to the reference's.

    phi logits are small-noise (symmetry breaking around the uninformative
    posterior); thetas start at the density-matched flat value ``(E /
    n^2)^(1/d)`` with multiplicative jitter: symmetric starts are saddle
    points of the flip and permutation symmetries.
    """
    dev = resolve_device(device)
    keys = prng.split(key)
    phi_logits = 0.1 * prng.normal(keys[0], (n, d), device=dev)
    if init_params is not None:
        thetas = torch.clamp(_f32(init_params.thetas, dev), _THETA_EPS, 1.0 - _THETA_EPS)
        mu = torch.clamp(_f32(init_params.mu, dev), _THETA_EPS, 1.0 - _THETA_EPS)
        return phi_logits, thetas, mu
    rho = max(num_edges, 1) / float(n) ** 2
    base = float(np.clip(rho ** (1.0 / d), 0.05, 0.9))
    jitter = f32math.exp(0.25 * prng.normal(keys[1], (d, 2, 2), device=dev))
    thetas = torch.clamp(base * jitter, _THETA_EPS, 1.0 - _THETA_EPS)
    mu = torch.full((d,), 0.5, dtype=torch.float32, device=dev)
    return phi_logits, thetas, mu


def magfit(
    edges: np.ndarray,
    n: int,
    d: int,
    *,
    key: Optional[torch.Tensor] = None,
    options: FitOptions = FitOptions(),
    init_params: Optional[magm.MAGMParams] = None,
    phi_init: Optional[np.ndarray] = None,
    fit_phi: bool = True,
    shard_size: Optional[int] = None,
    mesh=None,
    device=None,
) -> FitResult:
    """Fit MAG parameters to an observed edge list by variational EM on
    ``device`` (default ``"cuda"``; raises without a card).

    Every E/M candidate is re-scored by one ELBO and accepted only when it
    does not decrease it, so ``elbo_trace`` is non-decreasing; EM stops
    when the per-iteration gain falls below ``options.tol`` (relative) or
    after ``em_iters``.  ``phi_init`` seeds the posterior means (the true
    attributes in recovery tests, or a warm start); ``fit_phi=False``
    freezes them, reducing EM to the M-step.  ``mesh=`` pads the edge
    shards to a multiple of its graphs axis (:func:`shard_edges`), as the
    reference does.
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if edges.shape[0] == 0:
        raise ValueError("cannot fit MAG parameters to an empty edge list")
    if n * (1 << d) > FIT_STATE_CAP:
        raise ValueError(
            f"n * 2^d = {n * (1 << d)} exceeds FIT_STATE_CAP ({FIT_STATE_CAP}); reduce d or fit on a subsample"
        )
    key = prng.PRNGKey(0) if key is None else key
    data = shard_edges(edges, n, shard_size=shard_size, mesh=mesh, device=device)
    dev = data.src.device
    phi_logits, thetas, mu = init_state(key, n, d, edges.shape[0], init_params=init_params, device=dev)
    if phi_init is not None:
        phi_init = np.asarray(phi_init, dtype=np.float32)
        if phi_init.shape != (n, d):
            raise ValueError(f"phi_init must have shape {(n, d)}, got {phi_init.shape}")
        phi_logits = _logit(torch.from_numpy(phi_init).to(dev))
    phi_logits, thetas, mu, trace, iterations, converged = _em(phi_logits, thetas, mu, data, options, fit_phi)
    return FitResult(
        params=magm.MAGMParams(thetas.cpu(), mu.cpu()),
        phi=torch.sigmoid(phi_logits).cpu().numpy(),
        elbo_trace=np.asarray(trace, dtype=np.float64),
        iterations=iterations,
        converged=converged,
    )
