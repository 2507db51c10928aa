"""State carried over from the JAX package.

:func:`from_reference` serves MAGM sessions and MAGFIT,
:func:`kpgm_from_reference` KPGM sessions, :func:`lm_params_from_reference`
the LM's weights and :func:`opt_state_from_reference` its AdamW state.

A sampler has no weights; what the two packages must share to give the
same graph is the initiator thetas, the attribute matrix and the key.
:func:`from_reference` takes them as the numpy arrays the JAX package
holds and returns the port's counterparts.  MAGFIT's state goes the same
way: its soft attributes ``phi`` ((n, d) float32 Bernoulli means) take the
place of the hard attributes and come back unchanged, and a whole fit
crosses with :func:`fit_from_reference` and :func:`fit_to_reference`, so
that either package can bootstrap, canonicalize or resample the other's.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import kpgm, magm
from repro_torch.fit.magfit import FitResult
from repro_torch.train.optimizer import OptState


def from_reference(
    thetas: np.ndarray, F: np.ndarray, key_data: np.ndarray, mu: Optional[np.ndarray] = None
) -> Tuple[magm.MAGMParams, np.ndarray, torch.Tensor]:
    """``(params, F, key)`` of the port from the reference's ``(d, 2, 2)``
    float32 thetas, ``(n, d)`` attributes and raw uint32 key words
    (``jax.random.key_data``).  F is returned as given, dtype and values:
    hard int8 bits for a sampler, or MAGFIT's float32 soft attributes phi.
    ``mu`` defaults to F's column means; it is used only when a session
    draws attributes itself."""
    th = np.asarray(thetas, dtype=np.float32)
    if th.ndim != 3 or th.shape[1:] != (2, 2):
        raise ValueError(f"thetas must be (d, 2, 2), got {th.shape}")
    F = np.asarray(F)
    if F.ndim != 2 or F.shape[1] != th.shape[0]:
        raise ValueError(f"F must be (n, {th.shape[0]}), got {F.shape}")
    if mu is None:
        mu = F.mean(axis=0) if F.shape[0] else np.full(th.shape[0], 0.5)
    mu_t = torch.from_numpy(np.broadcast_to(np.asarray(mu, np.float32), (th.shape[0],)).copy())
    return magm.MAGMParams(torch.from_numpy(th.copy()), mu_t), F, _key(key_data)


def _key(key_data) -> torch.Tensor:
    words = np.asarray(key_data).astype(np.uint32).reshape(-1)
    if words.size != 2:
        raise ValueError(f"key_data must hold two uint32 words, got {words.size}")
    return torch.from_numpy(words.astype(np.int64))


def kpgm_from_reference(thetas: np.ndarray, key_data: np.ndarray) -> Tuple[kpgm.KPGMParams, torch.Tensor]:
    """``(params, key)`` of the port from a reference ``KPGMParams``'s
    ``(d, 2, 2)`` float32 thetas and raw uint32 key words."""
    th = np.asarray(thetas, dtype=np.float32)
    if th.ndim != 3 or th.shape[1:] != (2, 2):
        raise ValueError(f"thetas must be (d, 2, 2), got {th.shape}")
    return kpgm.KPGMParams(torch.from_numpy(th.copy())), _key(key_data)


def fit_from_reference(fit) -> FitResult:
    """The port's :class:`FitResult` from a reference ``FitResult`` (read
    through ``numpy.asarray``: float32 thetas and mu as CPU tensors, phi
    float32, the trace float64)."""
    thetas = np.asarray(fit.params.thetas, dtype=np.float32)
    mu = np.asarray(fit.params.mu, dtype=np.float32)
    return FitResult(
        params=magm.MAGMParams(torch.from_numpy(thetas.copy()), torch.from_numpy(mu.copy())),
        phi=np.asarray(fit.phi, dtype=np.float32).copy(),
        elbo_trace=np.asarray(fit.elbo_trace, dtype=np.float64).copy(),
        iterations=int(fit.iterations),
        converged=bool(fit.converged),
    )


def fit_to_reference(fit: FitResult) -> dict:
    """A port :class:`FitResult` as numpy values under the reference
    ``FitResult``'s field names, ``params`` as the ``(thetas, mu)`` pair of
    float32 arrays its ``MAGMParams`` takes."""
    return dict(
        params=(fit.params.thetas.detach().cpu().numpy().astype(np.float32),
                fit.params.mu.detach().cpu().numpy().astype(np.float32)),
        phi=np.asarray(fit.phi, dtype=np.float32).copy(),
        elbo_trace=np.asarray(fit.elbo_trace, dtype=np.float64).copy(),
        iterations=int(fit.iterations),
        converged=bool(fit.converged),
    )


def _leaf_tensor(arr) -> torch.Tensor:
    """A numpy array as a CPU tensor with the same bits.  A bfloat16 array
    (numpy's view of a JAX bf16 array: dtype ``bfloat16`` from ml_dtypes,
    which the port does not import) goes through its int16 view."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def lm_params_from_reference(params: Any, device=None) -> Any:
    """The port's LM param tree from the reference's: the same nested dicts,
    each leaf (a numpy array, or anything ``numpy.asarray`` reads) as a
    tensor with the same dtype and bits on ``device`` (default: the CPU)."""
    if isinstance(params, dict):
        return {k: lm_params_from_reference(v, device) for k, v in params.items()}
    t = _leaf_tensor(params)
    return t if device is None else t.to(device)


def opt_state_from_reference(state: Any, device=None) -> OptState:
    """The port's :class:`OptState` from a reference ``OptState`` (its
    fields as numpy arrays, or anything ``numpy.asarray`` reads): the int32
    step and the float32 moment and master trees, same bits, on ``device``
    (default: the CPU)."""
    step, mu, nu, master = state
    return OptState(
        step=lm_params_from_reference(np.asarray(step, dtype=np.int32), device),
        mu=lm_params_from_reference(mu, device),
        nu=lm_params_from_reference(nu, device),
        master=lm_params_from_reference(master, device),
    )
