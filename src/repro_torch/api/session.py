"""MAGMSampler and KPGMSampler: build the device state once, sample many
times.

A session resolves a frozen :class:`SamplerConfig` into an owned
:class:`repro_torch.core.quilt.QuiltPlan` (or, with ``split=True``, a
:class:`repro_torch.core.quilt.SplitPlan`) on its device and a key stream.
A MAGM sample runs the quilting engine (``quilt.quilt_run``), the section-5
split (``quilt.split_run``), or with ``backend="balldrop"`` the
ball-dropping engine over the same plan; a KPGM sample runs the engine
over the B = 1 identity plan, or Algorithm 1's host loop where no plan is
built (``backend="host"``, d > 20).

``sample_stream`` emits one graph as fixed-size edge chunks, copied from
the device round chunk by chunk; with ``checkpoint_dir=`` it persists a
StreamCheckpoint after every delivered chunk (:mod:`repro_torch.api.stream`),
and :meth:`resume_stream` continues a killed stream from its cursor,
bit-identically, on any device and in either package.  ``sample_batch``
draws several graphs through shared fused rounds (sample s's block pair g'
is graph s * B^2 + g'), or one by one with ``fold_in(key, s)`` keys where
a batch cannot be fused (the split, the host paths, a batch past the
candidate cap).

``SamplerConfig.mesh`` is resolved once, at session build, by
``launch.mesh.resolve_sampler_mesh`` (``"auto"``: a ``graphs`` mesh over
every rank of the running world, or of a 1-rank world the session starts);
every engine call of the session runs on it, and its results equal the
unsharded session's bit for bit on every rank.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api import stream as _stream
from repro_torch.api.config import SamplerConfig
from repro_torch.api.result import GraphSample, KPGMStats
from repro_torch.core import dedup, kpgm, magm, prng, quilt
from repro_torch.core.device import resolve_device
from repro_torch.dist import chaos
from repro_torch.dist import checkpoint as _ckpt

# identity plans hold the 2^d config space; past this the host loop is the
# KPGM backend
KPGM_PLAN_MAX_NODES = 1 << 20


class _Session:
    """Shared session plumbing: config checks, device, mesh, key stream.
    ``world`` records the process group a mesh session runs over
    (``launch.mesh.SamplerWorld``: its backend, size, this rank, and
    whether the session started it); None without a mesh."""

    def __init__(self, config: SamplerConfig, key: Optional[torch.Tensor]):
        from repro_torch.launch import mesh as mesh_lib

        self.config = config
        self.device = resolve_device(config.device)
        self.mesh = mesh_lib.resolve_sampler_mesh(config.mesh, device=self.device)
        self.world = None if self.mesh is None else mesh_lib.sampler_world(self.device)
        self._key = key if key is not None else prng.PRNGKey(0)

    def _next_key(self) -> torch.Tensor:
        """Advance the session's key stream (used when sample(key=None))."""
        self._key, sub = prng.split(self._key)
        return sub

    def _check_dtype(self, n: int) -> None:
        if n > 0 and np.iinfo(np.dtype(self.config.dtype)).max < n - 1:
            raise ValueError(f"dtype {np.dtype(self.config.dtype)} cannot hold node ids up to {n - 1}")

    def _cast(self, edges: np.ndarray) -> np.ndarray:
        return edges.astype(self.config.dtype, copy=False)

    def _run(self, key: torch.Tensor, *, num_samples: int = 1, targets=None, exact_cells=None) -> quilt.QuiltRun:
        c = self.config
        return quilt.quilt_run(
            key, self.plan, num_samples=num_samples, targets=targets, max_rounds=c.max_rounds,
            oversample=c.oversample, backend=c.backend, use_kernel=c.use_kernel, mesh=self.mesh,
            exact_cells=exact_cells,
        )

    def _chunks(self, chunks) -> Iterator[np.ndarray]:
        """The cast chunks, each behind the ``stream.chunk`` chaos site.  The
        source, which holds the run's device buffers, is closed when the
        stream ends, is killed or is dropped, so a killed stream frees them
        (no frame of the stream keeps the run itself)."""
        try:
            for chunk in chunks:
                chaos.maybe_fail("stream.chunk")
                yield self._cast(chunk)
        finally:
            chunks.close()

    def _run_chunks(self, run: quilt.QuiltRun, chunk_edges: int):
        self._last_run_slots = run.slots_per_graph
        return run.iter_chunks(chunk_edges)

    # -- resumable streaming -------------------------------------------

    def _stream_config_digest(self, chunk_edges: int, num_edges: Optional[int]) -> np.ndarray:
        """Digest of everything the chunk sequence depends on, with the
        reference's parts in the reference's order (a session's own
        ``_digest_parts`` after the class name), so that it is bit-equal to
        the reference's for the same config.  The device is left out, as
        the reference leaves its mesh out: a stream checkpointed on the card
        resumes on the CPU, and the other way round.  ``use_kernel`` is the
        config's value, not the resolved one."""
        c = self.config
        return _stream.digest_parts([
            type(self).__name__, *self._digest_parts(), c.backend, c.oversample, c.max_rounds,
            c.use_kernel, str(np.dtype(c.dtype)), int(chunk_edges),
            None if num_edges is None else int(num_edges),
        ])

    def _emit(self, key, chunk_edges: int, checkpoint_dir: str, state, num_edges: Optional[int]):
        return _stream.emit(
            self._stream_raw(key, chunk_edges, num_edges=num_edges), checkpoint_dir, state,
            slots=lambda: getattr(self, "_last_run_slots", 0),
        )

    def _checkpointed_stream(
        self, key, chunk_edges: int, checkpoint_dir: str, num_edges: Optional[int] = None
    ) -> Iterator[np.ndarray]:
        state = _stream.initial_state(
            self._stream_config_digest(chunk_edges, num_edges), key, chunk_edges, num_edges
        )
        return self._emit(key, chunk_edges, checkpoint_dir, state, num_edges)

    def resume_stream(self, checkpoint_dir: str) -> Iterator[np.ndarray]:
        """Continue a checkpointed ``sample_stream`` after an interruption.

        Loads the newest StreamCheckpoint under ``checkpoint_dir`` (written
        by this package or the reference), re-runs the engine from the
        persisted key on this session's device, checks the replay of the
        chunks already delivered against the persisted digest, and yields
        the rest: [chunks delivered before the fault ‖ resumed chunks] is
        bit-identical to an uninterrupted stream.  Raises ValueError when
        the directory holds no checkpoint or one written by a different
        sampler config, RuntimeError when the replay diverges; a finished
        stream yields nothing.
        """
        step = _ckpt.latest_step(checkpoint_dir)
        if step is None:
            raise ValueError(f"no stream checkpoint under {checkpoint_dir!r}")
        state = _stream.load_state(checkpoint_dir, step, self._key)
        chunk_edges = int(state["chunk_edges"])
        num_edges = None if int(state["num_edges"]) < 0 else int(state["num_edges"])
        if not np.array_equal(self._stream_config_digest(chunk_edges, num_edges), state["config_digest"]):
            raise ValueError(
                f"stream checkpoint in {checkpoint_dir!r} was written by a different sampler config "
                "(config digest mismatch); build the session from the original config to resume"
            )
        if int(state["done"]):
            return iter(())
        key = _stream.key_from_data(state["key_data"], int(state["key_typed"]))
        return self._emit(key, chunk_edges, checkpoint_dir, state, num_edges)


class MAGMSampler(_Session):
    """Session over one MAGM configuration.

    Examples
    --------
    >>> import numpy as np
    >>> from repro_torch.api import MAGMSampler, SamplerConfig
    >>> from repro_torch.core import magm, prng
    >>> theta = np.array([[0.3, 0.6], [0.6, 0.9]], dtype=np.float32)
    >>> cfg = SamplerConfig(params=magm.make_params(theta, 0.5, 5),
    ...                     num_nodes=24, device="cpu")
    >>> sampler = MAGMSampler(cfg)
    >>> gs = sampler.sample(prng.PRNGKey(1))
    >>> gs.num_edges == gs.stats.kept_edges
    True
    >>> chunks = list(sampler.sample_stream(prng.PRNGKey(1), chunk_edges=16))
    >>> bool(np.array_equal(np.concatenate(chunks), gs.edges))
    True
    """

    def __init__(self, config: SamplerConfig, *, key: Optional[torch.Tensor] = None):
        super().__init__(config, key)
        params = config.params
        if not hasattr(params, "mu"):
            raise TypeError("MAGMSampler needs magm.MAGMParams (with mu); for plain KPGM graphs use KPGMSampler")
        self.F = magm.resolve_attributes(
            params,
            config.F,
            num_nodes=config.num_nodes,
            attribute_key=config.attribute_key,
            device=self.device,
        )
        self.n = int(self.F.shape[0])
        self._check_dtype(self.n)
        self.split_plan: Optional[quilt.SplitPlan] = None
        self.plan: Optional[quilt.QuiltPlan] = None
        if self.F.size == 0:
            return  # an empty source: every call emits nothing
        if config.split:
            self.split_plan = quilt.build_split_plan(self.F, params, config.bprime, device=self.device)
            self.plan = self.split_plan.light_plan
        else:
            self.plan = quilt.build_quilt_plan(self.F, params.thetas, device=self.device)
        if config.backend == "balldrop" and self.plan is not None and self.plan.bd_cost is None:
            # fail at session build, not on the first sample()
            raise ValueError(
                f"backend='balldrop' needs the plan's ball-dropping moments, unavailable at "
                f"d={self.plan.d} (2^d exceeds kron.MOMENT_CAP); use backend='auto' or 'host'"
            )

    def _split_sample(self, key: torch.Tensor):
        """One section-5 draw of the owned SplitPlan: ``(edges, stats)``."""
        c = self.config
        return quilt.split_run(
            key, self.split_plan, max_rounds=c.max_rounds, oversample=c.oversample,
            backend=c.backend, use_kernel=c.use_kernel, mesh=self.mesh,
        )

    @obs.span("session.sample", host_result=True)
    def sample(self, key: Optional[torch.Tensor] = None) -> GraphSample:
        """Draw one MAGM graph; ``key=None`` consumes the session's stream."""
        key = self._next_key() if key is None else key
        if self.F.size == 0:
            return GraphSample(
                np.zeros((0, 2), dtype=self.config.dtype), 0,
                quilt.QuiltStats(0, 0, 0, 0, 0, 0, None), key,
            )
        if self.split_plan is not None:
            edges, stats = self._split_sample(key)
            return GraphSample(self._cast(edges), self.n, stats, key)
        run = self._run(key, exact_cells=self.config.exact_cells)
        edges = run.edges()
        return GraphSample(self._cast(edges), self.n, run.stats(edges.shape[0]), key)

    def _digest_parts(self) -> list:
        return [self.F, self.config.split, self.config.bprime]

    def _stream_raw(self, key, chunk_edges: int, num_edges: Optional[int] = None) -> Iterator[np.ndarray]:
        """The undecorated chunk sequence (``num_edges`` unused: the MAGM
        edge count is the model's own draw)."""
        if self.F.size == 0:
            return
        if self.split_plan is not None:
            edges, _ = self._split_sample(key)
            chunks = dedup.rechunk_edges([edges], chunk_edges)
        else:
            chunks = self._run_chunks(self._run(key, exact_cells=self.config.exact_cells), chunk_edges)
        yield from self._chunks(chunks)

    def sample_stream(
        self, key: Optional[torch.Tensor] = None, *, chunk_edges: int = 1 << 16, checkpoint_dir: Optional[str] = None
    ) -> Iterator[np.ndarray]:
        """One graph as ``(chunk_edges, 2)`` chunks (the last may be
        shorter) whose concatenation equals ``sample(key).edges``.  On the
        quilting paths each chunk's rows are copied from the device round
        on their own; the split re-chunks its host edge array.

        ``checkpoint_dir=`` persists a StreamCheckpoint (atomically, through
        :mod:`repro_torch.dist.checkpoint`) after every delivered chunk; a
        stream killed midway continues from its cursor through
        :meth:`resume_stream`."""
        key = self._next_key() if key is None else key
        if checkpoint_dir is None:
            yield from self._stream_raw(key, chunk_edges)
        else:
            yield from self._checkpointed_stream(key, chunk_edges, checkpoint_dir)

    @obs.span("session.sample_batch", host_result=True)
    def sample_batch(self, num_graphs: int, key: Optional[torch.Tensor] = None) -> List[GraphSample]:
        """``num_graphs`` independent MAGM graphs.  Without the split they
        share fused rounds; members of a fused batch carry ``key=None``, as
        no single key reproduces them.  The split, the host backend and a
        batch past the candidate cap draw ``sample(fold_in(key, s))``."""
        num_graphs = int(num_graphs)
        key = self._next_key() if key is None else key
        if num_graphs <= 0:
            return []
        if self.split_plan is None and self.F.size:
            try:
                run = self._run(key, num_samples=num_graphs, exact_cells=self.config.exact_cells)
            except quilt.DeviceBatchUnavailable:
                pass
            else:
                per = run.edges_per_sample()
                stats = run.stats_per_sample([e.shape[0] for e in per])
                return [GraphSample(self._cast(e), self.n, st, None) for e, st in zip(per, stats)]
        return [self.sample(prng.fold_in(key, s)) for s in range(num_graphs)]


class KPGMSampler(_Session):
    """Session for plain KPGM graphs (Algorithm 1).

    Runs the draw as the trivial B = 1 quilt over an identity config ->
    node plan (:func:`repro_torch.core.quilt.build_kpgm_plan`), through the
    ranked rounds, so every sample keeps its drawn edge-count target; for
    d > 20 or ``backend="host"`` the host loop of Algorithm 1 runs instead.

    Examples
    --------
    >>> import numpy as np
    >>> from repro_torch.api import KPGMSampler, SamplerConfig
    >>> from repro_torch.core import kpgm, prng
    >>> theta = np.array([[0.3, 0.6], [0.6, 0.9]], dtype=np.float32)
    >>> s = KPGMSampler(SamplerConfig(params=kpgm.make_params(theta, 6), device="cpu"))
    >>> gs = s.sample(prng.PRNGKey(0), num_edges=50)
    >>> gs.num_edges, gs.n, gs.stats.target_edges
    (50, 64, 50)
    """

    def __init__(self, config: SamplerConfig, *, key: Optional[torch.Tensor] = None):
        super().__init__(config, key)
        params = config.params
        if hasattr(params, "mu"):
            raise TypeError("KPGMSampler needs kpgm.KPGMParams; for attribute graphs use MAGMSampler")
        self.params = params
        self.n = int(params.num_nodes)
        self._check_dtype(self.n)
        self.plan: Optional[quilt.QuiltPlan] = None
        if config.backend != "host" and self.n <= KPGM_PLAN_MAX_NODES:
            self.plan = quilt.build_kpgm_plan(params.thetas, device=self.device)
        elif config.backend in ("device", "balldrop"):
            # an explicit engine request must not quietly become the host loop
            raise ValueError(
                f"backend={config.backend!r} needs n <= {KPGM_PLAN_MAX_NODES} (got n={self.n}); "
                "use backend='auto' or 'host'"
            )

    def _exact(self) -> bool:
        # KPGM samples keep their drawn target: the ranked rounds, unless
        # the config asks for exact cells
        return False if self.config.exact_cells is None else self.config.exact_cells

    def _host_sample(self, key, num_edges) -> GraphSample:
        edges = kpgm._kpgm_sample_host(
            key, self.params, max_rounds=self.config.max_rounds,
            oversample=self.config.oversample, num_edges=num_edges, device=self.device,
        )
        return GraphSample(self._cast(edges), self.n, None, key)

    def _engine_run(self, key: torch.Tensor, num_edges: Optional[int]) -> Optional[quilt.QuiltRun]:
        """A run of the engine, or None where the host loop must run: no
        plan, or an explicit ``num_edges`` past the device budget (the host
        loop honors the target, the engine's host path draws its own)."""
        if self.plan is None:
            return None
        targets = None if num_edges is None else np.array([num_edges])
        try:
            return self._run(key, targets=targets, exact_cells=self._exact())
        except quilt.DeviceBatchUnavailable:
            return None

    @obs.span("session.sample", host_result=True)
    def sample(self, key: Optional[torch.Tensor] = None, *, num_edges: Optional[int] = None) -> GraphSample:
        """Draw one KPGM graph (``num_edges`` overrides the X ~ N(m, m - v)
        draw); ``key=None`` consumes the session's stream."""
        key = self._next_key() if key is None else key
        run = self._engine_run(key, num_edges)
        if run is None:
            return self._host_sample(key, num_edges)
        edges = run.edges()
        # no stats when the quilting engine took its host path: its target
        # draw was never used there (the ball-dropping host loop honors it)
        stats = None if run.host_edges is not None and run.sampler != "balldrop" else KPGMStats(
            num_nodes=self.n, target_edges=int(run.targets[0]), sampled_edges=int(edges.shape[0])
        )
        return GraphSample(self._cast(edges), self.n, stats, key)

    def _digest_parts(self) -> list:
        return [self.params.thetas.cpu().numpy(), self.n]

    def _engine_chunks(self, key, chunk_edges: int, num_edges: Optional[int]):
        run = self._engine_run(key, num_edges)
        if run is None:
            return dedup.rechunk_edges([self._host_sample(key, num_edges).edges], chunk_edges)
        return self._run_chunks(run, chunk_edges)

    def _stream_raw(self, key, chunk_edges: int, num_edges: Optional[int] = None) -> Iterator[np.ndarray]:
        yield from self._chunks(self._engine_chunks(key, chunk_edges, num_edges))

    def sample_stream(
        self,
        key: Optional[torch.Tensor] = None,
        *,
        chunk_edges: int = 1 << 16,
        num_edges: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
    ) -> Iterator[np.ndarray]:
        """One KPGM graph as fixed-size chunks whose concatenation equals
        ``sample(key, num_edges=num_edges).edges`` (see
        :meth:`MAGMSampler.sample_stream`; the ``checkpoint_dir=`` /
        :meth:`resume_stream` contract, ``num_edges`` included, is shared)."""
        key = self._next_key() if key is None else key
        if checkpoint_dir is None:
            yield from self._stream_raw(key, chunk_edges, num_edges)
        else:
            yield from self._checkpointed_stream(key, chunk_edges, checkpoint_dir, num_edges=num_edges)

    @obs.span("session.sample_batch", host_result=True)
    def sample_batch(self, num_graphs: int, key: Optional[torch.Tensor] = None) -> List[GraphSample]:
        """``num_graphs`` independent KPGM graphs through shared fused
        rounds (members carry ``key=None``), or the host loop once per
        sample with ``fold_in(key, s)`` keys."""
        num_graphs = int(num_graphs)
        key = self._next_key() if key is None else key
        if num_graphs <= 0:
            return []
        if self.plan is not None:
            try:
                run = self._run(key, num_samples=num_graphs, exact_cells=self._exact())
            except quilt.DeviceBatchUnavailable:
                pass
            else:
                return [
                    GraphSample(self._cast(e), self.n, KPGMStats(self.n, int(run.targets[s]), e.shape[0]), None)
                    for s, e in enumerate(run.edges_per_sample())
                ]
        return [self._host_sample(prng.fold_in(key, s), None) for s in range(num_graphs)]
