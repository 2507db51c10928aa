"""Serving: the LM decode loop, or MAGM graph sampling as a service.

LM mode (the default: prefill a prompt batch, then greedy-decode tokens;
any of the ten archs, full ``olmo-1b`` unless ``--arch``/``--smoke`` say
otherwise; the vlm and audio families get the reference's zero context):

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch olmo-1b] \
        [--smoke] [--batch 4] [--prompt-len 32] [--gen 16] [--device cuda]

The weights are the reference's ``init_model`` bits for ``--seed`` and the
prompts its ``randint`` draw for ``--seed + 1``, so the two packages serve
the same tokens.

Graph mode (--magm): build ONE sampler session and serve sample requests
from it through :class:`GraphServer` — a bounded-in-flight-queue service
with per-request deadlines, typed error responses and
retry-after-transient-fault, so the session's warm amortized latency is
what requests actually see and overload degrades into explicit shedding
instead of unbounded queue delay:

    PYTHONPATH=src python -m repro_torch.launch.serve --magm --graph-d 15 \
        --requests 4 --chunk-edges 65536 [--device cuda] \
        [--max-queue 8] [--deadline-s 30]

Both modes run on ``--device`` (default ``cuda``; they raise without a
card, and never fall back to the CPU).  A card request that fails becomes a
typed ``error`` response; it is never re-run on the CPU.  ``--mesh`` builds
the graph session with ``mesh="auto"``: a ``graphs`` mesh over the ranks of
the running process group (each rank a process started by a launcher), or
over a 1-rank group of this process; the LM mode runs on one device and
refuses it.

Response contract (``ServeResponse``), the reference's
(``repro.launch.serve``): every request — well-formed or garbage — gets
exactly one typed response; the server loop never dies on a request's
account.  ``status``/``code`` pairs:

    ok                 0    edges attached
    bad_request      400    malformed payload (message says what)
    deadline_exceeded 408   deadline passed before service finished
    overloaded       429    in-flight queue full — request shed at submit
    error            500    fault survived the retry policy
"""

from __future__ import annotations

import argparse
import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.device import resolve_device
from repro_torch.dist import chaos


def _validate_chunk(chunk, n: int) -> None:
    """Reject malformed streamed chunks loudly: a chunk must be non-empty
    (the stream contract emits no zero-row chunks), integer, (E, 2), and in
    ``[0, n)``."""
    if chunk.ndim != 2 or chunk.shape[1] != 2:
        raise AssertionError(f"chunk shape {chunk.shape}, want (E, 2)")
    if chunk.shape[0] == 0:
        raise AssertionError("stream emitted an empty chunk")
    if chunk.dtype.kind not in "iu":
        raise AssertionError(f"chunk dtype {chunk.dtype}, want integer")
    lo, hi = int(chunk.min()), int(chunk.max())
    if lo < 0 or hi >= n:
        raise AssertionError(f"edge ids [{lo}, {hi}] outside [0, {n})")


class ServeResponse(NamedTuple):
    """One typed answer per request; ``edges`` only on ``status == "ok"``."""

    status: str  # ok | bad_request | deadline_exceeded | overloaded | error
    code: int  # 0 | 400 | 408 | 429 | 500
    message: str = ""
    edges: Optional[np.ndarray] = None
    chunks: int = 0
    wait_s: float = 0.0  # submit -> service start (queue delay)
    service_s: float = 0.0  # sampling wall time, the response's edges built

    @property
    def ok(self) -> bool:
        return self.status == "ok"


class _Request(NamedTuple):
    future: Future
    key: Optional[Any]
    chunk_edges: int
    num_edges: Optional[int]
    t_submit: float
    t_deadline: Optional[float]


class GraphServer:
    """Bounded-queue sampling service over one sampler session.

    One worker thread drains a ``Queue(maxsize=max_queue)`` of requests
    against the session, under ``torch.cuda.device(sampler.device)`` for a
    session on the card (the current device is per host thread; the kernel
    wrappers launch on the worker's current stream).  The three resilience
    behaviours:

    - **Load-shedding**: a submit against a full queue gets an immediate
      typed ``overloaded`` response instead of a slot — so the p99 of the
      requests the server DOES accept is bounded by
      ``(max_queue + 1) x max service time``, never by arrival rate.
    - **Deadlines**: each request carries a deadline (per-request
      ``deadline_s`` or the server default); one that expires while
      queued is answered ``deadline_exceeded`` without sampling, and the
      retry loop inherits the remaining budget.
    - **Retry-after-fault**: each service attempt passes the
      ``serve.request`` chaos site and runs under ``retry_policy``
      (transient :class:`repro_torch.dist.chaos.InjectedFault`\\ s are
      retried with backoff; exhaustion or a fatal fault, such as a
      ``DeviceLoss``, returns a typed ``error`` response).  The worker loop
      survives every response.

    ``stats`` counts submitted/accepted/shed/completed/deadline_expired/
    errors/retries.  Use as a context manager, or call :meth:`close`.
    """

    def __init__(
        self,
        sampler,
        *,
        max_queue: int = 8,
        deadline_s: Optional[float] = None,
        chunk_edges: int = 1 << 14,
        retry_policy: Optional[chaos.RetryPolicy] = None,
    ) -> None:
        self.sampler = sampler
        self.chunk_edges = int(chunk_edges)
        self.deadline_s = deadline_s
        self.retry_policy = (
            retry_policy if retry_policy is not None else chaos.RetryPolicy(max_attempts=3, base_delay=0.01)
        )
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue(maxsize=max(int(max_queue), 1))
        self.stats: Dict[str, int] = {
            "submitted": 0,
            "accepted": 0,
            "shed": 0,
            "completed": 0,
            "deadline_expired": 0,
            "errors": 0,
            "retries": 0,
        }
        self._lock = threading.Lock()
        self._closed = False
        self._worker = threading.Thread(target=self._drain, name="graph-server", daemon=True)
        self._worker.start()

    # -- submission ----------------------------------------------------

    def _bump(self, stat: str, by: int = 1) -> None:
        with self._lock:
            self.stats[stat] += by

    def _resolved(self, resp: ServeResponse) -> Future:
        f: Future = Future()
        f.set_result(resp)
        return f

    def submit(
        self,
        *,
        key=None,
        chunk_edges: Optional[int] = None,
        num_edges: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ) -> Future:
        """Enqueue one sample request; always returns a Future holding a
        :class:`ServeResponse` (shed/invalid requests resolve at once)."""
        self._bump("submitted")
        if self._closed:
            return self._resolved(ServeResponse("error", 500, "server is closed"))
        ce = self.chunk_edges if chunk_edges is None else chunk_edges
        dl = self.deadline_s if deadline_s is None else deadline_s
        try:
            ce = int(ce)
            if ce <= 0:
                raise ValueError(f"chunk_edges must be positive, got {ce}")
            if num_edges is not None:
                num_edges = int(num_edges)
                if num_edges < 0:
                    raise ValueError(f"num_edges must be >= 0, got {num_edges}")
                if not hasattr(self.sampler, "params"):
                    raise ValueError(
                        "num_edges override is only valid for KPGM sessions (the MAGM edge "
                        "count is the model's own draw)"
                    )
            if dl is not None:
                dl = float(dl)
                if dl <= 0:
                    raise ValueError(f"deadline_s must be positive, got {dl}")
        except (TypeError, ValueError) as exc:
            return self._resolved(ServeResponse("bad_request", 400, str(exc)))
        now = time.monotonic()
        req = _Request(Future(), key, ce, num_edges, now, None if dl is None else now + dl)
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self._bump("shed")
            return self._resolved(
                ServeResponse("overloaded", 429, f"in-flight queue full ({self._q.maxsize}); retry later")
            )
        self._bump("accepted")
        return req.future

    def handle(self, payload) -> Future:
        """Dict-payload front door (the HTTP-shaped surface): parse
        ``{"kind": "sample", "seed"/"chunk_edges"/"num_edges"/
        "deadline_s": ...}`` and submit (``seed`` becomes
        ``prng.PRNGKey(seed)``).  Garbage payloads of any shape resolve to
        typed ``bad_request`` responses — never an escaped exception."""
        if not isinstance(payload, dict):
            return self._resolved(
                ServeResponse("bad_request", 400, f"payload must be a dict, got {type(payload).__name__}")
            )
        known = {"kind", "seed", "chunk_edges", "num_edges", "deadline_s"}
        unknown = set(payload) - known
        if unknown:
            return self._resolved(
                ServeResponse("bad_request", 400, f"unknown field(s) {sorted(unknown)}; known: {sorted(known)}")
            )
        kind = payload.get("kind", "sample")
        if kind != "sample":
            return self._resolved(ServeResponse("bad_request", 400, f"unknown kind {kind!r}"))
        key = None
        seed = payload.get("seed")
        if seed is not None:
            try:
                key = prng.PRNGKey(int(seed))
            except (TypeError, ValueError) as exc:
                return self._resolved(ServeResponse("bad_request", 400, f"bad seed: {exc}"))
        return self.submit(
            key=key,
            chunk_edges=payload.get("chunk_edges"),
            num_edges=payload.get("num_edges"),
            deadline_s=payload.get("deadline_s"),
        )

    # -- worker --------------------------------------------------------

    def _drain(self) -> None:
        device = getattr(self.sampler, "device", None)
        on_card = isinstance(device, torch.device) and device.type == "cuda"
        with torch.cuda.device(device) if on_card else contextlib.nullcontext():
            while True:
                req = self._q.get()
                if req is None:
                    return
                try:
                    resp = self._serve_one(req)
                except BaseException as exc:  # noqa: B036 - loop must survive
                    self._bump("errors")
                    resp = ServeResponse("error", 500, repr(exc))
                req.future.set_result(resp)

    def _serve_one(self, req: _Request) -> ServeResponse:
        t_start = time.monotonic()
        wait = t_start - req.t_submit
        if req.t_deadline is not None and t_start > req.t_deadline:
            self._bump("deadline_expired")
            return ServeResponse(
                "deadline_exceeded", 408,
                f"deadline passed {t_start - req.t_deadline:.3f}s before service started",
                wait_s=wait,
            )

        def attempt():
            chaos.maybe_fail("serve.request")
            kwargs = {"chunk_edges": req.chunk_edges}
            if req.num_edges is not None:
                kwargs["num_edges"] = req.num_edges
            parts = []
            for chunk in self.sampler.sample_stream(req.key, **kwargs):
                _validate_chunk(chunk, self.sampler.n)
                parts.append(chunk)
            return parts

        policy = self.retry_policy
        if req.t_deadline is not None:
            budget = req.t_deadline - t_start
            policy = policy._replace(deadline=budget if policy.deadline is None else min(policy.deadline, budget))
        try:
            parts = chaos.with_retries(attempt, policy, on_retry=lambda *_: self._bump("retries"))
        except chaos.DeadlineExceeded as exc:
            self._bump("deadline_expired")
            return ServeResponse(
                "deadline_exceeded", 408, str(exc), wait_s=wait, service_s=time.monotonic() - t_start
            )
        except Exception as exc:
            self._bump("errors")
            return ServeResponse("error", 500, repr(exc), wait_s=wait, service_s=time.monotonic() - t_start)
        # the response's edges are built inside the service time (the
        # reference builds them after it): what keeps the next request
        # waiting is service time, so an accepted request's latency stays
        # within (max_queue + 1) x the longest service
        edges = np.concatenate(parts) if parts else np.zeros((0, 2), dtype=self.sampler.config.dtype)
        service = time.monotonic() - t_start
        if req.t_deadline is not None and time.monotonic() > req.t_deadline:
            self._bump("deadline_expired")
            return ServeResponse(
                "deadline_exceeded", 408,
                f"service finished {time.monotonic() - req.t_deadline:.3f}s past the deadline",
                wait_s=wait, service_s=service,
            )
        self._bump("completed")
        return ServeResponse("ok", 0, edges=edges, chunks=len(parts), wait_s=wait, service_s=service)

    # -- lifecycle -----------------------------------------------------

    def close(self) -> None:
        """Stop accepting, drain in-flight requests, join the worker."""
        with self._lock:
            # two racing close() calls must not both enqueue the drain
            # sentinel (the worker would exit after the first and leave
            # the second blocked on a full queue)
            if self._closed:
                return
            self._closed = True
        self._q.put(None)  # blocks until a slot frees; sentinel drains last
        self._worker.join()

    def __enter__(self) -> "GraphServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_graphs(args) -> None:
    from repro_torch.api import MAGMSampler, SamplerConfig
    from repro_torch.configs.magm_paper import DEFAULT_MU, THETA_1
    from repro_torch.core import magm

    d = args.graph_d
    config = SamplerConfig(
        params=magm.make_params(THETA_1, DEFAULT_MU, d),
        num_nodes=2**d,
        attribute_key=prng.PRNGKey(args.seed),
        mesh="auto" if args.mesh else None,
        device=args.device,
    )
    t0 = time.perf_counter()
    sampler = MAGMSampler(config, key=prng.PRNGKey(args.seed + 1))
    t_build = time.perf_counter() - t0
    print(
        f"[serve] session up in {t_build:.2f}s: n={sampler.n} B={sampler.plan.B} device={sampler.device} "
        f"mesh={sampler.mesh} world={sampler.world}"
    )

    total = empty = 0
    with GraphServer(
        sampler, max_queue=args.max_queue, deadline_s=args.deadline_s, chunk_edges=args.chunk_edges
    ) as server:
        futures = [server.submit() for _ in range(args.requests)]
        for r, fut in enumerate(futures):
            resp = fut.result()
            if not resp.ok:
                print(f"[serve] request {r}: {resp.status} ({resp.code}) {resp.message}")
                continue
            nedges = int(resp.edges.shape[0])
            total += nedges
            if nedges == 0:
                # a 0-edge draw is a legal sample, not a silent "0 chunks"
                empty += 1
                print(f"[serve] request {r}: EMPTY sample (0 edges), {resp.service_s:.3f}s")
            else:
                print(
                    f"[serve] request {r}: {nedges} edges in {resp.chunks} chunks, {resp.service_s:.3f}s "
                    f"({nedges / max(resp.service_s, 1e-9):.0f} edges/s, waited {resp.wait_s:.3f}s)"
                )
        stats = dict(server.stats)
    if total == 0:
        print(f"[serve] WARNING: all {args.requests} requests were empty")
    print(f"[serve] OK ({total} edges over {args.requests} requests, {empty} empty; stats={stats})")


class LMRun(NamedTuple):
    """What :func:`serve_lm` served: the model, its params and prompts, the
    generated tokens, the prefill's logits and the context."""

    model: Any
    params: Dict[str, Any]
    prompts: torch.Tensor  # (B, S) int32, on the device
    tokens: torch.Tensor  # (B, gen) int32, on the CPU
    logits: torch.Tensor  # (B, S, V) float32 prefill logits, on the device
    context: Optional[torch.Tensor] = None  # serve_context's, on the device


def greedy_generate(model, params, prompts: torch.Tensor, gen: int, context=None):
    """The serve loop: prefill ``prompts`` (B, S) (with the vlm's or audio
    family's ``context``) into a cache of S + gen positions, then
    ``gen - 1`` greedy decode steps.  Returns the (B, gen) int32 tokens (on
    the device; the host is not waited for) and the prefill's logits."""
    from repro_torch.train import steps as steps_lib

    s = prompts.shape[1]
    prefill = steps_lib.make_prefill_step(model, max_len=s + gen)
    decode = steps_lib.make_decode_step(model)
    with torch.inference_mode():
        logits, cache = prefill(params, {"tokens": prompts, "context": context})
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        out = [next_tok]
        for i in range(gen - 1):
            batch = {"cache": cache, "tokens": next_tok[:, None], "cache_len": s + i, "context": context}
            next_tok, _, cache = decode(params, batch)
            out.append(next_tok)
        return torch.stack(out, dim=1), logits


def serve_context(cfg, batch: int, device):
    """The serve CLI's stand-in context: zero image-token embeddings (B,
    num_image_tokens, D) for the vlm, zero frame embeddings (B,
    encoder_seq, D) for audio, bfloat16; None for the other families."""
    from repro_torch.models.model import context_len

    n = context_len(cfg)
    return None if n is None else torch.zeros((batch, n, cfg.d_model), dtype=torch.bfloat16, device=device)


def serve_lm(args) -> LMRun:
    """Prefill ``args.batch`` random prompts of ``args.prompt_len`` tokens,
    then greedy-decode ``args.gen`` tokens each, on ``args.device``."""
    from repro_torch import configs
    from repro_torch.models.model import build as build_model

    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    model = build_model(cfg)
    with torch.inference_mode():
        params = model.init(prng.PRNGKey(args.seed), device=device)
        prompts = prng.randint(prng.PRNGKey(args.seed + 1), (args.batch, args.prompt_len), 0, cfg.vocab_size,
                               device=device)
    context = serve_context(cfg, args.batch, device)
    t0 = time.perf_counter()
    toks, logits = greedy_generate(model, params, prompts, args.gen, context)
    toks = toks.cpu()  # waits for the device
    dt = time.perf_counter() - t0
    print(f"[serve] {cfg.name}: generated {tuple(toks.shape)} in {dt:.2f}s on {device}")
    print("[serve] sample row:", toks[0].tolist())
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite prefill logits")
    print("[serve] OK")
    return LMRun(model, params, prompts, toks, logits, context)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--magm", action="store_true", help="serve MAGM graphs")
    ap.add_argument("--graph-d", type=int, default=12)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--chunk-edges", type=int, default=1 << 14)
    ap.add_argument("--device", default="cuda", help="device of the model or session (default: cuda)")
    ap.add_argument("--mesh", action="store_true", help="graph mode: shard the session over the world's ranks")
    ap.add_argument(
        "--max-queue",
        type=int,
        default=8,
        help="in-flight request bound; submits beyond it are shed with a typed 'overloaded' response",
    )
    ap.add_argument("--deadline-s", type=float, default=None, help="per-request deadline in seconds (default: none)")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.mesh and not args.magm:
        raise ValueError("--mesh shards the graph sampler (--magm); the LM mode runs on one device")
    if args.magm:
        serve_graphs(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
