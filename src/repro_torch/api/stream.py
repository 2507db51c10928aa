"""Resumable streaming: StreamCheckpoint persistence for ``sample_stream``.

A 20B-edge stream interrupted at chunk k must not restart from edge zero.
The contract here is *recompute-but-don't-redeliver*: sampling is cheap and
deterministic (per-graph ``fold_in`` keys, fixed round sizes), so a resumed
stream re-runs the engine from the same key and SKIPS the chunks already
delivered — verifying, chunk by chunk, that the replay's running digest
matches the one persisted at the kill point — then yields the remainder.
The concatenation [delivered before the fault ‖ resumed chunks] is
bit-identical to an uninterrupted run (pinned by test).

The checkpoint is a tiny tree of numpy arrays (so the atomic
``repro_torch.dist.checkpoint`` machinery persists it unchanged).  Its
files are byte for byte the reference's (``repro.api.stream``), so a
stream checkpointed by either package resumes in the other:

- ``config_digest``  (20,) uint8 — sha1 over the sampler's stream-relevant
  config (attributes/thetas bytes, backend, rounds, dtype, chunk size).
  The mesh and the port's ``device`` are excluded: a stream checkpointed
  on the card resumes on the CPU bit-identically, and the other way round.
- ``key_data`` / ``key_typed`` — the stream's PRNG key as two uint32
  words; the port's keys are raw (``typed = 0``), like
  ``jax.random.PRNGKey``'s.
- ``chunk_edges``, ``num_edges`` — stream shape parameters (-1 = None).
- ``chunks_emitted`` / ``edges_emitted`` — the cursor: chunks fully
  DELIVERED to the consumer (checkpoint N is written only after chunk N-1's
  ``yield`` returns, so a fault between chunks loses nothing).
- ``round_slots`` — engine round counter (slots/graph) for observability.
- ``stream_digest`` (20,) uint8 — running sha1 over the delivered chunks'
  bytes (the seen-buffer digest the resume replay is verified against).
- ``done`` — terminal marker; resuming a finished stream yields nothing.

Checkpoint ``step`` numbers equal ``chunks_emitted``; the newest two are
kept (``prune(keep=2)``), so a crash INSIDE a save still leaves the
previous cursor restorable (atomicity pinned in
tests/test_torch_checkpoint.py).
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.dist import checkpoint as _ckpt

DIGEST_BYTES = 20
_KEEP = 2


def digest_parts(parts) -> np.ndarray:
    """sha1 over a canonical encoding of config parts -> (20,) uint8.

    Arrays contribute shape+dtype+bytes; everything else its ``repr``.
    """
    h = hashlib.sha1()
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(repr((p.shape, str(p.dtype))).encode())
            h.update(np.ascontiguousarray(p).tobytes())
        else:
            h.update(repr(p).encode())
        h.update(b"\x00")
    return np.frombuffer(h.digest(), dtype=np.uint8).copy()


def key_to_data(key):
    """Canonicalize a raw key (a (2,) int64 tensor of uint32 words) ->
    ((2,) uint32 data array, typed flag 0), as the reference stores a
    ``jax.random.PRNGKey``."""
    words = torch.as_tensor(key).cpu().numpy()
    return words.astype(np.uint32).reshape(2), 0


def key_from_data(data: np.ndarray, typed: int) -> torch.Tensor:
    """The raw key of stored words.  A typed key (``typed = 1``, written by
    the reference for a ``jax.random.key``) holds the same two words of the
    default threefry implementation, so it reads the same way."""
    words = np.asarray(data, dtype=np.uint32).reshape(2)
    return torch.from_numpy(words.astype(np.int64))


def initial_state(
    config_digest: np.ndarray,
    key,
    chunk_edges: int,
    num_edges: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """The step-0 StreamCheckpoint tree (nothing delivered yet)."""
    data, typed = key_to_data(key)
    i64 = lambda v: np.asarray(int(v), dtype=np.int64)  # noqa: E731
    return {
        "chunk_edges": i64(chunk_edges),
        "chunks_emitted": i64(0),
        "config_digest": np.asarray(config_digest, dtype=np.uint8),
        "done": i64(0),
        "edges_emitted": i64(0),
        "key_data": data,
        "key_typed": i64(typed),
        "num_edges": i64(-1 if num_edges is None else num_edges),
        "round_slots": i64(0),
        "stream_digest": np.zeros(DIGEST_BYTES, dtype=np.uint8),
    }


def load_state(
    directory: str, step: int, key_template
) -> Dict[str, np.ndarray]:
    """Restore the StreamCheckpoint at ``step`` as host numpy arrays.

    ``key_template`` fixes the expected key-data shape (any raw key); a
    checkpoint written under a different key implementation fails the
    shape check instead of silently misreading.
    """
    data, _ = key_to_data(key_template)
    target = initial_state(
        np.zeros(DIGEST_BYTES, dtype=np.uint8), key_template, 0
    )
    target["key_data"] = np.zeros_like(data)
    tree, _ = _ckpt.restore(directory, step, target)
    return {
        k: np.asarray(tree[k], dtype=v.dtype).reshape(v.shape)
        for k, v in target.items()
    }


def _save(directory: str, state: Dict[str, np.ndarray]) -> None:
    _ckpt.save(directory, int(state["chunks_emitted"]), state)  # lint: disable=host-sync-in-step -- not a step: a host state dict, reached by the name _save
    _ckpt.prune(directory, keep=_KEEP)


def emit(
    raw: Iterator[np.ndarray],
    directory: str,
    state: Dict[str, np.ndarray],
    *,
    slots: Optional[Callable[[], int]] = None,
) -> Iterator[np.ndarray]:
    """Yield ``raw``'s chunks with a StreamCheckpoint after each delivery.

    When ``state`` carries a nonzero cursor (resume), the first
    ``chunks_emitted`` chunks of the replayed stream are consumed silently
    while their running sha1 is checked against the persisted
    ``stream_digest`` — a divergent replay (changed code, wrong config)
    raises instead of emitting edges that don't splice.  ``slots`` reports
    the engine's round counter into the checkpoint once known.
    """
    skip = int(state["chunks_emitted"])
    h = hashlib.sha1()
    k = 0
    edges = 0
    if skip == 0:
        _save(directory, state)  # resumable from before the first chunk
    for chunk in raw:
        h.update(np.ascontiguousarray(chunk).tobytes())
        k += 1
        edges += int(chunk.shape[0])
        if k <= skip:
            if k == skip:
                got = np.frombuffer(h.digest(), dtype=np.uint8)
                if not np.array_equal(got, state["stream_digest"]):
                    raise RuntimeError(
                        f"resume replay diverged: digest of the first "
                        f"{skip} chunk(s) does not match the checkpoint "
                        f"in {directory} (different code or config?)"
                    )
                if edges != int(state["edges_emitted"]):
                    raise RuntimeError(
                        f"resume replay diverged: {edges} edges replayed "
                        f"vs {int(state['edges_emitted'])} checkpointed"
                    )
            continue
        yield chunk
        state = dict(
            state,
            chunks_emitted=np.asarray(k, dtype=np.int64),
            edges_emitted=np.asarray(edges, dtype=np.int64),
            round_slots=np.asarray(
                0 if slots is None else int(slots()), dtype=np.int64
            ),
            stream_digest=np.frombuffer(h.digest(), dtype=np.uint8).copy(),
        )
        _save(directory, state)
    if k < skip:
        raise RuntimeError(
            f"resume replay diverged: stream ended after {k} chunk(s) but "
            f"the checkpoint in {directory} recorded {skip} delivered"
        )
    _save(directory, dict(state, done=np.asarray(1, dtype=np.int64)))
