"""Port vs reference: the threefry key stream, the counter-hash family and
the acceptance hash, bit for bit."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_reference import ref  # noqa: F401  (fixture)

from repro_torch.core import prng, quilt
from repro_torch.kernels import quadrant_descent as qd

U32 = 0xFFFFFFFF


def _np64(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint32).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -7, 2**40 + 3])
def test_threefry_matches_jax(seed):
    import jax
    import jax.numpy as jnp

    if not -(2**31) <= seed < 2**31:
        with jax.enable_x64(True):
            k = jax.random.PRNGKey(seed)
    else:
        k = jax.random.PRNGKey(seed)
    pk = prng.PRNGKey(seed)
    assert np.array_equal(_np64(k), pk.numpy())
    assert np.array_equal(_np64(jax.random.split(k, 5)), prng.split(pk, 5).numpy())
    for data in (0, 0x5EED, U32):
        assert np.array_equal(
            _np64(jax.random.fold_in(k, data)), prng.fold_in(pk, data).numpy()
        )
    assert np.array_equal(
        _np64(jax.random.bits(k, (37, 3), jnp.uint32)), prng.bits(pk, (37, 3)).numpy()
    )
    with jax.enable_x64(True):
        b64 = np.asarray(jax.random.bits(k, (9,), jnp.uint64)).view(np.int64)
    assert np.array_equal(b64, prng.bits(pk, (9,), "uint64").numpy())
    u = np.asarray(jax.random.uniform(k, (211, 13)))
    assert np.array_equal(u, prng.uniform(pk, (211, 13)).numpy())


def test_key_stream_of_the_main_path():
    """The session's stream, the two round splits and the salt's fold."""
    import jax
    import jax.numpy as jnp

    k, pk = jax.random.PRNGKey(3), prng.PRNGKey(3)
    for _ in range(3):
        k, sub = jax.random.split(k)
        pk, psub = prng.split(pk)
        assert np.array_equal(_np64(sub), psub.numpy())
    k2, _ = jax.random.split(sub)
    _, rk = jax.random.split(k2)
    pk2, _ = prng.split(psub)
    _, prk = prng.split(pk2)
    assert np.array_equal(_np64(rk), prk.numpy())
    with jax.enable_x64(True):
        salt = jax.random.bits(jax.random.fold_in(rk, 0x5EED), (), jnp.uint64)
        salt = np.asarray(salt).view(np.int64)
    assert int(salt) == int(quilt.accept_salt(prk, "cpu"))


def _counters(n=100_000, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 2**32, size=2, dtype=np.uint64).astype(np.uint32)
    gid = rng.integers(0, 2**31 - 1, size=n, dtype=np.int64).astype(np.int32)
    word = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    return s, gid, word


def test_counter_family_matches_reference(ref):
    import jax.numpy as jnp

    s, gid, word = _counters()
    js0, js1 = jnp.uint32(s[0]), jnp.uint32(s[1])
    jg, jw = jnp.asarray(gid), jnp.asarray(word)
    ps0, ps1 = int(s[0]), int(s[1])
    pg, pw = torch.from_numpy(gid.copy()), torch.from_numpy(word.astype(np.int64))
    assert np.array_equal(
        _np64(ref.qd.counter_hash(js0, js1, jg, jw)), qd.counter_hash(ps0, ps1, pg, pw).numpy()
    )
    assert np.array_equal(
        np.asarray(ref.qd.counter_u01(js0, js1, jg, jw)),
        qd.counter_u01(ps0, ps1, pg, pw).numpy(),
    )
    for nb in (1, 7, 1000, 2**20 + 7):
        assert np.array_equal(
            np.asarray(ref.qd.counter_rank(js0, js1, jg, jw, nb)),
            qd.counter_rank(ps0, ps1, pg, pw, nb).numpy(),
        )
    x = jnp.asarray(word)
    assert np.array_equal(_np64(ref.qd._mix32(x)), qd._mix32(pw).numpy())


def test_descent_uniforms_rank_pair_and_seed(ref):
    import jax
    import jax.numpy as jnp

    s, gid, _ = _counters(4000, seed=1)
    slot = np.random.default_rng(2).integers(0, 2**25, 4000).astype(np.int32)
    d = 15
    ju = ref.qd.descent_uniforms(jnp.uint32(s[0]), jnp.uint32(s[1]), jnp.asarray(gid), jnp.asarray(slot), d)
    pu = qd.descent_uniforms(int(s[0]), int(s[1]), torch.from_numpy(gid.copy()), torch.from_numpy(slot.copy()), d)
    assert np.array_equal(np.asarray(ju), pu.numpy())
    jkb, jlb = ref.qd.rank_pair(jnp.uint32(s[0]), jnp.uint32(s[1]), jnp.asarray(gid), jnp.asarray(slot), 37)
    pkb, plb = qd.rank_pair(int(s[0]), int(s[1]), torch.from_numpy(gid.copy()), torch.from_numpy(slot.copy()), 37)
    assert np.array_equal(np.asarray(jkb), pkb.numpy())
    assert np.array_equal(np.asarray(jlb), plb.numpy())
    key = jax.random.fold_in(jax.random.PRNGKey(11), 5)
    jseed = np.asarray(ref.qd.counter_seed(key)).astype(np.uint32).reshape(-1)
    assert qd.counter_seed(torch.from_numpy(_np64(key))) == (int(jseed[0]), int(jseed[1]))


def test_accept_hash_matches_reference(ref):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    n = 100_000
    gid = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    cell = rng.integers(0, 2**62, n, dtype=np.int64)
    salt = rng.integers(-(2**63), 2**63 - 1, dtype=np.int64)
    with jax.enable_x64(True):
        ju = ref.quilt._accept_u01(
            jnp.asarray(np.uint64(salt.astype(np.uint64))), jnp.asarray(gid), jnp.asarray(cell)
        )
        ju = np.asarray(ju)
    pu = quilt._accept_u01(torch.tensor(int(salt)), torch.from_numpy(gid.copy()), torch.from_numpy(cell.copy()))
    assert ju.dtype == np.float32
    assert np.array_equal(ju, pu.numpy())
