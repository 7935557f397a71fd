"""The port's engine (repro_torch.core.burst_buffer) against the JAX engine:
the pinned seed digests for every mode and plane, and the scatter, sort and
dtype traps of moving the engine from JAX to PyTorch.  All comparisons are
bitwise: the engine is integer."""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import burst_buffer as jbb
from repro.core.policy import LayoutPolicy as JLayoutPolicy
from repro_torch.core import burst_buffer as bb
from repro_torch.core.layouts import LayoutMode
from repro_torch.core.policy import LayoutPolicy

from test_policy import SEED_DIGESTS

N, Q, W = 8, 5, 8


def t32(x) -> torch.Tensor:
    """numpy → int32 CPU tensor."""
    return torch.as_tensor(np.asarray(x)).to(torch.int32)


def tbool(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, bool))


def digest(*arrays) -> str:
    """The seed tests' digest, over numpy copies of tensors or arrays."""
    h = hashlib.sha256()
    for a in arrays:
        a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:32]


def assert_state_equal(jstate, tstate):
    """A JAX BBState and a port BBState hold the same eight tables."""
    for x, y in zip(jstate.tree_flatten()[0], bb.to_numpy(tstate)):
        np.testing.assert_array_equal(np.asarray(x), y)


def seed_trace(layout, config=bb.DENSE, device="cpu"):
    """``test_policy._seed_trace`` through the port's engine."""
    rng = np.random.RandomState(42)
    state = bb.init_state(N, cap=64, words=W, mcap=64, device=device)
    dev = lambda x: t32(x).to(device)                        # noqa: E731
    ph = dev(rng.randint(1, 1 << 20, (N, Q)))
    cid = dev(rng.randint(0, 4, (N, Q)))
    payload = dev(rng.randint(0, 9999, (N, Q, W)))
    valid = torch.ones((N, Q), dtype=torch.bool, device=device)
    state = bb.forward_write(state, layout, ph, cid, payload, valid,
                             config=config)
    perm = torch.as_tensor(rng.permutation(N), device=device)
    rpay, rfound = bb.forward_read(state, layout, ph[perm], cid[perm], valid,
                                   config=config)
    stat = torch.full((N, Q), bb.OP_STAT, dtype=torch.int32, device=device)
    zeros = torch.zeros((N, Q), dtype=torch.int32, device=device)
    _, fnd, size, loc = bb.meta_op(state, layout, stat, ph, zeros, zeros - 1,
                                   valid, config=config)
    return {"state": digest(*bb.to_numpy(state)),
            "read": digest(rpay, rfound), "meta": digest(fnd, size, loc)}


@pytest.mark.parametrize("kind", ["dense", "compacted"])
@pytest.mark.parametrize("mode", list(LayoutMode))
def test_engine_reproduces_seed_digests(mode, kind):
    """forward_write / forward_read / meta_op hit the pinned bits of the
    seed engine, on the dense plane and on the uniform compacted plane."""
    cfg = bb.DENSE if kind == "dense" else bb.COMPACTED
    assert seed_trace(LayoutPolicy.uniform(mode, N), cfg) == \
        SEED_DIGESTS[int(mode)]


def test_state_round_trips_through_jax_tables():
    jstate = jbb.init_state(4, 16, 4, 8)
    arrays = [np.asarray(a) for a in jstate.tree_flatten()[0]]
    st = bb.from_jax_state(arrays, device="cpu")
    assert st.data.dtype == torch.int32 and st.data.shape == (4, 16, 4)
    for a, b in zip(arrays, bb.to_numpy(st)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        bb.from_jax_state(arrays[:7], device="cpu")


def _meta_batch(seed, n=4, m=12, mcap=8):
    """A metadata batch full of repeated keys across every op code."""
    rng = np.random.RandomState(seed)
    keys = rng.randint(1, 6, (n, m))
    op = rng.randint(0, 4, (n, m))
    size = rng.randint(0, 50, (n, m))
    loc = rng.randint(-1, 4, (n, m))
    valid = rng.rand(n, m) > 0.15
    return keys, op, size, loc, valid


@pytest.mark.parametrize("seed", range(6))
def test_meta_apply_duplicate_keys_match_jax(seed):
    """Repeated keys in one batch: UPDATE's scatter resolves to the last
    update of a slot (JAX's CPU order), CREATE/UPDATE allocation and the
    capacity drop (a table of 8 slots overflows) match bit for bit — run
    twice so the second batch meets an occupied, partly removed table."""
    n, mcap = 4, 8
    js = jbb.init_state(n, 4, 2, mcap)
    ts = bb.init_state(n, 4, 2, mcap, device="cpu")
    for step in range(2):
        keys, op, size, loc, valid = _meta_batch(seed * 10 + step)
        js, jf, jsz, jl = jbb._meta_apply(
            js, jnp.asarray(op, jnp.int32), jnp.asarray(keys, jnp.int32),
            jnp.asarray(size, jnp.int32), jnp.asarray(loc, jnp.int32),
            jnp.asarray(valid))
        ts, tf, tsz, tl = bb._meta_apply(ts, t32(op), t32(keys), t32(size),
                                         t32(loc), tbool(valid))
        assert_state_equal(js, ts)
        for a, b in ((jf, tf), (jsz, tsz), (jl, tl)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("seed", range(4))
def test_meta_write_apply_duplicate_keys_match_jax(seed):
    """The fused write's metadata apply: several chunks of one file in a
    batch (duplicate-key UPDATEs) end in JAX's last-wins tables."""
    n, mcap = 4, 8
    rng = np.random.RandomState(100 + seed)
    js = jbb.init_state(n, 4, 2, mcap)
    ts = bb.init_state(n, 4, 2, mcap, device="cpu")
    for _ in range(2):
        keys = rng.randint(1, 5, (n, 10))
        size = rng.randint(1, 30, (n, 10))
        loc = rng.randint(-1, 4, (n, 10))
        create = rng.rand(n, 10) > 0.6
        valid = rng.rand(n, 10) > 0.1
        js = jbb._meta_write_apply(
            js, jnp.asarray(keys, jnp.int32), jnp.asarray(size, jnp.int32),
            jnp.asarray(loc, jnp.int32), jnp.asarray(valid),
            jnp.asarray(create))
        ts = bb._meta_write_apply(ts, t32(keys), t32(size), t32(loc),
                                  tbool(valid), tbool(create))
        assert_state_equal(js, ts)


def test_append_chunks_drops_past_capacity_like_jax():
    """Out-of-range scatter: chunks beyond ``cap`` are masked out and
    counted in ``dropped`` (JAX drops the index-``cap`` update)."""
    n, cap, w = 3, 4, 2
    rng = np.random.RandomState(1)
    js = jbb.init_state(n, cap, w, 4)
    ts = bb.init_state(n, cap, w, 4, device="cpu")
    for _ in range(2):
        keys = rng.randint(0, 9, (n, 5, 2))
        data = rng.randint(0, 99, (n, 5, w))
        valid = rng.rand(n, 5) > 0.3
        js = jbb._append_chunks(js, jnp.asarray(keys, jnp.int32),
                                jnp.asarray(data, jnp.int32),
                                jnp.asarray(valid))
        ts = bb._append_chunks(ts, t32(keys), t32(data), tbool(valid))
        assert_state_equal(js, ts)
    assert int(ts.dropped.sum()) > 0


def test_lookup_returns_newest_version_like_jax():
    """Duplicate chunk versions: the newest appended copy answers, on the
    routed lookup and on the stranded-data broadcast alike."""
    n, cap, w = 3, 8, 2
    rng = np.random.RandomState(2)
    keys = rng.randint(0, 3, (n, 6, 2))
    data = rng.randint(0, 99, (n, 6, w))
    valid = np.ones((n, 6), bool)
    js = jbb._append_chunks(jbb.init_state(n, cap, w, 4),
                            jnp.asarray(keys, jnp.int32),
                            jnp.asarray(data, jnp.int32), jnp.asarray(valid))
    ts = bb._append_chunks(bb.init_state(n, cap, w, 4, device="cpu"),
                           t32(keys), t32(data), tbool(valid))
    probe = rng.randint(0, 3, (n, 4, 2))
    pvalid = rng.rand(n, 4) > 0.2
    jp, jf = jbb._lookup_chunks(js, jnp.asarray(probe, jnp.int32),
                                jnp.asarray(pvalid))
    tp, tf = bb._lookup_chunks(ts, t32(probe), tbool(pvalid))
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    jp, jf = jbb._broadcast_lookup(js, jnp.asarray(probe, jnp.int32),
                                   jnp.asarray(pvalid), jbb.stacked_exchange,
                                   n)
    tp, tf = bb._broadcast_lookup(ts, t32(probe), tbool(pvalid), n)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())


def test_alloc_meta_slots_reuses_freed_slots_like_jax():
    """Stable argsort of the free list: allocation order after removals
    equals JAX's."""
    mk = np.array([[5, -1, 7, -1, -1, 9], [-1, -1, -1, -1, -1, -1],
                   [1, 2, 3, 4, 5, 6]], np.int32)
    new = np.array([[1, 1, 0, 1, 1], [0, 1, 1, 0, 1], [1, 0, 0, 0, 1]], bool)
    js, jf = jbb._alloc_meta_slots(jnp.asarray(mk), jnp.asarray(new))
    ts, tf = bb._alloc_meta_slots(t32(mk), tbool(new))
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    assert ts.dtype == torch.int32


@pytest.mark.parametrize("mode", list(LayoutMode))
def test_engine_keeps_int32_tables(mode):
    """Every table stays int32 after a write and a metadata round (torch
    sums and cumsums would otherwise promote to int64 and change the
    digests)."""
    st = bb.init_state(N, 16, 4, 16, device="cpu")
    rng = np.random.RandomState(3)
    ph, cid = t32(rng.randint(1, 999, (N, 3))), t32(rng.randint(0, 2, (N, 3)))
    st = bb.forward_write(st, LayoutPolicy.uniform(mode, N), ph, cid,
                          t32(rng.randint(0, 9, (N, 3, 4))),
                          torch.ones((N, 3), dtype=torch.bool))
    for a in bb.to_numpy(st):
        assert a.dtype == np.int32


def test_init_state_requires_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bb.init_state(2, 4, 4, 4)
    assert bb.init_state(2, 4, 4, 4, device="cpu").data.device.type == "cpu"


def test_jax_policy_and_port_policy_agree_on_engine_inputs():
    """The hetero policy resolves to the same per-request modes in both."""
    scopes = {"/bb/ckpt": 4, "/bb/shared": 3}
    jp = JLayoutPolicy.from_scopes(scopes, n_nodes=N, default=2)
    tp = LayoutPolicy.from_scopes(scopes, n_nodes=N, default=2)
    assert jp.table == tp.table
    assert {int(m) for m in jp.modes_present()} == \
        {int(m) for m in tp.modes_present()}
    sh = np.asarray([jp.scope_hash_of(p) for p in
                     ("/bb/ckpt/a", "/bb/shared/b", "/x", "/bb/ckptX")],
                    np.int32)
    np.testing.assert_array_equal(np.asarray(jp.resolve(sh)),
                                  tp.resolve(t32(sh)).numpy())
